"""INI config system (the port's own copy of ``rdst_tpu/config.py``).

Same semantics as the JAX package's loader, kept here so the port imports
nothing of ``rdst_tpu``:

* every value in the INI file is a Python expression;
* the DEFAULT section propagates into every section (configparser);
* the first-seen key wins across sections;
* the loader exposes a flat attribute bag (``paras.batch_size`` etc.).

Values are parsed with ``ast.literal_eval`` first; only if that fails do
we fall back to ``eval`` with a restricted namespace.
"""

from __future__ import annotations

import ast
import configparser
from typing import Any, Dict, Iterator, Tuple

_EVAL_NAMESPACE: Dict[str, Any] = {
    "__builtins__": {},
    "None": None,
    "True": True,
    "False": False,
    "range": range,
    "float": float,
    "int": int,
    "str": str,
    "list": list,
    "tuple": tuple,
    "dict": dict,
    "inf": float("inf"),
}


def parse_value(raw: str) -> Any:
    """Parse one INI value exactly as the reference's ``eval()`` would."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return eval(raw, dict(_EVAL_NAMESPACE))  # noqa: S307 - restricted ns


class ParametersLoader:
    """Flat attribute bag built from an INI file.

    Mirrors the reference ParametersLoader: iterate sections in file
    order, ``eval`` each value, first key occurrence wins, DEFAULT keys
    appear in every section (so they effectively always win for keys
    they define). ``__str__`` pretty-prints all parameters.
    """

    def __init__(self, config_file: str | None = None):
        self.names: list[str] = []
        if config_file is not None:
            self.load(config_file)

    def load(self, config_file: str) -> "ParametersLoader":
        config = configparser.ConfigParser()
        read = config.read(config_file)
        if not read:
            raise FileNotFoundError(f"Config file not found: {config_file}")
        # config.keys() yields DEFAULT first, then sections in file order,
        # matching the reference's iteration (param_loader.py:16).
        for section in config.keys():
            for key in config[section].keys():
                if key in self.names:
                    continue
                self.names.append(key)
                setattr(self, key, parse_value(config.get(section, key)))
        return self

    # -- conveniences beyond the reference ---------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def set(self, key: str, value: Any) -> None:
        if key not in self.names:
            self.names.append(key)
        setattr(self, key, value)

    def items(self) -> Iterator[Tuple[str, Any]]:
        for k in self.names:
            yield k, getattr(self, k)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.items())

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParametersLoader":
        self = cls()
        for k, v in d.items():
            self.set(k, v)
        return self

    def apply_overrides(self, overrides) -> None:
        """Apply CLI ``key=value`` overrides (values parsed exactly like
        .ini values), e.g. ``mesh_shape=[2,2,2]`` ``batch_size=16``."""
        for ov in overrides or ():
            key, sep, raw = str(ov).partition("=")
            if not sep or not key:
                raise ValueError(
                    f"override {ov!r} is not KEY=VALUE (e.g. mesh_shape=[2,2,2])")
            self.set(key.strip(), parse_value(raw.strip()))

    def __contains__(self, key: str) -> bool:
        return key in self.names

    def __str__(self) -> str:
        plog = "Parameters: \n"
        for k in self.names:
            plog += "  {}: \t {} \n".format(k, getattr(self, k))
        return plog
