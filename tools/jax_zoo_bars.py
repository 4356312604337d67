"""The JAX package's numbers for phase 38 of ``chip_smoke.py --only zoo``
(its ``ZOO_BARS``), phase 42 of ``--only convzoo`` (its
``CONV_ZOO_BARS``) and phases 47-48 of ``--only ckpt`` (its
``SIR_BARS``), on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_zoo_bars.py [--conv | --swinir]
        [LABEL ...]

For each family of ``chip_smoke.ZOO`` (default: all; ``--conv``: of
``chip_smoke.CONV_ZOO``; ``--swinir``: the SwinIR heads of
``chip_smoke.SIR``, on ``SWINIR_CONFIG``, their forward one slice at a
time): the JAX model that
``rdst_tpu.models.build_generator`` makes from the family's config with
its overrides, its parameter tree traced (``jax.eval_shape``; a CONV_ZOO
family's init calls every scale of ``all_sr_scales``, as the JAX
trainer's init does, so that MDSR's, Meta_MDSR's and IPT's per-scale
branches exist), the same seeded arrays the port takes
(``chip_smoke.zoo_weights``, drawn leaf by leaf in sorted flax-path
order), and its forward on XLA (``RDST_TPU_PALLAS=0``) of the same 8
seeded slices (``chip_smoke.zoo_input``) at each of the family's scales:
float32, or float64 (``jax.enable_x64``) for ``CONV_ZOO_F64``. Prints the
output's statistics (``chip_smoke.zoo_stats``) as the Python literal
``chip_smoke.py`` holds as ``ZOO_BARS`` / ``CONV_ZOO_BARS`` (keyed
``'label @scale'`` there). Run it from the repo root.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _bars(model, x, init_scales, scales, dtype, per_slice=False) -> dict:
    """{scale: zoo_stats} of ``model`` at each scale, from the seeded
    weights of the tree an init over ``init_scales`` makes; with
    ``per_slice`` the forward runs one slice at a time (the same numbers
    in less memory)."""
    import jax
    import numpy as np

    import chip_smoke as cs

    def init_all(mdl, x):
        out = None
        for s in init_scales:
            out = mdl(x, s)
        return out

    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                             method=init_all))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shapes = {tuple(k.key for k in path): leaf.shape
              for path, leaf in leaves}
    params = {"params": cs._nest({k: v.astype(dtype) for k, v in
                                  cs.zoo_weights(shapes).items()})}
    out = {}
    for s in scales:
        fwd = jax.jit(lambda v, x: model.apply(v, x, s))
        y = (np.concatenate([np.asarray(fwd(params, x[i:i + 1]))
                             for i in range(len(x))]) if per_slice
             else np.asarray(fwd(params, x)))
        out[s] = cs.zoo_stats(y)
    return out


def family_bars(label: str) -> dict:
    """A ZOO family's bars, at its one scale."""
    import numpy as np

    import chip_smoke as cs
    from rdst_tpu.config import ParametersLoader
    from rdst_tpu.models import build_generator

    overrides, hw, scale = cs.ZOO[label]
    p = ParametersLoader(cs.CONFIG)
    for k, v in overrides.items():
        p.set(k, v)
    return _bars(build_generator(p), cs.zoo_input(hw), [scale], [scale],
                 np.float32)[scale]


def conv_family_bars(label: str) -> dict:
    """A CONV_ZOO family's bars, {scale: stats}."""
    import contextlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke as cs
    from rdst_tpu.config import ParametersLoader
    from rdst_tpu.models import build_generator

    overrides, config, hw, scales = cs.CONV_ZOO[label]
    f64 = label in cs.CONV_ZOO_F64
    with jax.enable_x64(True) if f64 else contextlib.nullcontext():
        dtype = np.float64 if f64 else np.float32
        p = ParametersLoader(config)
        for k, v in overrides.items():
            p.set(k, v)
        model = build_generator(p, dtype=jnp.float64 if f64 else jnp.float32)
        x = cs.zoo_input(hw).astype(dtype)
        return _bars(model, x, [float(s) for s in p.all_sr_scales], scales,
                     dtype)


def swinir_bars(label: str) -> dict:
    """A SIR variant's bars, at x4 (the denoise head's output at its
    input's size)."""
    import numpy as np

    import chip_smoke as cs
    from rdst_tpu.config import ParametersLoader
    from rdst_tpu.models import build_generator

    overrides, hw = cs.SIR[label]
    p = ParametersLoader(cs.SWINIR_CONFIG)
    for k, v in overrides.items():
        p.set(k, v)
    return _bars(build_generator(p), cs.zoo_input(hw), [cs.SCALE],
                 [cs.SCALE], np.float32, per_slice=True)[cs.SCALE]


def _print(key: str, bars: dict) -> None:
    body = ", ".join(f"{v:.9g}" for v in bars["pixels"])
    print(f"    {key!r}: {{\n        \"shape\": {bars['shape']}, "
          f"\"sum\": {bars['sum']:.10g},\n        \"sumsq\": "
          f"{bars['sumsq']:.10g}, \"absmax\": {bars['absmax']:.9g},\n"
          f"        \"pixels\": [{body}]}},", flush=True)


def main(argv=None) -> int:
    os.environ["RDST_TPU_PALLAS"] = "0"
    import chip_smoke as cs

    args = list(argv if argv is not None else sys.argv[1:])
    conv, sir = "--conv" in args, "--swinir" in args
    labels = [a for a in args if a not in ("--conv", "--swinir")] or list(
        cs.CONV_ZOO if conv else cs.SIR if sir else cs.ZOO)
    print(("CONV_ZOO_BARS" if conv else "SIR_BARS" if sir else "ZOO_BARS")
          + " = {")
    for label in labels:
        if sir:
            _print(label, swinir_bars(label))
        elif conv:
            for s, bars in conv_family_bars(label).items():
                _print(f"{label} @{s:g}", bars)
        else:
            _print(label, family_bars(label))
    print("}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
