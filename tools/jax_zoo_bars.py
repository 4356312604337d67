"""The JAX package's numbers for phase 38 of ``chip_smoke.py --only zoo``
(its ``ZOO_BARS``), on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_zoo_bars.py [LABEL ...]

For each family of ``chip_smoke.ZOO`` (default: all): the JAX model that
``rdst_tpu.models.build_generator`` makes from ``chip_smoke.CONFIG`` with
the family's overrides, its parameter tree traced (``jax.eval_shape``),
the same seeded arrays the port takes (``chip_smoke.zoo_weights``, drawn
leaf by leaf in sorted flax-path order), and its float32 forward on XLA
(``RDST_TPU_PALLAS=0``) of the same 8 seeded slices
(``chip_smoke.zoo_input``) at the family's scale. Prints the output's
statistics (``chip_smoke.zoo_stats``) as the Python literal
``chip_smoke.py`` holds as ``ZOO_BARS``. Run it from the repo root.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def family_bars(label: str) -> dict:
    import jax
    import numpy as np

    import chip_smoke as cs
    from rdst_tpu.config import ParametersLoader
    from rdst_tpu.models import build_generator

    overrides, hw, scale = cs.ZOO[label]
    p = ParametersLoader(cs.CONFIG)
    for k, v in overrides.items():
        p.set(k, v)
    model = build_generator(p)
    x = cs.zoo_input(hw)
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                             scale))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shapes = {tuple(k.key for k in path): leaf.shape
              for path, leaf in leaves}
    params = {"params": cs._nest(cs.zoo_weights(shapes))}
    y = jax.jit(lambda v, x: model.apply(v, x, scale))(params, x)
    return cs.zoo_stats(np.asarray(y))


def main(argv=None) -> int:
    os.environ["RDST_TPU_PALLAS"] = "0"
    import chip_smoke as cs

    labels = list(argv if argv is not None else sys.argv[1:]) or list(cs.ZOO)
    print("ZOO_BARS = {")
    for label in labels:
        bars = family_bars(label)
        body = ", ".join(f"{v:.9g}" for v in bars["pixels"])
        print(f"    {label!r}: {{\n        \"shape\": {bars['shape']}, "
              f"\"sum\": {bars['sum']:.10g},\n        \"sumsq\": "
              f"{bars['sumsq']:.10g}, \"absmax\": {bars['absmax']:.9g},\n"
              f"        \"pixels\": [{body}]}},", flush=True)
    print("}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
