"""Serving models and bundles (counterpart of
``rdst_tpu/serving/export.py``).

:class:`LiveModel` builds the generator and its trained weights from a
config, as the tester does, and answers ``predict(x, scale)`` with the
batch padded to a bucket of a sparse ladder (default 1, 8, 64), so a
server sees a few fixed batch shapes. The model is called at the
requested scale (read by scale-free models: MetaSR, a scale-free RDST;
the manifest lists the scales served, fractional ones included).
Normalization (MeanShift) is part of the model.
``inference_dtype = 'bfloat16'`` serves the bf16 model (float32 parameter
masters; inputs and outputs stay float32 numpy) on the fast kernels of its
kernel mode, with int8 qkv operands where ``pallas_quant='qkv'`` asks for
them (modes rdstb, pair and swin). A config with ``residual_scale > 0``
gets MetaSR's bicubic blend after the buckets, as the JAX package applies
it.

On the config's data axis (``mesh_shape``, :mod:`rdst_tpu_torch.
parallel`; every visible GPU by default) the live model holds one replica
on each device: each bucket is rounded up to a multiple of the axis (the
JAX ``min_bucket``), split into equal shards that run on their devices,
and the outputs are gathered on the host. The manifest's ``mesh`` entry is
the JAX one (``{"data": N}``).

A serving bundle is a directory that needs neither the ``.ini`` nor the
weights nor the training volumes:

.. code-block:: text

    bundle/
      MANIFEST.json    the JAX manifest's keys (model identity, scales,
                       dtype, kernel mode, entries of {scale, lr_hw}),
                       plus runtime "torch", executable "cuda_graph",
                       routes, int8 groups, the normalization and the
                       config (its weight, data and output paths dropped)
      params.msgpack   the parameters in the flax layout (the JAX
                       bundle's tree)

:func:`export_bundle` (``python -m rdst_tpu_torch.serving.export``) writes
one; :class:`ServingBundle` serves it on one device with one CUDA graph
for each (entry, bucket), where the JAX bundle holds one StableHLO
executable an entry, compiled a bucket. A bundle of the JAX package is
refused: the port cannot run StableHLO.
"""

from __future__ import annotations

import json
import os
import threading
from os.path import join
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS = "1,8,64"
ENV_BUCKETS = "RDST_TORCH_SERVE_BUCKETS"
_FORMAT = 1
RUNTIME = "torch"


def _canon_input(x) -> np.ndarray:
    """Accept (H,W) / (N,H,W) / (N,H,W,C); return f32 NHWC."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[None, :, :, None]
    elif x.ndim == 3:
        x = x[..., None]
    if x.ndim != 4:
        raise ValueError(f"expected (H,W)/(N,H,W)/(N,H,W,C), got {x.shape}")
    return x


def resolve_buckets(max_batch: int, spec=None) -> Tuple[int, ...]:
    """Bucket ladder capped at (and always including) ``max_batch``.
    ``spec``: comma list ('1,8,64'), 'pow2' for the dense ladder, or
    None for the ``RDST_TORCH_SERVE_BUCKETS`` env / DEFAULT_BUCKETS."""
    max_batch = max(1, int(max_batch))
    spec = spec or os.environ.get(ENV_BUCKETS) or DEFAULT_BUCKETS
    if str(spec).strip().lower() == "pow2":
        out, b = set(), 1
        while b < max_batch:
            out.add(b)
            b *= 2
        out.add(max_batch)
        return tuple(sorted(out))
    vals = {int(v) for v in str(spec).split(",") if str(v).strip()}
    vals = {v for v in vals if 1 <= v <= max_batch}
    vals.add(max_batch)
    return tuple(sorted(vals))


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n, else the top bucket (oversized requests
    split into top-bucket chunks)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def _bucketed_predict(fn: Callable[[np.ndarray], np.ndarray], x: np.ndarray,
                      buckets: Tuple[int, ...],
                      min_bucket: int = 1) -> np.ndarray:
    """Pad each chunk to its bucket (repeating the last slice), run, and
    slice the padding off. The bucket is rounded up to a multiple of
    ``min_bucket`` (the data axis), so that it splits into equal shards."""
    n = x.shape[0]
    b = -(-_bucket(n, buckets) // min_bucket) * min_bucket
    out_chunks = []
    for i in range(0, n, b):
        blk = x[i:i + b]
        pad = b - blk.shape[0]
        if pad:
            blk = np.concatenate([blk, np.repeat(blk[-1:], pad, 0)])
        y = fn(blk)
        out_chunks.append(y[:b - pad] if pad else y)
    return np.concatenate(out_chunks, 0)


def residual_blend(out: np.ndarray, x: np.ndarray,
                   residual_scale: float) -> np.ndarray:
    """MetaSR's eval-time blend (meta_sr_trainer.py:171-172):
    ``out * (1 - r) + bicubic(x) * r``, each LR slice of ``x`` resized to
    the HR size of ``out``."""
    from rdst_tpu_torch.data import ops

    res = np.stack([
        np.asarray(ops.resize(xi, out.shape[1:3])).reshape(out.shape[1:])
        for xi in x])
    return out * (1.0 - residual_scale) + res * residual_scale


def _check_servable(paras) -> None:
    """Refuse, at load, the generators that the JAX server would fail to
    apply to the slices it is sent, naming the key to set: ZSSR maps an
    input already interpolated to the output size (served from a config
    with ``lr_image_size_remain = True``, its clients send the HR-size
    slice; so does SwinIR's denoise head, ``sir_upsampler = ''``, which
    returns its input's size), IPT runs only at its training patch (served
    from a config with ``tiled_inference = True``, its clients send
    patch-size tiles)."""
    name = str(paras.get("feature_generator")
               or paras.get("sr_generator")).strip().lower()
    if name == "zssr" and not paras.get("lr_image_size_remain"):
        raise ValueError(
            "ZSSR does not upsample: it maps a slice already interpolated "
            "to the output size. Serve it from a config with "
            "lr_image_size_remain = True and send HR-size slices")
    if name in ("swinir", "swin") and paras.get("sir_upsampler") == "" \
            and not paras.get("lr_image_size_remain"):
        raise ValueError(
            "SwinIR's denoise head (sir_upsampler = '') returns its input's "
            "size: it maps a slice already interpolated to the output size. "
            "Serve it from a config with lr_image_size_remain = True and "
            "send HR-size slices")
    if name == "ipt" and not paras.get("tiled_inference"):
        p = int(paras.patch_size)
        raise ValueError(
            f"IPT runs only at its training patch ({p}x{p}). Serve it from "
            "a config with tiled_inference = True and send "
            f"{p}x{p} tiles")


def _names_a_path(key: str) -> bool:
    """Whether a config key names a file or a directory (weights, data,
    outputs): a bundle carries none of them."""
    return key.startswith(("well_trained", "pre_trained")) or key.endswith(
        ("_dir", "_folder", "_path", "_ckpt", "_file"))


def _serving_model(paras, device):
    """:func:`build_serving_model`, also returning the normalization a
    bundle carries (``None`` when the config does not normalize)."""
    from rdst_tpu_torch.checkpoint.loading import (load_well_trained_params,
                                                   resolve_model_path,
                                                   resolve_norm_stats)
    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.models import build_generator

    dev = resolve_device(device)
    path = resolve_model_path(paras)
    idt = str(paras.get("inference_dtype", "float32")).lower()
    dtype = torch.bfloat16 if idt in ("bfloat16", "bf16") else torch.float32
    # int8 rides the bf16 fast path only (the f32 precise path drops it,
    # as the JAX precise branch does); the model factory routes it
    residual_scale = float(paras.get("residual_scale", 0.0) or 0.0)
    if not path:
        raise ValueError("no well-trained model path configured "
                         "(well_trained_single_scale_model_g)")
    _check_servable(paras)
    mean = std = None
    norm = paras.get("normal_inputs") or ""
    if "zero_mean" in norm or "unit_std" in norm:
        mean, std = resolve_norm_stats(paras, path)
    model = build_generator(paras, mean, std, dtype=dtype)
    scales = [float(s) for s in paras.get("sr_scales_for_final_testing",
                                          paras.get("test_sr_scales"))]
    load_well_trained_params(model, paras, path, scales)
    model.to(dev).eval()
    meta = {
        "format": _FORMAT,
        "model_name": paras.get("model_name"),
        "feature_generator": str(paras.get("feature_generator")),
        "input_channel": int(paras.input_channel),
        "dtype": "bfloat16" if dtype == torch.bfloat16 else "float32",
        "layout": "NHWC",
        "scales": scales,
        "scale_free": bool(paras.get("scale_free", False)),
        "residual_scale": residual_scale,
        "pallas_kernels": model.kernel_mode or None,
        "pallas_softmax": model.softmax or None,
        "pallas_quant": sorted(model.quant) or None,
        "routes": list(model.routes),
        "device": str(dev),
        "torch_version": torch.__version__,
        "runtime": RUNTIME,
    }
    norm = None if mean is None else {"mean": [float(v) for v in mean],
                                      "std": [float(v) for v in std]}
    return model, meta, norm


def build_serving_model(paras, device="cuda"):
    """Build the generator + trained weights exactly like the tester, on
    ``device``. Returns ``(model, meta)``; ``meta`` is the manifest
    identity (generator, scales, dtype, kernel mode, softmax variant, int8
    groups, the kernel each route unit runs...). The kernel keys are resolved once, in the
    model builder; the model keeps its mode, so another model built later
    in the process cannot change it."""
    model, meta, _ = _serving_model(paras, device)
    return model, meta


class LiveModel:
    """``predict(x, scale)`` over a live model built from a config, on
    ``device`` ('cuda' unless the caller asks for 'cpu'): on the config's
    data axis there, or on an explicit ``devices`` list."""

    def __init__(self, paras, max_batch: int = 64, buckets=None,
                 device="cuda", devices=None):
        from rdst_tpu_torch.parallel.mesh import (data_mesh_from_paras,
                                                  replicate_module)

        self.mesh = data_mesh_from_paras(paras, device, devices)
        if self.mesh.distributed:
            raise ValueError("the live model is one process over the data "
                             "axis: start it outside a process group")
        self.model, meta = build_serving_model(paras, self.mesh.device)
        self.replicas = replicate_module(self.model, self.mesh.devices)
        self.device = next(self.model.parameters()).device
        self.manifest = dict(meta, entries=[], mesh={
            k: int(v) for k, v in self.mesh.shape.items()})
        self.max_batch = int(max_batch)
        self.buckets = resolve_buckets(max_batch, buckets)
        self._lock = threading.Lock()  # one bucket forward at a time

    def _run(self, blk: np.ndarray, scale=None) -> np.ndarray:
        """One padded bucket through the replicas at ``scale`` (read by a
        scale-free model only, which needs it), a shard each."""
        from rdst_tpu_torch.parallel.mesh import data_parallel

        fns = [lambda s, m=m: m(s, scale) for m in self.replicas]
        with self._lock, torch.inference_mode():
            return data_parallel(self.mesh, fns, blk).float().cpu().numpy()

    def predict(self, x, scale: float) -> np.ndarray:
        """The model at ``scale`` (one of the manifest's) on each slice,
        as the JAX ``LiveModel`` calls it: a scale-free model's output is
        ``int(scale * size)`` a side."""
        x = _canon_input(x)
        scale = float(scale)
        if scale not in self.manifest["scales"]:
            raise ValueError(f"scale {scale} not served; this model serves "
                             f"{self.manifest['scales']}")
        out = _bucketed_predict(lambda blk: self._run(blk, scale), x,
                                self.buckets, self.mesh.size)
        rs = self.manifest["residual_scale"]
        return residual_blend(out, x, rs) if rs > 0 else out


# --------------------------------------------------------------------------
# The serving bundle (counterpart of the JAX package's export_bundle and
# ServingBundle)

MANIFEST_NAME = "MANIFEST.json"
PARAMS_NAME = "params.msgpack"
EXECUTABLE = "cuda_graph"
EXPORT_COMMAND = "python -m rdst_tpu_torch.serving.export"


def _json_safe(key: str, value):
    """``value`` as a manifest keeps it; raises where JSON would give back
    something else (a tuple, a set, a dict with non-string keys)."""
    if json.loads(json.dumps(value)) != value:
        raise ValueError(f"config key {key}={value!r} does not survive JSON "
                         "in a bundle's manifest")
    return value


def export_bundle(paras, out_dir: str, lr_shapes: Sequence[Tuple[int, int]],
                  scales: Optional[Sequence[float]] = None,
                  device="cuda") -> str:
    """Export a trained config to a serving bundle directory, on
    ``device`` ('cuda' unless the caller asks for 'cpu').

    The bundle is ``MANIFEST.json`` (the JAX manifest's keys; the runtime,
    the executable each entry becomes, the routes, the normalization
    resolved here and the config, its weight, data and output paths
    dropped) and ``params.msgpack`` (the parameters in the
    flax layout, the tree of the JAX bundle's). ``lr_shapes`` are the LR
    (H, W) points served, each at every scale (default: the model's);
    :class:`ServingBundle` captures one CUDA graph an entry and bucket.
    Returns ``out_dir``."""
    from rdst_tpu_torch.checkpoint.msgpack_writer import (import_state_dict,
                                                          to_bytes)

    model, meta, norm = _serving_model(paras, device)
    scales = [float(s) for s in (scales or meta["scales"])]
    config = {k: v for k, v in paras.to_dict().items()
              if not _names_a_path(k)}
    # the kernel keys as this build resolved them: loading reads no
    # environment flag and no stats sidecar
    config.update(inference_dtype=meta["dtype"],
                  pallas_kernels=meta["pallas_kernels"] or "off",
                  pallas_softmax=meta["pallas_softmax"] or "",
                  pallas_quant=",".join(meta["pallas_quant"] or ()) or "off")
    config = {k: _json_safe(k, v) for k, v in config.items()}
    os.makedirs(out_dir, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    with open(join(out_dir, PARAMS_NAME), "wb") as f:
        f.write(to_bytes(import_state_dict(state)))
    manifest = {k: v for k, v in meta.items() if k != "device"}
    manifest.update(
        executable=EXECUTABLE, norm=norm, config=config,
        entries=[{"scale": s, "lr_hw": [int(hw[0]), int(hw[1])]}
                 for s in scales for hw in lr_shapes])
    with open(join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def read_manifest(bundle_dir: str) -> dict:
    """A bundle's manifest; raises on a directory that holds none and on a
    bundle the JAX package wrote (StableHLO, which the port cannot run)."""
    path = join(bundle_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{bundle_dir}: no {MANIFEST_NAME}; export "
                                f"a bundle with {EXPORT_COMMAND}")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("runtime") != RUNTIME:
        files = [e["file"] for e in manifest.get("entries", []) if "file" in e]
        raise ValueError(
            f"{bundle_dir} is a bundle of the JAX package: it holds StableHLO "
            f"({', '.join(files) or 'jax.export entries'}) and flax "
            "parameters for XLA, which the port cannot run. Export the "
            f"config for the port with {EXPORT_COMMAND} --config-file X.ini "
            "--out DIR --lr-hw H W")
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"{bundle_dir}: bundle format "
                         f"{manifest.get('format')}, this port reads "
                         f"{_FORMAT}")
    return manifest


def _capture_fault(exc: BaseException) -> str:
    """Where a capture failed: the first error of ``exc``'s chain (the
    capture's end raises again over it) at its innermost frame outside
    torch and this module, and that error."""
    import traceback

    chain = [exc]
    while chain[-1].__context__ is not None and len(chain) < 8:
        chain.append(chain[-1].__context__)
    first = chain[-1]
    skip = (os.path.dirname(torch.__file__), os.path.abspath(__file__))
    frames = [f for f in traceback.extract_tb(first.__traceback__)
              if not os.path.abspath(f.filename).startswith(skip)]
    where = "the model's forward"
    if frames:
        f = frames[-1]
        name = f.filename
        if "rdst_tpu_torch" in name:
            name = name[name.rindex("rdst_tpu_torch"):]
        where = f"{name}:{f.lineno} ({f.name}: {f.line})"
    return f"{where}: {type(first).__name__}: {first}"


class CapturedForward(NamedTuple):
    """One entry's forward at one bucket, captured as a CUDA graph: the
    static input it reads, the static output it writes, and what its
    launches point into, kept alive with it: the kernel plans of the
    modules and the cached device tables (``device.device_table``) that
    the capture read, which a later geometry would otherwise replace or
    evict and free."""

    graph: object
    x: torch.Tensor
    y: torch.Tensor
    plans: list
    tables: list


def _held_forward(model, x: torch.Tensor, scale: float):
    """``model(x, scale)`` in float32, with the kernel plans and the cached
    device tables that the forward used."""
    from rdst_tpu_torch.device import held_tables

    with held_tables() as tables:
        y = model(x, scale).float()
    plans = [m._kernel_plan for m in model.modules()
             if getattr(m, "_kernel_plan", None) is not None]
    return y, plans, tables


class ServingBundle:
    """Serve an exported bundle (:func:`export_bundle`) on ``device``
    ('cuda' unless the caller asks for 'cpu'), with the batch padded to a
    bucket of the ladder, as :class:`LiveModel` does.

    Loading reads the bundle directory only: the generator is rebuilt from
    the manifest's ``config`` and normalization, with its kernel mode,
    softmax variant and int8 groups, and must route as the manifest says.
    On ``cuda`` each (entry, bucket) runs as one CUDA graph, captured at
    its first use (``InferenceServer.warmup`` captures every one before
    traffic): one eager forward on a side stream first, where the kernel
    libraries load and the kernel plans and cached tables are made, then
    the capture. Each graph keeps the kernel plans and cached device tables
    its capture read (:class:`CapturedForward`). A failed capture raises,
    naming the op; nothing falls back to eager execution on the card. On ``cpu`` the model runs eagerly (the
    kernels' plain versions).

    The graphs of a bundle share one memory pool. That is safe because a
    lock serializes every replay (and its copies in and out) on one
    stream, so no two graphs run at once, and each graph's static input
    and output stay allocated for the bundle's life, so no capture takes
    another graph's input or output memory: what graphs share are their
    intermediates, live only during a replay."""

    def __init__(self, bundle_dir: str, max_batch: int = 64, buckets=None,
                 device="cuda"):
        from rdst_tpu_torch.checkpoint.loading import load_well_trained_params
        from rdst_tpu_torch.config import ParametersLoader
        from rdst_tpu_torch.device import resolve_device
        from rdst_tpu_torch.models import build_generator

        self.dir = bundle_dir
        manifest = read_manifest(bundle_dir)
        self.device = resolve_device(device)
        paras = ParametersLoader.from_dict(manifest["config"])
        _check_servable(paras)
        norm = manifest.get("norm") or {}
        dtype = (torch.bfloat16 if manifest["dtype"] == "bfloat16"
                 else torch.float32)
        model = build_generator(paras, norm.get("mean"), norm.get("std"),
                                dtype=dtype)
        built = {"routes": list(model.routes),
                 "pallas_kernels": model.kernel_mode or None,
                 "pallas_softmax": model.softmax or None,
                 "pallas_quant": sorted(model.quant) or None}
        for key, got in built.items():
            if got != manifest.get(key):
                raise ValueError(f"{bundle_dir}: the rebuilt model's {key} "
                                 f"{got} differ from the manifest's "
                                 f"{manifest.get(key)}")
        load_well_trained_params(model, paras, join(bundle_dir, PARAMS_NAME),
                                 manifest["scales"])
        self.model = model.to(self.device).eval()
        self.manifest = dict(manifest, device=str(self.device))
        self.max_batch = int(max_batch)
        self.buckets = resolve_buckets(max_batch, buckets)
        self.graphs: Dict[Tuple, CapturedForward] = {}
        self._pool = None
        self._lock = threading.Lock()  # one replay at a time

    @classmethod
    def load(cls, bundle_dir: str, **kw) -> "ServingBundle":
        return cls(bundle_dir, **kw)

    def _entry_for(self, scale: float, hw: Tuple[int, int]) -> dict:
        for e in self.manifest["entries"]:
            if abs(e["scale"] - scale) < 1e-6 and tuple(e["lr_hw"]) == hw:
                return e
        have = [(e["scale"], tuple(e["lr_hw"]))
                for e in self.manifest["entries"]]
        raise ValueError(f"bundle has no entry for scale {scale} @ LR {hw}; "
                         f"available: {have}")

    def _capture(self, scale: float, shape: Tuple[int, ...]
                 ) -> CapturedForward:
        """Capture the model at ``scale`` on a static input of ``shape``
        (the caller holds the lock, under inference mode)."""
        dev = self.device
        x = torch.zeros(shape, dtype=torch.float32, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.model(x, scale)
        torch.cuda.current_stream(dev).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(dev)
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                y, plans, tables = _held_forward(self.model, x, scale)
        except Exception as e:
            # a capture whose end raises leaves its stream current
            torch.cuda.set_stream(stream)
            raise RuntimeError(
                f"CUDA graph capture of the x{scale:g} forward on a "
                f"{tuple(shape)} batch failed at {_capture_fault(e)}") from e
        return CapturedForward(graph, x, y, plans, tables)

    def _run(self, blk: np.ndarray, scale: float) -> np.ndarray:
        """One padded bucket through the model: its CUDA graph on the card
        (captured at first use), the eager model on the CPU."""
        from rdst_tpu_torch.parallel.mesh import device_scope

        with self._lock, torch.inference_mode(), device_scope(self.device):
            if self.device.type == "cpu":
                return self.model(torch.from_numpy(blk), scale).float(
                ).numpy()
            key = (scale,) + blk.shape
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = self._capture(scale, blk.shape)
            g.x.copy_(torch.from_numpy(blk))
            g.graph.replay()
            return g.y.cpu().numpy()

    def predict(self, x, scale: float) -> np.ndarray:
        """HR of each slice of ``x`` ((H,W) / (N,H,W) / (N,H,W,C) whose
        shape and ``scale`` are a manifest entry's), float32 numpy (N,
        H*s, W*s, C)."""
        x = _canon_input(x)
        entry = self._entry_for(float(scale), x.shape[1:3])
        if x.shape[3] != self.manifest["input_channel"]:
            raise ValueError(f"expected {self.manifest['input_channel']} "
                             f"channel(s), got {x.shape[3]}")
        s = float(entry["scale"])
        out = _bucketed_predict(lambda blk: self._run(blk, s), x,
                                self.buckets)
        rs = self.manifest["residual_scale"]
        return residual_blend(out, x, rs) if rs > 0 else out


def main(argv=None):
    import argparse

    from rdst_tpu_torch.config import ParametersLoader

    ap = argparse.ArgumentParser(
        description="Export a trained config to a serving bundle of the "
        "port (served by rdst_tpu_torch.serving.server --bundle)")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--out", required=True, help="bundle directory")
    ap.add_argument("--lr-hw", type=int, nargs=2, action="append",
                    required=True, metavar=("H", "W"),
                    help="LR shape(s) served (repeatable)")
    ap.add_argument("--scales", type=float, nargs="*", default=None,
                    help="scales served (default: the config's)")
    ap.add_argument("--platform", default="cuda", choices=("cpu", "cuda"),
                    help="device the model is built on (default: cuda)")
    ap.add_argument("set", nargs="*",
                    help="KEY=VALUE config overrides, values parsed like "
                    ".ini values, e.g. well_trained_single_scale_model_g="
                    "\"'weights/rdst_e1_40k_best_oasis20_x4.msgpack'\"")
    args = ap.parse_args(argv)

    paras = ParametersLoader(args.config_file)
    paras.apply_overrides(args.set)
    out = export_bundle(paras, args.out, [tuple(hw) for hw in args.lr_hw],
                        args.scales, device=args.platform)
    with open(join(out, MANIFEST_NAME)) as f:
        print(f.read())


if __name__ == "__main__":
    main()
