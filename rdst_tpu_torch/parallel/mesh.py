"""Device meshes of the port (counterpart of ``rdst_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a mesh whose ``data`` axis
shards each batch. The port runs the same data axis in two ways:

* training is multi-process: each rank is one process that owns one
  device, in a ``torch.distributed`` process group (NCCL on distinct
  CUDA devices, gloo on the CPU or where a device repeats), built from
  the environment ``torchrun`` sets (:func:`initialize_distributed`);
* inference is single-process over several devices: the tester and the
  live model hold one replica of the model on each device of the data
  axis (:func:`replicate_module`), split each padded batch into equal
  shards (:func:`shard_batch_padded`) and gather the outputs
  (:func:`data_parallel`).

Config keys, as in the JAX package: ``mesh_shape`` (one ``-1`` wildcard
allowed) and ``mesh_axes`` (names, by position ``data``, ``model``,
``seq`` by default). With neither key the data axis spans every visible
GPU (``device='cuda'``), the one GPU ``cuda:N`` names, or one CPU rank.
On the CPU ``mesh_shape = [N]`` runs N CPU ranks, as the JAX tests' virtual
CPU devices do. The ``model`` and ``seq`` axes (tensor and sequence
parallelism, ``rdst_tpu/parallel/sharding.py``) are not ported: an entry
point refuses a mesh where either is larger than 1
(:func:`data_mesh_from_paras`). Each device's kernels see only that
device's shard, so the JAX package's ``active_data_mesh`` /
``shard_grid_over_data`` have no counterpart.

Only an explicit device list (the ``devices`` argument, never a config key
or an environment variable) may repeat a device, e.g. ``['cuda:0',
'cuda:0']``: two ranks or replicas on one card, for tests and smoke runs
on a one-GPU machine.
"""

from __future__ import annotations

import contextlib
import copy
import os
import warnings
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rdst_tpu_torch.parallel.collectives import gather_rows

DEFAULT_AXES = ("data", "model", "seq")
# where the refusal of a model or seq axis points
SHARDING_ITEM = ("ROADMAP Queue A 11 (tensor and sequence parallelism, "
                 "rdst_tpu/parallel/sharding.py)")
# A rank waits in a collective while rank 0 alone scores an evaluation
# (FID included) and writes its snapshots: the group's timeout covers the
# longest evaluation.
GROUP_TIMEOUT = timedelta(hours=2)


class Mesh:
    """Named ``axes`` of ``shape`` over ``devices`` (row-major, as a JAX
    mesh reshapes its device list), and this process's place in the
    process group: ``rank`` of ``world`` (0 of 1 outside a group).
    ``distributed`` says whether this process is in a group: its data
    axis then spans the group's ranks, one device each."""

    def __init__(self, axes: Sequence[str], shape: Sequence[int], devices,
                 rank: int = 0, world: int = 1, distributed: bool = False):
        axes, shape = tuple(str(a) for a in axes), [int(s) for s in shape]
        if len(axes) != len(shape):
            raise ValueError(f"mesh_axes {axes} and mesh_shape {shape} "
                             "disagree")
        self.devices = [torch.device(d) for d in devices]
        if int(np.prod(shape)) != len(self.devices):
            raise ValueError(f"mesh shape {shape} over {len(self.devices)} "
                             "devices")
        self.axes = axes
        self.shape = dict(zip(axes, shape))
        self.rank, self.world, self.distributed = rank, world, distributed
        if distributed and world != self.size:
            raise ValueError(
                f"the process group has {world} ranks but the data axis "
                f"{self.size} devices: start one rank per device of the "
                "data axis")
        self._replication_warned = False

    @property
    def size(self) -> int:
        """The length of the data axis."""
        return self.shape.get("data", 1)

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices this process drives: its own in a process group,
        else every device of the data axis."""
        if self.distributed:
            return [self.devices[self.rank]]
        return self.devices[:self.size]

    @property
    def device(self) -> torch.device:
        """This process's first device (a rank's only one)."""
        return self.local_devices[0]

    def holds_rows(self, n: int) -> bool:
        """A batch of ``n`` rows is split over the ranks: this process
        holds ``n / world`` of them (else every rank holds all ``n``)."""
        return self.distributed and self.world > 1 and n % self.world == 0

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices]}"
                f", rank={self.rank}, world={self.world})")


def backend_for(devices) -> str:
    """The process group's backend for ranks on ``devices``: NCCL on
    distinct CUDA devices, gloo on the CPU or where a device repeats
    (NCCL refuses two ranks on one device)."""
    devs = [torch.device(d) for d in devices]
    cuda = all(d.type == "cuda" for d in devs)
    return "nccl" if cuda and len(set(map(str, devs))) == len(devs) else "gloo"


def initialize_distributed(backend: str,
                           timeout: timedelta = GROUP_TIMEOUT
                           ) -> Tuple[int, int]:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); returns
    ``(rank, world)``, ``(0, 1)`` without that environment. Joining twice
    is a no-op."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return 0, 1
        if backend == "nccl":  # NCCL binds a rank to the current device
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def _group() -> Tuple[int, int, bool]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


def visible_devices(device="cuda", need: int = 1) -> List[torch.device]:
    """The devices a data axis may span on ``device``: every visible GPU
    for ``'cuda'``, the one ``'cuda:N'`` names, and ``need`` CPU ranks for
    ``'cpu'``. In a process group each rank brings its own: ``cuda:
    LOCAL_RANK`` (the rank modulo ``LOCAL_WORLD_SIZE``), or the CPU."""
    from rdst_tpu_torch.device import resolve_device

    dev = resolve_device(device)  # no card for 'cuda': raise
    _, world, grouped = _group()
    if grouped:
        if dev.type == "cpu":
            return [dev] * world
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        return [torch.device("cuda", r % local) for r in range(world)]
    if dev.type == "cpu":
        return [dev] * max(1, need)
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible GPU); default shape
    one ``data`` axis over all of them. In a process group the mesh takes
    this process's rank and the group's size."""
    from rdst_tpu_torch.device import resolve_device

    if devices is None:
        devices = visible_devices("cuda")
    devices = [resolve_device(d) for d in devices]
    if shape is None:
        shape = [len(devices)] + [1] * (len(axes) - 1)
    return Mesh(axes, shape, devices, *_group())


def make_mesh_from_paras(paras, device="cuda", devices=None) -> Mesh:
    """The mesh the config's ``mesh_shape`` / ``mesh_axes`` describe, by
    the JAX package's rules (``rdst_tpu/parallel/mesh.py:46-95``): the
    default axis names follow position; at most one ``-1`` wildcard,
    inferred from the device count; ``ValueError`` where the axes and the
    shape disagree or more devices are needed than are visible. With
    neither key, one ``data`` axis over every visible device.
    ``devices``: an explicit list (it may repeat a device), else
    :func:`visible_devices` of ``device``."""
    shape = paras.get("mesh_shape")
    axes = paras.get("mesh_axes")
    if devices is None:
        need = 1
        if shape is not None:
            need = int(np.prod([int(s) for s in shape if int(s) > 0]))
        devices = visible_devices(device, need)
    if shape is None:
        return make_mesh(tuple(axes) if axes else ("data",), None, devices)
    shape = [int(s) for s in shape]
    if axes is None:
        if len(shape) > len(DEFAULT_AXES):
            raise ValueError(
                f"mesh_shape has {len(shape)} dims; name them explicitly "
                f"via mesh_axes (defaults cover {DEFAULT_AXES})")
        axes = DEFAULT_AXES[:len(shape)]
    axes = tuple(str(a) for a in axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh_axes {axes} and mesh_shape {shape} disagree")
    if shape.count(-1) > 1:
        raise ValueError(f"mesh_shape {shape} has more than one -1 wildcard")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if known <= 0 or len(devices) % known:
            raise ValueError(f"mesh_shape {shape}: cannot infer -1 from "
                             f"{len(devices)} devices")
        shape[shape.index(-1)] = len(devices) // known
    need = int(np.prod(shape))
    if need > len(devices):
        raise ValueError(f"mesh_shape {shape} needs {need} devices, only "
                         f"{len(devices)} visible")
    return make_mesh(axes, shape, list(devices)[:need])


def data_mesh_from_paras(paras, device="cuda", devices=None) -> Mesh:
    """:func:`make_mesh_from_paras`, refusing any axis but ``data`` larger
    than 1: the port runs the data axis only. Every entry point builds its
    mesh here, so no mesh key is silently dropped."""
    mesh = make_mesh_from_paras(paras, device, devices)
    for axis, n in mesh.shape.items():
        if axis != "data" and n > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {n} (mesh_shape "
                f"{list(mesh.shape.values())}, mesh_axes {list(mesh.axes)}): "
                "the port runs the data axis only; tensor and sequence "
                f"parallelism wait for {SHARDING_ITEM}")
    return mesh


def refuse_mesh(paras, entry: str) -> None:
    """For an entry point that runs on one device (the segmentation
    evaluation and the auxiliary trainers, whose JAX counterparts shard
    nothing either): raise where the config's ``mesh_shape`` asks for more
    than one device, rather than drop the key."""
    shape = paras.get("mesh_shape")
    if shape is not None and any(int(s) != 1 for s in shape):
        raise ValueError(f"{entry} runs on one device; it does not take "
                         f"mesh_shape {list(shape)}")


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a host batch: each array or tensor whose
    leading dimension divides the group's size gives rows ``[r b, (r + 1)
    b)``, ``b = n / world``; one that does not is replicated (every rank
    holds all of it), with a warning the first time (an image-sized one)
    on this mesh, as the JAX ``shard_batch`` warns. Scalars pass as they
    are; outside a group the batch is returned whole."""
    out = {}
    for k, v in batch.items():
        n = getattr(v, "shape", ())[:1]
        if n and mesh.holds_rows(n[0]):
            b = n[0] // mesh.world
            out[k] = v[mesh.rank * b:(mesh.rank + 1) * b]
            continue
        if n and getattr(v, "ndim", 0) >= 2 and mesh.world > 1 \
                and not mesh._replication_warned:
            mesh._replication_warned = True
            warnings.warn(
                f"shard_batch: leading dim {n[0]} does not divide the "
                f"{mesh.world}-rank 'data' axis; replicating (every rank "
                "computes the full batch)")
        out[k] = v
    return out


def shard_batch_padded(mesh: Mesh, x) -> Tuple[List[torch.Tensor], int]:
    """Pad the leading dimension of ``x`` (numpy or a tensor) up to a
    multiple of the data axis, repeating the last element, and cut it into
    equal shards: returns (this process's shards, each on its device of
    :attr:`Mesh.local_devices`; the original size). The callers slice the
    padding off the gathered output."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    n, size = x.shape[0], mesh.size
    pad = (-n) % size
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    b = x.shape[0] // size
    first = mesh.rank if mesh.distributed else 0
    return [x[(first + i) * b:(first + i + 1) * b].to(dev)
            for i, dev in enumerate(mesh.local_devices)], n


def device_scope(device: torch.device):
    """Make ``device`` current while its replica's work is issued (the
    kernels launch on the current stream of their tensors' device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def data_parallel(mesh: Mesh, fns: Sequence[Callable], x) -> torch.Tensor:
    """``fns[i]`` (this process's replica on ``mesh.local_devices[i]``) on
    its shard of ``x`` (:func:`shard_batch_padded`), the outputs gathered
    on the first local device in batch order, the padding sliced off. In a
    process group every rank runs its shard and receives every rank's
    output (:func:`~rdst_tpu_torch.parallel.collectives.gather_rows`)."""
    shards, n = shard_batch_padded(mesh, x)
    outs = []
    for fn, shard in zip(fns, shards):
        with device_scope(shard.device):
            outs.append(fn(shard))
    if mesh.distributed:
        y = gather_rows(outs[0], mesh)
    else:
        y = torch.cat([o.to(outs[0].device) for o in outs])
    return y[:n]


def replicate_module(module: torch.nn.Module, devices) -> list:
    """One copy of ``module`` on each of ``devices`` (the first is
    ``module`` itself, moved there), its kernel mode and routes as
    :mod:`rdst_tpu_torch.models.routes` decided them at build: each copy
    keeps its own prepared kernel operands."""
    devices = [torch.device(d) for d in devices]
    return [module.to(devices[0])] + [copy.deepcopy(module).to(d)
                                      for d in devices[1:]]
