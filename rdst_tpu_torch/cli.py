"""Command-line entry points of the port (counterpart of
``rdst_tpu/cli.py``); ``python -m rdst_tpu_torch.train`` runs
:func:`train_main`, ``python -m rdst_tpu_torch.test`` :func:`test_main`.

Devices: the config's ``mesh_shape`` / ``mesh_axes`` give the data axis
(:mod:`rdst_tpu_torch.parallel`); with neither key it spans every visible
GPU. ``--gpu-id N`` pins an entry point to ``cuda:N`` (a data axis of 1),
``--gpu-id -1`` runs on the CPU, where ``mesh_shape=[N]`` runs N CPU
ranks. Training runs one process per device of the data axis: under
``torchrun`` each process joins the group its environment describes;
started without that environment, :func:`train_main` spawns the ranks
itself (:func:`rdst_tpu_torch.parallel.launch.spawn`). Testing runs one
process with a replica of the model on each device.
"""

from __future__ import annotations

import argparse
import os
import sys


def train_main(argv=None, devices=None):
    """``--config-file X.ini [--gpu-id N] [--seg-loss] [--seed S]
    [KEY=VALUE ...]``, as
    ``rdst_tpu.cli.train_main`` takes them: build the trainer
    (:func:`build_trainer`), set it up (resuming from its checkpoint when
    there is one) and train; returns the trainer. With a data axis of
    more than one device and no process group, spawn one rank per device
    instead (each runs this function) and return None once they are done.
    ``devices``: an explicit device list for the data axis (it may repeat
    a device; tests and smoke runs on one card), else the config's."""
    from rdst_tpu_torch.parallel import data_mesh_from_paras
    from rdst_tpu_torch.parallel.launch import spawn

    argv = list(sys.argv[1:] if argv is None else argv)
    if "RANK" not in os.environ:
        args = _train_parser().parse_args(argv)
        mesh = data_mesh_from_paras(_load_paras(args), _device_of(args.gpu_id),
                                    devices)
        if mesh.size > 1:
            spawn(train_main, mesh.devices, argv, mesh.devices)
            return None
    trainer = build_trainer(argv, devices)
    trainer.setup()
    trainer.train()
    return trainer


def _device_of(gpu_id) -> str:
    """``cuda`` by default, ``cuda:N`` for ``--gpu-id N``, the CPU for
    ``--gpu-id -1``."""
    if gpu_id is None:
        return "cuda"
    return "cpu" if gpu_id == -1 else f"cuda:{gpu_id}"


def _load_paras(args):
    from rdst_tpu_torch.config import ParametersLoader

    paras = ParametersLoader(args.config_file)
    if args.gpu_id is not None:
        paras.set("gpu_id", args.gpu_id)
        paras.set("eva_gpu_id", args.gpu_id)
    paras.apply_overrides(args.overrides)
    return paras


def _train_parser():
    parser = argparse.ArgumentParser(description="Training Parameters")
    parser.add_argument("--config-file", type=str, required=True,
                        metavar="CONFIG", help="Path to config file.")
    parser.add_argument("--gpu-id", type=int, metavar="GPU",
                        help="CUDA device id; -1 runs on the CPU.")
    parser.add_argument("--seg-loss", action="store_true",
                        help="Use the segmentation-label training dataset.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("overrides", nargs="*", metavar="KEY=VALUE",
                        help="Config overrides, e.g. batch_size=16 or "
                             "mesh_shape=[2] (values parsed like .ini "
                             "values).")
    return parser


def build_trainer(argv=None, devices=None):
    """Parse the training command line and build its trainer and data.
    Runs on the card (``cuda:N``, default ``cuda``); ``--gpu-id -1`` asks
    for the CPU. Without a card and without that flag it raises. Under
    ``torchrun``'s environment it first joins the process group, and the
    trainer is this process's rank of the data axis (``devices``: an
    explicit list for it, as :func:`train_main` takes)."""
    args = _train_parser().parse_args(argv)

    from rdst_tpu_torch.data.readers import make_train_valid_datasets
    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.parallel import (data_mesh_from_paras,
                                         initialize_distributed)
    from rdst_tpu_torch.runners.trainer import TransSRTrainer

    device = _device_of(args.gpu_id)
    resolve_device(device)  # no card and no --gpu-id -1: raise now
    paras = _load_paras(args)
    initialize_distributed("gloo" if device == "cpu" else "nccl")
    mesh = data_mesh_from_paras(paras, device, devices)

    ds_train, ds_valid = make_train_valid_datasets(paras,
                                                   seg_loss=args.seg_loss)
    print(f"DS info: {len(ds_train)} training samples, and "
          f"{ds_valid.test_len()} testing cases.")
    return TransSRTrainer(paras, ds_train, ds_valid, seed=args.seed,
                          device=device, mesh=mesh)


def test_main(argv=None, devices=None):
    """``--config-file X.ini [--gpu-id N] [KEY=VALUE ...]``, as
    ``rdst_tpu.cli.test_main`` takes them: score the config's testing
    patients with its trained weights by the ``test.py`` protocol and
    write the tester's artifacts; returns the tester. Runs on the card
    (``cuda:N``, default ``cuda``: the config's data axis, every visible
    GPU by default, a replica of the model on each; ``devices``: an
    explicit list instead); ``--gpu-id -1`` asks for the CPU. Without a
    card and without that flag it raises."""
    parser = argparse.ArgumentParser(description="Testing Parameters")
    parser.add_argument("--config-file", type=str, required=True,
                        metavar="CONFIG", help="Path to config file.")
    parser.add_argument("--gpu-id", type=int, metavar="GPU",
                        help="CUDA device id; -1 runs on the CPU.")
    parser.add_argument("overrides", nargs="*", metavar="KEY=VALUE",
                        help="Config overrides, e.g. tiled_inference=True "
                             "(values parsed like .ini values).")
    args = parser.parse_args(argv)

    from rdst_tpu_torch.device import resolve_device
    from rdst_tpu_torch.runners.tester import TransSRTester

    device = _device_of(args.gpu_id)
    resolve_device(device)
    tester = TransSRTester(_load_paras(args), device=device, devices=devices)
    tester.setup()
    tester.test()
    return tester
