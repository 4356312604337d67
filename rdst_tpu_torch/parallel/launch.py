"""Start the ranks of a data axis from one process: one process per device,
each with the environment ``torchrun`` would give it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), so that a spawned rank and a ``torchrun`` rank join the
group the same way (:func:`~rdst_tpu_torch.parallel.mesh.
initialize_distributed`). ``python -m rdst_tpu_torch.train`` spawns its
ranks here when it is started without that environment and its data axis
is longer than 1."""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

# exit code of the trainer's RSS restart: every rank exits with it, and so
# does the process that spawned them, for a supervisor to restart
RESTART_EXIT = 17


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, devices, env: dict, threads: int, args):
    from rdst_tpu_torch.parallel.mesh import (backend_for,
                                              initialize_distributed)

    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank))
    dev = torch.device(devices[rank])
    if dev.type == "cpu":
        torch.set_num_threads(threads)
    else:
        torch.cuda.set_device(dev)
    initialize_distributed(backend_for(devices))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, devices, *args) -> None:
    """Run ``fn(*args)`` (a function at module level: it is pickled by
    name) in one new process per entry of ``devices``, rank ``r`` on
    ``devices[r]``, all in one new process group; returns when every rank
    has returned. A rank that raises stops the others and the error is
    raised here; ranks that exit 17 (the trainer's RSS restart) make this
    process exit 17. CPU ranks share this process's intra-op threads."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    world = len(devices)
    env = {"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    threads = max(1, torch.get_num_threads() // world)
    try:
        mp.start_processes(_rank_main, args=(fn, devices, env, threads, args),
                           nprocs=world, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        if e.exit_code == RESTART_EXIT:
            raise SystemExit(RESTART_EXIT) from e
        raise
