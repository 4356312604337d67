"""The machine's cores shared among the test workers.

Under pytest-xdist (the tier-1 command runs 6 workers) every worker's
torch runs, by default, as many OpenMP threads as the machine has cores,
and those threads spin at each parallel region's barrier. Six workers of
8 threads on 8 cores made an RDST-E1 forward on the CPU about 50 times
slower than the same forward alone (6 processes of 3 forwards of 8
slices: 283 s each at 8 threads, 5-6 s each at 1 thread, 1.0 s alone),
and the port's CPU tests are mostly such forwards.

Every worker imports every test module when it collects the suite, so
importing this one gives each worker its share of the cores: torch's
intra-op threads in the worker, and ``OMP_NUM_THREADS`` for the processes
its tests start (spawned ranks, the import-isolation subprocesses), unless
the caller set it. A run in one process keeps torch's default.

The cap holds only in a run that collects this file. A run of selected
files under xdist (``pytest -n 6 tests/test_torch_bundle.py ...``) gets no
cap and is as slow as the suite was before: name this file among them,
or set ``OMP_NUM_THREADS`` yourself. A hook in ``tests/conftest.py``
would not depend on the file being collected.
"""

import os

import torch


def worker_threads(environ=os.environ) -> int:
    """Threads for one worker: the cores this process may use over the
    workers sharing them (at least 1); 0 outside pytest-xdist."""
    if not environ.get("PYTEST_XDIST_WORKER"):
        return 0
    workers = max(1, int(environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    return max(1, len(os.sched_getaffinity(0)) // workers)


THREADS = worker_threads()
if THREADS:
    torch.set_num_threads(THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))


def test_workers_share_the_cores():
    cores = len(os.sched_getaffinity(0))
    assert worker_threads({}) == 0
    assert worker_threads({"PYTEST_XDIST_WORKER": "gw0",
                           "PYTEST_XDIST_WORKER_COUNT": "6"}) == max(
        1, cores // 6)
    assert worker_threads({"PYTEST_XDIST_WORKER": "gw1",
                           "PYTEST_XDIST_WORKER_COUNT": str(4 * cores)}) == 1
    if THREADS:
        assert torch.get_num_threads() == THREADS
        assert int(os.environ["OMP_NUM_THREADS"]) >= 1
