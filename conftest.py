"""The test workers' thread budget.

The tier-1 run spreads the tests over pytest-xdist workers (6 on an 8-core
box), and torch's intra-op pool defaults to a thread per core, so every
worker's pool spun on every core: the workers' spin-waits took about 9-95x
the tests' own time. Under xdist each worker gets its share of the cores
instead, cpu_count // workers threads (at least 1): through OMP_NUM_THREADS,
set before tests/conftest.py imports numpy and JAX and inherited by the
subprocesses that the CLI tests start, unless the environment sets it; and
torch.set_num_threads, which holds even where a plugin imported torch
first. Outside xdist nothing changes.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers and "OMP_NUM_THREADS" not in os.environ:
    _threads = max(1, (os.cpu_count() or 1) // int(_workers))
    os.environ["OMP_NUM_THREADS"] = str(_threads)
    import torch

    torch.set_num_threads(_threads)
