"""Torch's intra-op threads for a test process: its share of the cores.

Every ``tests/test_torch_*.py`` imports this module, so the first port test
file a process collects sets the count before any test runs. Under
pytest-xdist every worker collects every file, and the workers
(``PYTEST_XDIST_WORKER_COUNT``) split the cores between them; a run without
xdist keeps them all. torch's default, one thread a core in every worker,
has the workers' threads spin against each other for the same cores, while
most of the port's tests hold a few hundred rays.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)

torch.set_num_threads(THREADS)
