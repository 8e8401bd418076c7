"""Torch's CPU threads under the test runner's parallel workers.

Torch runs its CPU ops on one intra-op thread per core by default. Under
``pytest -n N`` every one of the N worker processes does so, and on a
machine of C cores the N x C spinning OpenMP threads make the heavy CPU
tests of the port 10-60x slower than they are alone (the full-width TF32
check of ``test_torch_fused_rnn.py``: 11 s alone, 653 s among six
workers on eight cores). So each xdist worker takes its share of the
cores, ``max(1, C // N)`` threads, when this module is imported, which
every worker does while it collects the suite, before any test runs. A
run without workers keeps torch's default.
"""

import os

import torch


def worker_threads(cores: int, workers: int) -> int:
    """Torch threads for one of ``workers`` processes on ``cores``."""
    return max(1, cores // max(1, workers))


_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if os.environ.get("PYTEST_XDIST_WORKER") and _WORKERS:
    torch.set_num_threads(worker_threads(os.cpu_count() or 1, int(_WORKERS)))


def test_worker_threads_share_the_cores():
    assert worker_threads(8, 6) == 1
    assert worker_threads(8, 2) == 4
    assert worker_threads(4, 8) == 1
    assert worker_threads(16, 1) == 16
    if os.environ.get("PYTEST_XDIST_WORKER") and _WORKERS:
        assert torch.get_num_threads() == worker_threads(
            os.cpu_count() or 1, int(_WORKERS))
