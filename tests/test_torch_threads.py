"""torch's CPU threads under pytest-xdist.

torch starts one intra-op thread per core in every process. Under
``pytest -n N`` the N workers then contend for the same cores, and the
port's CPU tests run about ten times slower than alone (a train-CLI parity
test: ~18 s alone, over 200 s in each of six concurrent copies). Every
xdist worker imports every test module while it collects, before any test
runs, so this module's import gives each worker its share of the cores,
once, for all the port's tests. The JAX tests are untouched (XLA keeps its
own thread pool), and a run without xdist keeps torch's default.
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
torch.set_num_threads(THREADS)


def test_each_worker_gets_its_share_of_the_cores():
    assert torch.get_num_threads() == THREADS
    # the workers together never ask for more threads than cores
    assert THREADS == 1 or THREADS * WORKERS <= os.cpu_count()
