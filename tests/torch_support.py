"""What every port test module (``tests/test_torch_*.py``) imports: a torch
CPU thread budget that fits the pytest workers into the machine's CPUs, and
the one ``card`` fixture.

It imports no JAX, so the card's runs under ``--noconftest -m cuda`` can
use it.  Importing it sets the budget for the whole process; xdist workers
import every test module while they collect, so the budget holds in each
worker from collection on.
"""

import os

import pytest
import torch


def cpus():
    """The CPUs this process may run on."""
    return len(os.sched_getaffinity(0))


def workers():
    """The pytest processes sharing those CPUs (xdist sets the count in each
    of its workers; a plain run is one)."""
    return int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))


# each worker's intra-op (OpenMP) pool would take every CPU, and
# oversubscribed pools stall each other's small ops in their spin-waits
torch.set_num_threads(max(1, cpus() // workers()))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
