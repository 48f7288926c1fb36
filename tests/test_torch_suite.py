"""How the port's tests share the machine they run on."""

import torch

from tests import torch_support


def test_torch_threads_fit_the_workers():
    """The pytest workers' torch intra-op pools, together, take no more
    threads than there are CPUs (or one each where there are more workers
    than CPUs)."""
    workers, cpus = torch_support.workers(), torch_support.cpus()
    assert torch.get_num_threads() * workers <= max(cpus, workers)
