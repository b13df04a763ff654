"""One torch intra-op thread for the test files that train on the CPU.

The suite runs its files in parallel worker processes (pytest-xdist). With
torch's default of one thread a core in every worker, the training tests'
OpenMP threads contend for the cores: measured on 8 cores with 6 workers,
the training files took 8 minutes, and 1.5 with one thread each. Import
the fixture into a test module to apply it there.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
