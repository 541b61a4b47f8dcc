"""The one torch-thread rule of the port's CPU tests.

Every ``tests/test_torch_*.py`` but ``test_torch_cuda.py`` imports
``_one_torch_thread``, which makes the fixture autouse in that module. The
suite runs several workers on the host's cores; torch's own thread pool in
each (a thread a core) would oversubscribe them. ``test_torch_cuda.py`` runs
only on the card's machine, alone, where its CPU references keep the pool.

(Not a test module itself; ``tests/test_torch_imports.py`` checks that the
rule holds in every file.)
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread for the test, then the count it had before."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
