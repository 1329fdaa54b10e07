"""A fixture for the port's CPU tests, which run many small torch ops."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def module_one_intra_op_thread():
    """Runs a test module at one intra-op thread, its module-scoped fixtures
    included, and restores the old count after its last test. A module that
    imports this fixture gets it (autouse applies where the fixture is
    visible, so in that module only). Small ops (gradgradcheck's float64
    convolutions, the tiny models' train steps) then never wake the thread
    pool, and the test workers do not oversubscribe the CPU: alone, the
    lazy-R1 step test takes 2.7 s at one thread and 4.5 s at eight."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
