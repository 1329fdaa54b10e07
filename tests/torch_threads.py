"""A fixture for the port's CPU tests that run many tiny torch ops."""

import pytest
import torch


@pytest.fixture
def one_intra_op_thread():
    """Runs the test at one intra-op thread and restores the old count
    afterwards. Tiny ops (gradgradcheck's float64 convolutions, the tiny
    models' train steps) then never wake the thread pool, and the test
    workers do not oversubscribe the CPU: alone, the lazy-R1 step test takes
    2.7 s at one thread and 4.5 s at eight."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
