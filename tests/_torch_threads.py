"""A fixture that runs a test module's in-process torch work on two threads.

The port's CPU runs in the tests are tiny. With torch's default of one
thread a core, in each of the suite's parallel workers, they spend most of
their time in thread hand-offs: ``tests/test_torch_serial.py`` took 534 s
alone on 8 cores that way, and 60 s on two threads. A module takes the
fixture by importing it::

    from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
