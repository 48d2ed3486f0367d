"""One torch thread for the port's CPU tests under the suite's parallel
workers (pytest-xdist).

torch gives every process a pool of a thread a core. With six workers on
a machine of eight cores, the pools' threads wait on one another: a tiny
model's train step on the CPU took 31-47 s in each of four processes run
side by side, 0.3-3.5 s with one thread each. A port test file imports
``one_torch_thread``; the fixture holds its process to one torch thread
for the file's tests where it runs in a worker, and leaves a serial run
as it is.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    if "PYTEST_XDIST_WORKER" not in os.environ:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
