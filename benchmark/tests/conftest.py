"""The benchmark's own tests, all on the CPU: run from the repository root
as ``python -m pytest benchmark/tests``. They put ``benchmark/`` (the
harness, ``benchlib`` and ``reference``) on the path and keep torch on one
thread."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
