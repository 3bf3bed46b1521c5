"""The environment of the port's CPU test files; import
:func:`one_torch_thread` into a test module to apply it there.

- One torch intra-op thread. The suite runs several pytest workers at once,
  and torch's CPU default of one thread per core would have each of them
  contend for every core: the many small ops of the plain physics and of
  PPO's minibatches then wait on their threads (a go2 training iteration
  at 8 envs took 3.1 s on one thread and 11.7 s on eight, on an 8-core box
  under the load of three other test processes). Processes the tests spawn
  (ranks, scripts) inherit ``OMP_NUM_THREADS=1``.
- TensorBoard without TensorFlow. The runner writes TensorBoard scalars
  where ``log_dir`` is set, and ``torch.utils.tensorboard`` imports
  TensorFlow where it is installed (15 s a process on that box) unless
  tensorboard finds its ``tensorboard.compat.notf`` marker module, as its
  TensorFlow-free build ships it; then its own file I/O stub writes the
  same event files. Importing this module registers the marker.

The numbers a test compares depend on neither.
"""

import os
import sys
import types

import pytest
import torch

sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env
