"""Persistent kernel build cache for the entry points (counterpart of
``unitree_rl_gym_tpu/utils/cache.py``).

The port's compiled programs are its nvcc builds: ``physics/cuda_step.py``
keys each library by its sources and flags under
``cuda_step.BUILD_DIR/<hash>/`` and reuses a build it finds there (default
``unitree_rl_gym_tpu_torch/_build``, git-ignored). Entry points call
:func:`enable_persistent_cache` before they build a kernel.

Opt out with UTRL_BUILD_CACHE=0 (every build goes into a fresh temporary
directory of this process, removed at exit); relocate with
UTRL_BUILD_CACHE_DIR.
"""

import atexit
import os
import shutil
import tempfile


def enable_persistent_cache(path: str = None) -> str:
    """Point ``cuda_step.BUILD_DIR`` at ``path``, at UTRL_BUILD_CACHE_DIR, or
    at the default; with UTRL_BUILD_CACHE=0 at a fresh temporary directory.
    Returns the directory."""
    from unitree_rl_gym_tpu_torch.physics import cuda_step

    if os.environ.get("UTRL_BUILD_CACHE", "1") == "0":
        d = tempfile.mkdtemp(prefix="utrl_build_")
        atexit.register(shutil.rmtree, d, True)
    else:
        d = path or os.environ.get("UTRL_BUILD_CACHE_DIR", cuda_step.DEFAULT_BUILD_DIR)
    cuda_step.BUILD_DIR = d
    return d
