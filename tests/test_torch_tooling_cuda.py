"""Module 12's tooling on the card: the roofline's FMA probe
(``csrc/roofline_fma.cu``) against its plain version, and
``scripts/profile_train.py``'s aggregation on a real profile.

The ``cuda``-marked tests need a GPU and nvcc (they skip here); on the card:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_tooling_cuda.py
-m cuda``. This file imports no JAX."""

import pytest
import torch

from unitree_rl_gym_tpu_torch.scripts import profile_train as ptrain
from unitree_rl_gym_tpu_torch.scripts import roofline as rl
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fma_probe_matches_plain(cuda_device):
    """At the roofline's shape, within rtol 1e-4 of the plain version (which
    rounds each round once, as fmaf); one launch counted."""
    x = rl.fma_input(cuda_device)
    before = rl.LAUNCHES_FMA
    got = rl.fma_chain(x)
    torch.cuda.synchronize()
    assert rl.LAUNCHES_FMA == before + 1
    ref = rl.fma_chain_plain(x)
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-4
    # a ragged size: the last block's tail is masked
    y = x.flatten()[:1000].contiguous()
    torch.testing.assert_close(rl.fma_chain(y, outer=3), rl.fma_chain_plain(y, outer=3),
                               rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_profile_aggregation(cuda_device):
    """Kernels under the profiler ranges the PPO iteration records: every
    device kernel counted once, by name and by range."""
    a = torch.randn(512, 512, device=cuda_device)

    def work():
        with torch.profiler.record_function("ppo_rollout"):
            for _ in range(3):
                a.add_(1.0)
        with torch.profiler.record_function("ppo_update"):
            for _ in range(2):
                a @ a

    prof = ptrain.profiled(work, cuda_device)
    spans, kernels = ptrain.device_events(prof)
    assert kernels and {"ppo_rollout", "ppo_update"} <= set(spans)
    total, rows = ptrain.top_kernels(kernels)
    assert total > 0 and rows
    assert abs(sum(pct for _, pct, _ in rows) - 100.0) < 1e-6
    out = ptrain.iteration_breakdown(prof, 1e3, 1e3, 1e3, kernel="k1_ms", rollout_range=None)
    assert out["rollout_device_ms"] > 0 and out["update_device_ms"] > 0
    assert out["gemm_kernels_ms"] > 0
    assert abs(out["rollout_device_ms"] + out["update_device_ms"] - total) < 1e-6
    step = ptrain.step_breakdown(prof, 5, 1e3)
    assert abs(step["device_ms_per_step"] * 5 - total) < 1e-6
