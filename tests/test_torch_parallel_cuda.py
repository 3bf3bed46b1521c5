"""Kernel K4 (``cuda_step.control_step_sharded``): one rank's launch of K1,
K3 or K2 on its contiguous env block gives, bit for bit, the block's rows
of one launch of the same instance over all envs (envs are independent:
each env's group of lanes computes it alone, and a group without an env
writes nothing). At N=64 split over 2 blocks: go2 on
flat ground (K1), go2 on the tiny heightfield (K3, ``gh`` and ``p_xy``
rows included) and the go2 handstand's model with per-env contact
stiffnesses (K2). The same holds on the CPU for the plain version, which
``backend.control_step`` runs on each block of a CPU tensor.

The ``cuda``-marked tests need a GPU and nvcc (skip here); on the card:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_parallel_cuda.py
-m cuda``."""

import pytest
import torch

# by its own name (pytest puts tests/ on the path), which also works where
# tests/conftest.py cannot load (a GPU host without jax)
from test_torch_kernel_host import (  # noqa: F401
    STATE_FIELDS, cuda_device, env, handstand_env, handstand_inputs,
    make_inputs, terrain_env, terrain_inputs,
)
from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
from unitree_rl_gym_tpu_torch.physics import backend as pb
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.physics import engine as eng
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N_GLOBAL = 64
WORLD = 2


@pytest.fixture(scope="module")
def hs_env():
    return handstand_env(8)


def _step(env, t, block=None):
    cfg = env.cfg
    s, aux = pb.control_step(
        env.robot.dyn, env.cparams, env.pd, cfg.sim.dt, cfg.control.decimation,
        eng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}), t["target"],
        t["friction"], t["mass_scale"], env.m_eff_n, env.m_eff_t,
        gh=t.get("gh"), cstiff=t.get("cstiff"), block=block)
    out = {k: getattr(s, k) for k in STATE_FIELDS}
    out.update(aux)
    return out


def check_blocks_bit_identical(env, x, device):
    """Per block, K4 (or the plain version on the CPU) against the rows of
    one step over all envs; returns the K4 launch count of the blocks."""
    t = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    whole = _step(env, t)
    before = cuda_step.LAUNCHES_SHARDED
    for rank in range(WORLD):
        blk = pmesh.env_block(N_GLOBAL, rank, WORLD)
        got = _step(env, pmesh.shard_env_state(t, blk), blk)
        want = pmesh.shard_env_state(whole, blk)
        if device.type == "cuda":
            torch.cuda.synchronize()
        assert set(got) == set(want)
        for k in got:
            assert got[k].shape == want[k].shape, k
            assert torch.equal(got[k], want[k]), (rank, k)
    return cuda_step.LAUNCHES_SHARDED - before


CASES = ("flat", "terrain", "cstiff")


def _inputs(case, env, terrain_env, hs_env):  # noqa: F811
    if case == "flat":
        return env, make_inputs(env.default_dof_pos.numpy(), N_GLOBAL, True, seed=8)
    if case == "terrain":
        return terrain_env, terrain_inputs(terrain_env, N_GLOBAL, seed=8)
    return hs_env, handstand_inputs(hs_env, N_GLOBAL, seed=8)


@pytest.mark.parametrize("case", CASES)
def test_plain_blocks_bit_identical_on_cpu(case, env, terrain_env, hs_env):  # noqa: F811
    e, x = _inputs(case, env, terrain_env, hs_env)
    assert check_blocks_bit_identical(e, x, torch.device("cpu")) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_k4_blocks_bit_identical(case, env, terrain_env, hs_env,  # noqa: F811
                                      cuda_device):
    e, x = _inputs(case, env, terrain_env, hs_env)
    assert check_blocks_bit_identical(e, x, cuda_device) == WORLD
