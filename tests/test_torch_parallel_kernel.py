"""Port parity for the sharded control step (kernel K4's path): the port's
``backend.control_step`` run per ``EnvBlock`` of a 2-rank split on the CPU
(the plain version on each rank's block; the step has no traffic between
ranks, so no process group is needed) and concatenated, against the JAX
package's ``pallas_step.control_step_pallas_sharded`` in interpret mode on a
2-device ("env",) mesh of the suite's virtual CPU devices, at N=16 (8 envs
per shard, the smallest batch the kernel's (8, N/8) tiles split in two):
go2 on flat ground, go2 on the tiny heightfield with ``gh`` (``p_xy``
included, sharded on axis 1), and go2 on the heightfield with per-env
contact stiffnesses ``cstiff``. Tolerance: the physics bar of
tests/test_torch_physics.py (atol 5e-5 / rtol 1e-4 on state and p_xy, aux
/ max(|aux|, 1) within 5e-4). The three cases share one jitted JAX program,
the kernel's ``gh`` and ``cstiff`` variant (one Pallas-interpreter compile):
the flat case passes gh = 0 and every case without stiffnesses cstiff = 1,
which the kernel computes exactly as its variants without them
((radius + 0) - z = radius - z, and bias x 1 = bias).

What this module does not hold, and where that is held unsharded: the
kernel's flat variant (no ``gh``, no ``cstiff``) against the port's plain
version in tests/test_torch_physics_pallas.py (go2, N=8), and the
handstand's sizes (79 contact points, decimation 5, torques not clipped)
with per-env stiffnesses in tests/test_torch_physics_cstiff_pallas.py. A
block's launch equals its rows of the one-process launch (the part that
sharding adds) in tests/test_torch_parallel_cuda.py, for go2 flat, go2 on
terrain and the handstand with stiffnesses: the plain version's blocks on
the CPU, the K1, K3 and K2 instances' on the card.

``parallel.mesh.shard_env_state`` slices the row-layout fields ``gh`` and
``p_xy`` on axis 1 by name, contiguously, and every other batched field on
axis 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernel_host import (  # noqa: F401
    AUX_KEYS, CSTIFF, POSITION_KEYS, STATE_FIELDS, assert_close, make_inputs,
    terrain_env, terrain_inputs, tiny_terrain,
)
from tests.test_torch_physics import envs, jax_args, jax_flat  # noqa: F401
from unitree_rl_gym_tpu.parallel import mesh as jmesh
from unitree_rl_gym_tpu.physics import pallas_step
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
from unitree_rl_gym_tpu_torch.physics import backend as pb
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.physics import engine as eng
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

N_GLOBAL = 16
WORLD = 2


@pytest.fixture(scope="module")
def jax_sharded(envs):  # noqa: F811
    """JAX K4 (go2) in interpret mode on a 2-device mesh with ``gh`` and
    ``cstiff``, jitted once for the module: ``run(x, gh=None, cstiff=None)``
    gives numpy outputs, gh = 0 and cstiff = 1 where not given."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 2 (virtual) devices")
    side = envs[0]
    cfg = side.cfg
    mesh = jmesh.make_mesh(WORLD)

    @jax.jit
    def step(state, target, friction, mass_scale, gh, cstiff):
        return pallas_step.control_step_pallas_sharded(
            side.robot.dyn, side.cparams, side.pd, cfg.sim.dt,
            cfg.control.decimation, state, target, friction, mass_scale,
            side.m_eff_n, side.m_eff_t, mesh=mesh, interpret=True, gh=gh,
            cstiff=cstiff)

    def run(x, gh=None, cstiff=None):
        n = x["joint_q"].shape[0]
        gh = np.zeros((68, n), np.float32) if gh is None else gh
        cstiff = np.ones(n, np.float32) if cstiff is None else cstiff
        state, aux = step(*jax_args(x), jnp.asarray(gh), jnp.asarray(cstiff))
        out = jax_flat(state, aux)
        out["p_xy"] = np.asarray(aux["p_xy"])
        return out

    return run


def port_per_block(env, x):
    """``backend.control_step`` on each rank's block of the inputs ``x``
    (numpy, over all envs), outputs concatenated over the blocks."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = env.cfg
    outs = []
    for rank in range(WORLD):
        blk = pmesh.env_block(N_GLOBAL, rank, WORLD)
        local = pmesh.shard_env_state(t, blk)
        s, aux = pb.control_step(
            env.robot.dyn, env.cparams, env.pd, cfg.sim.dt,
            cfg.control.decimation,
            eng.PhysicsState(**{k: local[k] for k in STATE_FIELDS}),
            local["target"], local["friction"], local["mass_scale"],
            env.m_eff_n, env.m_eff_t, gh=local.get("gh"),
            cstiff=local.get("cstiff"), block=blk)
        out = {k: getattr(s, k) for k in STATE_FIELDS}
        out.update(aux)
        outs.append(out)
    return {k: torch.cat([o[k] for o in outs], dim=1 if k == "p_xy" else 0).numpy()
            for k in outs[0]}


def test_flat_blocks_match_jax_sharded(envs, jax_sharded):  # noqa: F811
    jenv, tenv, _ = envs
    x = make_inputs(np.asarray(jenv.default_dof_pos), N_GLOBAL, grounded=True,
                    seed=3)
    before = (cuda_step.LAUNCHES, cuda_step.LAUNCHES_SHARDED)
    got = port_per_block(tenv, x)
    assert (cuda_step.LAUNCHES, cuda_step.LAUNCHES_SHARDED) == before
    ref = jax_sharded(x)
    assert float(np.abs(got["cf_rb"]).max()) > 1.0
    assert_close(ref, got, STATE_FIELDS + AUX_KEYS)


def test_terrain_blocks_match_jax_sharded(terrain_env, jax_sharded):  # noqa: F811
    x = terrain_inputs(terrain_env, N_GLOBAL, seed=5)
    got = port_per_block(terrain_env, x)
    assert got["p_xy"].shape == (2 * 68, N_GLOBAL)
    assert float(np.abs(x["gh"]).max()) > 0.01
    gh = x.pop("gh")
    ref = jax_sharded(x, gh=gh)
    assert_close(ref, got, POSITION_KEYS + AUX_KEYS)


def test_cstiff_blocks_match_jax_sharded(terrain_env, jax_sharded):  # noqa: F811
    """Per-env stiffnesses from 0.25 to 3.0 (tests/test_torch_kernel_host.py's
    CSTIFF) on the heightfield; each block's ``cstiff`` is its rows."""
    x = dict(terrain_inputs(terrain_env, N_GLOBAL, seed=6),
             cstiff=np.resize(CSTIFF, N_GLOBAL))
    got = port_per_block(terrain_env, x)
    gh, cs = x.pop("gh"), x.pop("cstiff")
    ref = jax_sharded(x, gh=gh, cstiff=cs)
    assert_close(ref, got, POSITION_KEYS + AUX_KEYS)


def test_block_of_the_wrong_size_raises(envs):  # noqa: F811
    _, tenv, _ = envs
    x = make_inputs(tenv.default_dof_pos.numpy(), N_GLOBAL, True, seed=3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = tenv.cfg
    with pytest.raises(ValueError, match="block holds 8"):
        pb.control_step(
            tenv.robot.dyn, tenv.cparams, tenv.pd, cfg.sim.dt, 1,
            eng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}), t["target"],
            t["friction"], t["mass_scale"], tenv.m_eff_n, tenv.m_eff_t,
            block=pmesh.env_block(N_GLOBAL, 0, WORLD))


def test_sharded_kernel_wrapper_rejects_cpu_tensors(envs):  # noqa: F811
    _, tenv, _ = envs
    blk = pmesh.env_block(N_GLOBAL, 1, WORLD)
    x = make_inputs(tenv.default_dof_pos.numpy(), blk.n_local, True, seed=3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = tenv.cfg
    with pytest.raises(ValueError, match="CUDA"):
        cuda_step.control_step_sharded(
            pb.soa_model_for(tenv.robot.dyn), tenv.cparams, tenv.pd,
            cfg.sim.dt, 1, eng.PhysicsState(**{k: t[k] for k in STATE_FIELDS}),
            t["target"], t["friction"], t["mass_scale"], tenv.m_eff_n,
            tenv.m_eff_t, blk)


# ---------------------------------------------------------------------------
# shard_env_state: the layout is declared by field name
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def global_terrain_state():
    cfg = tiny_terrain(go2_rough_cfg())
    cfg.env.num_envs = N_GLOBAL
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device="cpu")
    state, _ = env.reset_all()
    return state


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_env_state_by_field_name(global_terrain_state, rank):
    state = global_terrain_state
    blk = pmesh.env_block(N_GLOBAL, rank, WORLD)
    local = pmesh.shard_env_state(state, blk)
    lo, hi = blk.offset, blk.offset + blk.n_local
    assert local.gh.shape == (68, 8) and local.gh.is_contiguous()
    assert torch.equal(local.gh, state.gh[:, lo:hi])
    for name in ("base_pos", "base_quat", "joint_q", "v"):
        assert torch.equal(getattr(local.phys, name),
                           getattr(state.phys, name)[lo:hi])
    for f in ("episode_length", "commands", "actions", "friction",
              "env_origin", "terrain_level", "terrain_type", "obs", "win",
              "win_corner", "win_stale", "episode_sums"):
        a = getattr(local, f)
        assert a.shape[0] == blk.n_local, f
        assert torch.equal(a, getattr(state, f)[lo:hi]), f
    assert torch.equal(local.cmd_vx_range, state.cmd_vx_range)
    # a square row-layout field is still cut on axis 1, because of its name
    sq = torch.arange(N_GLOBAL * N_GLOBAL, dtype=torch.float32).reshape(
        N_GLOBAL, N_GLOBAL)
    out = pmesh.shard_env_state({"p_xy": sq, "v": sq}, blk)
    assert torch.equal(out["p_xy"], sq[:, lo:hi]) and out["p_xy"].is_contiguous()
    assert torch.equal(out["v"], sq[lo:hi])
