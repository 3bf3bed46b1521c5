"""The port runs where there is no JAX: in a fresh interpreter whose import
system refuses jax, jaxlib, flax, optax and unitree_rl_gym_tpu (the GPU
machine's situation), every module of unitree_rl_gym_tpu_torch (the PPO
runner and the terrain included; the export, ``utils/viz.py``,
``utils/flax_msgpack.py`` and the deploy stack, whose modules import
mujoco, yaml, msgpack and unitree_sdk2py only inside the functions that
use them) and chip_smoke import, the go2 env builds
on the CPU at N=4 and steps once, and its PPO runner builds and acts; the
go2_handstand env of the robustness fine-tune (its DR on) builds and
resets, and the fine-tune's runner (its PPO knobs on) takes the shipped
weights, sets its anchor and acts; the per-env control step
(``backend.control_step_vmap``) and the per-substep ``ground_fn`` mode
step a tiny heightfield (the handstand campaign scripts and the per-env
physics are among the modules imported); and the 2-rank dryrun runs on the CPU
(``--device=cpu``; its default is the card) with the same imports refused in
the parent and in both spawned ranks. Without CUDA the dryrun's default
raises instead of running on the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.parallel import dryrun
from port_test_env import one_torch_thread  # noqa: F401  (autouse)

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BANNED = ("jax", "jaxlib", "flax", "optax", "unitree_rl_gym_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    import unitree_rl_gym_tpu_torch as pkg

    names = [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    ]
    for name in names:
        importlib.import_module(name)
    # the handstand campaign scripts and the per-env (vmap) physics among them
    for name in ("scripts.handstand_kickup_r5", "scripts.handstand_transfer_r5",
                 "scripts.handstand_eval", "scripts.handstand_diag",
                 "scripts.handstand_basin", "scripts.handstand_recipe",
                 "physics.engine", "physics.contact", "physics.dynamics",
                 "physics.spatial", "utils.math"):
        assert pkg.__name__ + "." + name in names, name
    import chip_smoke

    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    cfg, _ = task_registry.get_cfgs("go2")
    cfg.env.num_envs = 4
    env = task_registry.get_task_class("go2")(cfg, device="cpu")
    state, obs = env.reset_all()
    state, obs, _, rew, done, _ = env.step(state, torch.zeros(4, 12))
    assert tuple(obs.shape) == (4, 48) and bool(torch.isfinite(obs).all())
    runner, _ = task_registry.make_alg_runner(env, name="go2", log_root=None)
    assert tuple(runner.get_inference_policy()(obs).shape) == (4, 12)

    # the handstand fine-tune's env (contact-stiffness, PD-gain and
    # actuation-delay DR) and runner (nan guard, anchor KL, class weights)
    from unitree_rl_gym_tpu_torch import resource
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_params
    cfg, tcfg = task_registry.get_cfgs("go2_handstand")
    cfg.env.num_envs = 4
    cfg.domain_rand.randomize_contact_stiffness = True
    cfg.domain_rand.randomize_pd_gain = True
    cfg.domain_rand.action_delay_prob = 0.1
    tcfg.algorithm.nan_guard = True
    tcfg.algorithm.anchor_kl_coef = 0.3
    tcfg.algorithm.class_target_frac = 0.5
    env = task_registry.get_task_class("go2_handstand")(cfg, device="cpu")
    state, obs = env.reset_all()
    assert state.cstiff is not None and tuple(obs.shape) == (4, 46)
    runner, _ = task_registry.make_alg_runner(env, train_cfg=tcfg, log_root=None)
    load_flat_params(runner.net, resource("resources/pre_train/go2_handstand"))
    runner.set_anchor()
    assert tuple(runner.get_inference_policy()(obs).shape) == (4, 12)

    # the per-env formulation (torch.func.vmap) and the per-substep
    # ground_fn mode on the tiny heightfield
    from unitree_rl_gym_tpu_torch.physics import backend as pb
    cfg, _ = task_registry.get_cfgs("go2")
    cfg.env.num_envs = 2
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    cfg.terrain.terrain_length = cfg.terrain.terrain_width = 4.0
    cfg.terrain.border_size = 2.0
    env = task_registry.get_task_class("go2")(cfg, device="cpu")
    state, _ = env.reset_all()
    args = (env.robot.dyn, env.cparams, env.pd, cfg.sim.dt, 1, state.phys,
            env.default_dof_pos.expand(2, 12), state.friction, state.mass_scale,
            env.m_eff_n, env.m_eff_t)
    s1, _ = pb.control_step_vmap(*args, ground_fn=env.grid.height_at)
    s2, _ = pb.control_step(*args, ground_fn=env.grid.height_at)
    assert float((s1.v - s2.v).abs().max()) < 1e-3
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    assert not leaked, leaked
    print("imported", len(names), "modules")
    """
)


def test_port_imports_and_steps_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=UNITREE_RL_GYM_TPU_ROOT_DIR,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=UNITREE_RL_GYM_TPU_ROOT_DIR),
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "imported" in res.stdout


def test_parallel_ranks_run_without_jax(tmp_path):
    """The multi-rank path (``parallel/``, and the rank entry that
    ``mesh.spawn_ranks`` starts in fresh interpreters) imports no jax: a
    ``sitecustomize`` that refuses the JAX packages is on the path of the
    parent and of both spawned ranks, which run the 2-rank dryrun's two
    classes on the CPU."""
    refuse = SCRIPT[:SCRIPT.index("import torch")]
    (tmp_path / "sitecustomize.py").write_text(refuse)
    res = subprocess.run(
        [sys.executable, "-m", "unitree_rl_gym_tpu_torch.parallel.dryrun",
         "--world_size", "2", "--device=cpu"],
        cwd=UNITREE_RL_GYM_TPU_ROOT_DIR, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            (str(tmp_path), UNITREE_RL_GYM_TPU_ROOT_DIR))),
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "go2-flat-mlp: n_devices=2 num_envs=8 OK" in res.stdout
    assert "g1-terrain-lstm: n_devices=2 num_envs=8 OK" in res.stdout


def test_dryrun_defaults_to_the_card(monkeypatch):
    """Without CUDA, the dryrun's entry point and its rank raise rather than
    run on the CPU; only ``--device=cpu`` puts it there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr("unitree_rl_gym_tpu_torch.parallel.mesh.spawn_ranks",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--world_size", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_rank()
    assert not spawned
    dryrun.main(["--world_size", "2", "--device=cpu"])
    assert spawned == [(dryrun.dryrun_rank, 2, ("cpu", None))]
