"""CPU smoke run of training on terrain: two PPO iterations through the API
(``task_registry.make_env`` + ``make_alg_runner`` + ``learn``) on the tiny
heightfield of tests/test_pallas_terrain.py at N=8, through the plain
physics version (no kernel launches), with the terrain level reported."""

from tests.test_torch_kernel_host import tiny_terrain
from tests.test_torch_train import check_rows
from unitree_rl_gym_tpu_torch.envs.go2 import go2_rough_cfg
from unitree_rl_gym_tpu_torch.envs.registry import task_registry
from unitree_rl_gym_tpu_torch.physics import cuda_step
from unitree_rl_gym_tpu_torch.utils import helpers
from port_test_env import one_torch_thread  # noqa: F401  (autouse)


def test_terrain_training_two_iterations_on_cpu():
    cfg = tiny_terrain(go2_rough_cfg())
    cfg.env.num_envs = 8
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, name="go2", log_root=None,
                                              args=helpers.get_args([]))
    before = cuda_step.LAUNCHES_TERRAIN
    rows = runner.learn(2, init_at_random_ep_len=True)
    check_rows(rows, terrain=True)
    assert cuda_step.LAUNCHES_TERRAIN == before
    assert runner._env_state.gh.shape == (68, 8)
