"""The frozen work counts equal the port's at go2's and g1's sizes today,
for every kernel instance (K1, K3, K2)."""

import pytest

from benchlib import counts as K


@pytest.mark.parametrize("config", ["go2", "g1"])
@pytest.mark.parametrize("terrain,cs", [(False, False), (True, False), (False, True)])
def test_counts_equal_the_ports(config, terrain, cs):
    import json
    import os

    from unitree_rl_gym_tpu_torch.physics import backend, cuda_step
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    with open(os.path.join(os.path.dirname(K.__file__), "..", "configs",
                           config + ".json")) as f:
        task = json.load(f)["task"]
    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = 2
    env = task_registry.get_task_class(task)(cfg, device="cpu")
    m = backend.soa_model_for(env.robot.dyn)
    dec, it = cfg.control.decimation, cfg.sim.contact_iterations
    assert (K.flops_per_env(m, dec, it, terrain, cs)
            == cuda_step.flops_per_env(m, dec, it, terrain, cs))
    assert K.bytes_per_env(m, terrain, cs) == cuda_step.bytes_per_env(m, terrain, cs)


def test_network_counts():
    # go2's actor: 48 -> 512 -> 256 -> 128 -> 12
    assert K.mlp_flops(48, [512, 256, 128], 12) == 2 * (
        48 * 512 + 512 * 256 + 256 * 128 + 128 * 12)
    assert K.lstm_flops(47, 64) == 2 * (47 * 256 + 64 * 256)
