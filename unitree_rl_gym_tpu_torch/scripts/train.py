"""Train a task with the port, on the GPU unless ``--device=cpu``:

    python -m unitree_rl_gym_tpu_torch.scripts.train --task=go2

Counterpart of ``unitree_rl_gym_tpu/scripts/train.py`` (reference
legged_gym/scripts/train.py:11-14): make_env, make_alg_runner, then
``runner.learn`` from random episode lengths. Checkpoints go to
``logs/<experiment_name>/<date>_<run_name>/model_<it>.pt``.
"""

from unitree_rl_gym_tpu_torch import resolve_device
from unitree_rl_gym_tpu_torch.utils import helpers


def train(args):
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    device = resolve_device(args.device)
    env, _ = task_registry.make_env(name=args.task, args=args, device=device)
    runner, train_cfg = task_registry.make_alg_runner(
        env=env, name=args.task, args=args)
    return runner.learn(
        num_learning_iterations=train_cfg.runner.max_iterations,
        init_at_random_ep_len=True,
    )


if __name__ == "__main__":
    train(helpers.get_args())
