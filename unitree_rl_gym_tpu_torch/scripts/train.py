"""Train a task with the port, on the GPU unless ``--device=cpu``:

    python -m unitree_rl_gym_tpu_torch.scripts.train --task=go2

Counterpart of ``unitree_rl_gym_tpu/scripts/train.py`` (reference
legged_gym/scripts/train.py:11-14): make_env, make_alg_runner, then
``runner.learn`` from random episode lengths. Checkpoints go to
``logs/<experiment_name>/<date>_<run_name>/model_<it>.pt``.

Env data parallelism over ranks (``parallel/mesh.py``)::

    python -m torch.distributed.run --nproc_per_node=2 \\
        -m unitree_rl_gym_tpu_torch.scripts.train --task=go2
    python -m torch.distributed.run --nproc_per_node=2 \\
        -m unitree_rl_gym_tpu_torch.scripts.train --task=g1 --dist_backend=gloo

Under torchrun each rank joins the process group (``--dist_backend``,
default: NCCL with a card per rank, gloo on the CPU, and an error for
ranks that would share a card unless ``--dist_backend=gloo``), holds its
block of the ``--num_envs`` global envs and trains one replica of the
policy (an MLP, or the humanoids' LSTM with recurrent PPO); rank 0 alone
logs and writes the checkpoints.

Kernel builds go to the persistent build cache (``utils/cache.py``:
UTRL_BUILD_CACHE=0 opts out, UTRL_BUILD_CACHE_DIR relocates it), and
UTRL_PROFILE_ITERS=n traces n iterations into ``<log_dir>/profile``.
"""

from unitree_rl_gym_tpu_torch import resolve_device
from unitree_rl_gym_tpu_torch.parallel import mesh as pmesh
from unitree_rl_gym_tpu_torch.utils import helpers


def train(args):
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    device = resolve_device(args.device)
    env_cfg, _ = task_registry.get_cfgs(args.task)
    env_cfg, _ = helpers.update_cfg_from_args(env_cfg, None, args)
    block = None
    if pmesh.launched_by_torchrun():
        device = pmesh.init_process_group(device, backend=args.dist_backend)
        block = pmesh.env_block(env_cfg.env.num_envs)
    env, _ = task_registry.make_env(name=args.task, args=args, env_cfg=env_cfg,
                                    device=device, block=block)
    runner, train_cfg = task_registry.make_alg_runner(
        env=env, name=args.task, args=args)
    return runner.learn(
        num_learning_iterations=train_cfg.runner.max_iterations,
        init_at_random_ep_len=True,
    )


if __name__ == "__main__":
    train(helpers.get_args())
