"""Train a task at its operating point and write its policy artifacts
(counterpart of ``unitree_rl_gym_tpu/scripts/make_pretrain.py``): the flat
npz and meta, ``policy.bin`` and the TorchScript file (``export_policy``),
plus the reward-vs-iteration ``curves.json`` of the run:

    python -m unitree_rl_gym_tpu_torch.scripts.make_pretrain --task=go2 [--out DIR]

Takes every flag of ``scripts/train.py`` and ``--out``, the artifact
directory. The default, ``resources/pre_train/<task>``, is where the JAX
package's producer wrote the fixtures the parity tests read: writing there
replaces them.
"""

import argparse
import os
import shutil

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR, resolve_device
from unitree_rl_gym_tpu_torch.utils import helpers


def make_pretrain(args, out_dir=None):
    """Train ``args.task`` for its ``max_iterations`` from random episode
    lengths, export the policy to ``out_dir`` and copy ``curves.json``;
    returns (out_dir, runner)."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.export.export import export_policy
    from unitree_rl_gym_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    device = resolve_device(args.device)
    env, _ = task_registry.make_env(name=args.task, args=args, device=device)
    runner, train_cfg = task_registry.make_alg_runner(env=env, name=args.task, args=args)
    runner.learn(num_learning_iterations=train_cfg.runner.max_iterations,
                 init_at_random_ep_len=True)

    out_dir = out_dir or os.path.join(
        UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train", args.task)
    os.makedirs(out_dir, exist_ok=True)
    export_policy(runner, out_dir)
    if runner.log_dir:
        curves = os.path.join(runner.log_dir, "curves.json")
        if os.path.exists(curves):
            shutil.copy(curves, os.path.join(out_dir, "curves.json"))
    print(f"[make_pretrain] artifacts written to {out_dir}")
    return out_dir, runner


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None)
    known, rest = ap.parse_known_args(argv)
    return make_pretrain(helpers.get_args(rest), known.out)


if __name__ == "__main__":
    main()
