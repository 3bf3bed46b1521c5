"""Task registry (counterpart of ``unitree_rl_gym_tpu/envs/registry.py``):
``get_cfgs``, ``make_env``, ``get_task_class``, ``make_alg_runner``.

The port registers the JAX package's five tasks at import: go2, h1, h1_2,
g1 and go2_handstand."""

from __future__ import annotations

import os
from datetime import datetime
from typing import Callable, Dict, Tuple, Type

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR
from unitree_rl_gym_tpu_torch.envs.base_env import LeggedEnv
from unitree_rl_gym_tpu_torch.utils import helpers
from unitree_rl_gym_tpu_torch.utils.config import LeggedRobotCfg, TrainCfg

class TaskRegistry:
    def __init__(self):
        self.task_classes: Dict[str, Type[LeggedEnv]] = {}
        self.env_cfgs: Dict[str, Callable[[], LeggedRobotCfg]] = {}
        self.train_cfgs: Dict[str, Callable[[], TrainCfg]] = {}

    def register(self, name, task_class, env_cfg_fn, train_cfg_fn):
        self.task_classes[name] = task_class
        self.env_cfgs[name] = env_cfg_fn
        self.train_cfgs[name] = train_cfg_fn

    def _known(self, name):
        if name not in self.task_classes:
            raise ValueError(f"Task with name: {name} was not registered")

    def get_task_class(self, name) -> Type[LeggedEnv]:
        self._known(name)
        return self.task_classes[name]

    def get_cfgs(self, name) -> Tuple[LeggedRobotCfg, TrainCfg]:
        self._known(name)
        env_cfg = self.env_cfgs[name]()
        train_cfg = self.train_cfgs[name]()
        env_cfg.seed = train_cfg.seed
        return env_cfg, train_cfg

    def make_env(self, name, args=None, env_cfg=None, device=None, block=None):
        """Build the env for a task; CLI args override the cfg. ``block``
        (``parallel.mesh.EnvBlock``) gives the env this rank's block of the
        cfg's (global) ``num_envs``."""
        if args is None:
            args = helpers.get_args([])
        task_class = self.get_task_class(name)
        if env_cfg is None:
            env_cfg, _ = self.get_cfgs(name)
        env_cfg, _ = helpers.update_cfg_from_args(env_cfg, None, args)
        helpers.set_seed(env_cfg.seed)
        return task_class(env_cfg, device=device, block=block), env_cfg

    def make_alg_runner(self, env, name=None, args=None, train_cfg=None,
                        log_root="default"):
        """The PPO runner and its log dir (task_registry.py:76-127): under
        ``<repo>/logs/<experiment_name>/<date>_<run_name>`` by default, none
        with ``log_root=None``. ``runner.resume`` loads the latest (or the
        named) checkpoint below ``log_root``."""
        from unitree_rl_gym_tpu_torch.rl.runner import OnPolicyRunner

        if args is None:
            args = helpers.get_args([])
        if train_cfg is None:
            if name is None:
                raise ValueError("Either 'name' or 'train_cfg' must be not None")
            _, train_cfg = self.get_cfgs(name)
        _, train_cfg = helpers.update_cfg_from_args(None, train_cfg, args)

        if log_root == "default":
            log_root = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "logs",
                                    train_cfg.runner.experiment_name)
        log_dir = None if log_root is None else os.path.join(
            log_root,
            datetime.now().strftime("%b%d_%H-%M-%S") + "_" + train_cfg.runner.run_name,
        )
        runner = OnPolicyRunner(env, train_cfg, log_dir)
        if train_cfg.runner.resume:
            resume_path = helpers.get_load_path(
                log_root, load_run=train_cfg.runner.load_run,
                checkpoint=train_cfg.runner.checkpoint,
            )
            print(f"Loading model from: {resume_path}")
            runner.load(resume_path)
        return runner, train_cfg


task_registry = TaskRegistry()


def _register_all():
    from unitree_rl_gym_tpu_torch.envs import g1, go2, go2_handstand, h1, h1_2
    from unitree_rl_gym_tpu_torch.envs.humanoid import G1Env, H1Env, H1_2Env

    task_registry.register(
        "go2", LeggedEnv, go2.go2_rough_cfg, go2.go2_rough_train_cfg
    )
    task_registry.register("h1", H1Env, h1.h1_rough_cfg, h1.h1_rough_train_cfg)
    task_registry.register(
        "h1_2", H1_2Env, h1_2.h1_2_rough_cfg, h1_2.h1_2_rough_train_cfg
    )
    task_registry.register("g1", G1Env, g1.g1_rough_cfg, g1.g1_rough_train_cfg)
    task_registry.register(
        "go2_handstand",
        go2_handstand.GO2HandstandEnv,
        go2_handstand.go2_handstand_cfg,
        go2_handstand.go2_handstand_train_cfg,
    )


_register_all()
