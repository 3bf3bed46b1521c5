"""What both modes share: the program's cfgs from the cell's files, the
reference env, the capture of one env step and its control step, and the
comparisons of those with the reference."""

import copy
import dataclasses
import importlib
import math

import torch

ENV_SEED_MOD = 1 << 32  # the terrain's numpy RandomState takes 32 bits


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def env_seed(seed):
    return int(seed) % ENV_SEED_MOD


def _apply(update, cfg, tcfg, config, traffic, num_envs, seed):
    update(cfg, copy.deepcopy(config["env_cfg"]))
    update(tcfg, copy.deepcopy(config["train_cfg"]))
    update(cfg, copy.deepcopy(traffic.get("env_cfg", {})))
    cfg.env.num_envs = int(num_envs)
    cfg.seed = env_seed(seed)
    return cfg, tcfg


def program_cfgs(config, traffic, num_envs, seed):
    """The port's (env cfg, train cfg) of ``config["task"]`` with every value
    of the configuration's file and the traffic's overrides applied."""
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry
    from unitree_rl_gym_tpu_torch.utils.config import update_class_from_dict

    cfg, tcfg = task_registry.get_cfgs(config["task"])
    return _apply(update_class_from_dict, cfg, tcfg, config, traffic,
                  num_envs, seed)


def program_env(config, traffic, num_envs, seed, device):
    from unitree_rl_gym_tpu_torch.envs.registry import task_registry

    cfg, tcfg = program_cfgs(config, traffic, num_envs, seed)
    return task_registry.get_task_class(config["task"])(cfg, device=device), tcfg


def reference_env(config, traffic, num_envs, seed, device):
    """The reference's env of the same cfg (its class named in the
    configuration's file as ``module:Class`` under ``reference``)."""
    from reference.utils.config import (LeggedRobotCfg, TrainCfg,
                                        update_class_from_dict)

    cfg, _ = _apply(update_class_from_dict, LeggedRobotCfg(), TrainCfg(),
                    config, traffic, num_envs, seed)
    mod, cls = config["reference_env"].split(":")
    return getattr(importlib.import_module(mod), cls)(cfg, device=device)


def to_device(x, device):
    """``x`` with every tensor inside dicts, tuples and lists on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return x


def clone(x):
    """A deep copy of tensors inside dataclasses, dicts, tuples and lists."""
    if torch.is_tensor(x):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return {f.name: clone(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    return x


def rel_err(a, b):
    """max |a - b| / (1 + |b|) over every element (inf where a shape or a
    finite value differs); 0 for two empty tensors."""
    if a is None and b is None:
        return 0.0
    if a is None or b is None or tuple(a.shape) != tuple(b.shape):
        return math.inf
    if a.numel() == 0:
        return 0.0
    a, b = a.to(torch.float64), b.to(torch.float64)
    d = (a - b).abs() / (1.0 + b.abs())
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    return float(torch.nan_to_num(d, nan=math.inf).max())


def worst(pairs):
    return max((rel_err(a, b) for a, b in pairs), default=0.0)


class StepCapture:
    """Wraps the program's env step (and the control step it calls) for
    one call: records the pre-step env state, the env generator's state,
    the actions, the control step's inputs and outputs, and the step's
    outputs. ``arm()`` makes the next call the captured one."""

    def __init__(self, env):
        from unitree_rl_gym_tpu_torch.physics import backend as pback

        self.env, self.pback = env, pback
        self.skip, self.data = None, None
        self._step, self._control = env.step, pback.control_step
        env.step = self._wrapped_step
        pback.control_step = self._wrapped_control

    def arm(self, after=0):
        """Capture the call after the next ``after`` calls."""
        self.skip = int(after)

    def remove(self):
        self.env.step = self._step
        self.pback.control_step = self._control

    def _wrapped_control(self, model, cparams, pd, sim_dt, decimation, state,
                         target, friction, mass_scale, m_eff_n, m_eff_t,
                         gh=None, cstiff=None, **kw):
        out = self._control(model, cparams, pd, sim_dt, decimation, state,
                            target, friction, mass_scale, m_eff_n, m_eff_t,
                            gh, cstiff=cstiff, **kw)
        if self.data is not None and "control_out" not in self.data:
            self.data["control_in"] = clone(dict(
                state=state, target=target, friction=friction,
                mass_scale=mass_scale, gh=gh, cstiff=cstiff))
            self.data["control_out"] = clone(out)
        return out

    def _wrapped_step(self, state, actions, *a, **kw):
        if self.skip is None or self.skip > 0:
            if self.skip is not None:
                self.skip -= 1
            return self._step(state, actions, *a, **kw)
        self.skip = None
        self.data = {"pre": clone(state), "gen": self.env.gen.get_state(),
                     "actions": actions.clone(), "args": (a, kw)}
        out = self._step(state, actions, *a, **kw)
        self.data["out"] = clone(out)
        return out


class RefreshCapture:
    """Wraps the program's heightfield window refresh for one call: records
    the state it was given and the state it returned, on the host (so the
    window's device memory stays as it was). ``arm(after)`` makes the call
    after the next ``after`` calls the captured one."""

    def __init__(self, env):
        self.env, self.skip, self.data = env, None, None
        self._refresh = env.refresh_terrain
        env.refresh_terrain = self._wrapped

    def arm(self, after=0):
        self.skip = int(after)

    def remove(self):
        self.env.refresh_terrain = self._refresh

    def _wrapped(self, state):
        if self.skip is None or self.skip > 0:
            if self.skip is not None:
                self.skip -= 1
            return self._refresh(state)
        self.skip = None
        pre = to_device(clone(state), "cpu")
        out = self._refresh(state)
        self.data = {"pre": pre, "out": to_device(clone(out), "cpu")}
        return out


def check_refresh(ref_env, data, lowp=None):
    """The heightfield window refresh (the windows, their corners and the
    staleness flags) against the reference's ``refresh_terrain`` from the
    same state. ``lowp`` (the control): the reference's refresh of the
    state rounded through ``lowp``, its windows rounded too, stands in for
    the program's."""
    pre = to_device(data["pre"], ref_env.device)
    ref = ref_env.refresh_terrain(reference_state(ref_env, pre))
    if lowp is None:
        mine = to_device(data["out"], ref_env.device)
        win, corner, stale = mine["win"], mine["win_corner"], mine["win_stale"]
    else:
        low = dict(pre, phys={k: round_to(v, lowp) for k, v in pre["phys"].items()})
        m = ref_env.refresh_terrain(reference_state(ref_env, low))
        win, corner, stale = round_to(m.win, lowp), m.win_corner, m.win_stale
    return worst([(win, ref.win), (corner, ref.win_corner),
                  (stale.to(torch.float32), ref.win_stale.to(torch.float32))])


def reference_state(ref_env, pre):
    """The reference's EnvState from a captured program state (a dict of
    its fields by name)."""
    from reference.envs.base_env import EnvState
    from reference.physics.engine import PhysicsState

    kw = dict(pre)
    kw["phys"] = PhysicsState(**pre["phys"])
    return EnvState(**kw)


def _phys_pairs(mine, ref):
    return [(mine[k], getattr(ref, k)) for k in ("base_pos", "base_quat",
                                                  "joint_q", "v")]


def round_to(x, dtype):
    """``x`` rounded through ``dtype`` (the comparison's control)."""
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype).to(x.dtype)
    return x


def check_control_step(ref_env, data, lowp=None):
    """The control step's state and aux against the reference's plain
    version on the same inputs. ``lowp`` (the control): the reference's
    own step with its inputs and outputs rounded through ``lowp`` stands in
    for the program's."""
    from reference.physics import backend as rb

    cin = data["control_in"]
    st = cin["state"]

    def run(r=lambda x: x):
        from reference.physics.engine import PhysicsState

        return rb.control_step_soa(
            ref_env.robot.dyn, ref_env.cparams, ref_env.pd, ref_env.cfg.sim.dt,
            ref_env.cfg.control.decimation,
            PhysicsState(**{k: r(v) for k, v in st.items()}), r(cin["target"]),
            r(cin["friction"]), r(cin["mass_scale"]), ref_env.m_eff_n,
            ref_env.m_eff_t, r(cin["gh"]) if cin["gh"] is not None else None,
            cstiff=r(cin["cstiff"]) if cin["cstiff"] is not None else None)

    ref_state, ref_aux = run()
    if lowp is None:
        mine_state, mine_aux = data["control_out"]
    else:
        s, aux = run(lambda x: round_to(x, lowp))
        mine_state = {k: round_to(getattr(s, k), lowp)
                      for k in ("base_pos", "base_quat", "joint_q", "v")}
        mine_aux = {k: round_to(v, lowp) for k, v in aux.items()}
    pairs = _phys_pairs(mine_state, ref_state)
    pairs += [(mine_aux.get(k), v) for k, v in ref_aux.items()]
    return worst(pairs)


def check_env_step(ref_env, data, lowp=None):
    """The env step's obs, privileged obs, rewards, dones and post-step
    physics against the reference env's step from the same state, actions
    and generator state."""
    ref_env.gen.set_state(data["gen"])
    a, kw = data["args"]
    r_state, r_obs, r_priv, r_rew, r_done, _ = ref_env.step(
        reference_state(ref_env, data["pre"]), data["actions"], *a, **kw)
    if lowp is None:
        m_state, m_obs, m_priv, m_rew, m_done, _ = data["out"]
    else:
        m_state = {"phys": {k: round_to(getattr(r_state.phys, k), lowp)
                            for k in ("base_pos", "base_quat", "joint_q", "v")}}
        m_obs, m_rew = round_to(r_obs, lowp), round_to(r_rew, lowp)
        m_priv = None if r_priv is None else round_to(r_priv, lowp)
        m_done = r_done
    pairs = [(m_obs, r_obs), (m_priv, r_priv), (m_rew, r_rew),
             (m_done.to(torch.float32), r_done.to(torch.float32))]
    pairs += _phys_pairs(m_state["phys"], r_state.phys)
    return worst(pairs)


def block_rows(n, rows):
    """Slices of ``n`` rows, ``rows`` at a time."""
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]
