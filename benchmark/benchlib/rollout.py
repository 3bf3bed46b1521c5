"""The ``rollout`` mode: the shipped policy acting on the task's training
env, the window driving the play loop (the policy's ``act``, then
``LeggedEnv.step``), as ``scripts/play.py::rollout`` runs it, with an LSTM
policy's carry running through every step.

Set-up loads the policy from ``resources/pre_train/<task>`` (the program
with its own loader, the reference with its own), resets and runs
``warmup_steps`` steps of the same loop. Its first step (the carry at
zero) and its last (policy, env step and the control step inside it) are
captured for the reference.
"""

import time

import torch

from benchlib import common as C
from benchlib import counts as K


class PolicyCapture:
    """Records the policy's inputs and outputs at the calls given."""

    def __init__(self, policy):
        self.policy, self.at, self.n, self.d = policy, set(), 0, []
        self._act = policy.act
        policy.act = self._wrapped

    def _wrapped(self, obs, *carry):
        out = self._act(obs, *carry)
        if self.n in self.at:
            self.d.append((obs.clone(), C.clone(carry), C.clone(out)))
        self.n += 1
        return out

    def remove(self):
        del self.policy.act


def _policy_path(ctx):
    from reference import resource

    return resource(ctx["traffic"]["policy_dir"].format(task=ctx["config"]["task"]))


def setup(ctx):
    from unitree_rl_gym_tpu_torch.models.networks import load_flat_policy

    dev, seed, n = ctx["device"], ctx["seed"], ctx["num_envs"]
    env, _ = C.program_env(ctx["config"], ctx["traffic"], n, seed, dev)
    policy = load_flat_policy(_policy_path(ctx), env.device)
    state, obs = env.reset_all()
    carry = policy.initial_carry(n) if policy.is_recurrent else None
    warm = int(ctx["traffic"].get("warmup_steps", 100))
    pcap = PolicyCapture(policy)
    pcap.at = {0, warm - 1}
    scap = C.StepCapture(env)
    scap.arm(after=warm - 1)
    s = dict(env=env, policy=policy, state=state, obs=obs, carry=carry, N=n)
    _loop(s, warm)
    pcap.remove()
    scap.remove()
    C.sync(env.device)
    s.update(policy_calls=pcap.d, step=scap.data)
    return s


@torch.no_grad()
def _loop(s, steps, until=None):
    env, policy = s["env"], s["policy"]
    state, obs, carry = s["state"], s["obs"], s["carry"]
    t0, i = time.perf_counter(), 0
    while True:
        if carry is None:
            actions = policy.act(obs)
        else:
            actions, carry = policy.act(obs, carry)
        state, obs, _, _, _, _ = env.step(state, actions)
        i += 1
        if until is None:
            if i >= steps:
                break
        elif time.perf_counter() - t0 >= until:
            break
    s.update(state=state, obs=obs, carry=carry)
    return i


def window(ctx, s, seconds, log):
    C.sync(s["env"].device)
    t0 = time.perf_counter()
    steps = _loop(s, None, until=seconds)
    C.sync(s["env"].device)
    w = time.perf_counter() - t0
    log(f"rollout steps: {steps}, host ms a step: {w / steps * 1e3:.3f}")
    return dict(steps=steps, window_s=w, env_steps=steps * s["N"],
                control_steps=steps)


def work(ctx, s, ref_env, run):
    from reference.physics.backend import soa_model_for

    import json

    from reference import policy as P

    cfg = ref_env.cfg
    m = soa_model_for(ref_env.robot.dyn)
    terrain = cfg.terrain.mesh_type in ("heightfield", "trimesh")
    cs = bool(cfg.domain_rand.randomize_contact_stiffness)
    params = P.from_flat(_policy_path(ctx) + "/policy_flat.npz", "cpu")
    with open(_policy_path(ctx) + "/policy_meta.json") as f:
        meta = json.load(f)
    actor = [w.shape for w, _ in params["actor"]]
    fwd = K.mlp_flops(actor[0][1], [o for o, _ in actor[:-1]], actor[-1][0])
    for w_ih, w_hh, _ in params.get("memory_a", []):
        fwd += K.lstm_flops(w_ih.shape[1], w_hh.shape[1])
    return dict(
        step_flops=s["N"] * K.flops_per_env(m, cfg.control.decimation,
                                            cfg.sim.contact_iterations,
                                            terrain, cs),
        step_bytes=s["N"] * K.bytes_per_env(m, terrain, cs),
        net_flops=run["steps"] * s["N"] * fwd,
        net_precision=meta.get("dtype", "float32"),
    )


def check(ctx, s, ref_env, control=False):
    from reference import policy as P

    dev = ctx["device"]
    params = P.from_flat(_policy_path(ctx) + "/policy_flat.npz", dev)
    recurrent = "memory_a" in params
    quant = "tf32" if control else None
    err = 0.0
    with torch.no_grad():
        for obs, carry, out in s["policy_calls"]:
            if recurrent:
                ref = P.act_recurrent(params, obs, carry[0])
                mine = (P.act_recurrent(params, obs, carry[0], quant=quant)
                        if control else out)
                err = max(err, C.worst(zip(mine, ref)))
            else:
                ref = P.mlp(params["actor"], obs, torch.float32)
                mine = P.mlp(params["actor"], obs, torch.float32, quant) if control else out
                err = max(err, C.rel_err(mine, ref))
    lowp = torch.bfloat16 if control else None
    return {"control_step_err": C.check_control_step(ref_env, s["step"], lowp),
            "env_step_err": C.check_env_step(ref_env, s["step"], lowp),
            "policy_err": err}
