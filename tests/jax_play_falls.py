"""The JAX package's own play of a shipped LSTM policy on the CPU, counted
as chip_smoke.py's ``play_humanoid`` phase counts the port's: the
non-timeout terminations after the first third of the steps, over the
envs. chip_smoke.py's health bar for the humanoids is go2's (at most 1% of
the envs) unless the reference itself misses it here, and PERF.md records
both rates.

    python tests/jax_play_falls.py --task=h1_2 [--num_envs=64] [--steps=400]

The env is ``scripts/play.py``'s (noise, friction DR and pushes off); the
policy is ``resources/pre_train/<task>/policy_flat.npz`` under the JAX
package's ``ActorCriticRecurrent``, its carry held across every step with
no per-env reset, as ``OnPolicyRunner.get_inference_policy`` does. Prints
one JSON line.
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax.numpy as jnp

    from unitree_rl_gym_tpu import UNITREE_RL_GYM_TPU_ROOT_DIR
    from unitree_rl_gym_tpu.envs.registry import task_registry
    from unitree_rl_gym_tpu.export.export import load_flat_params
    from unitree_rl_gym_tpu.models import networks as nets

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True)
    ap.add_argument("--num_envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args()

    cfg, tcfg = task_registry.get_cfgs(args.task)
    cfg.env.num_envs = args.num_envs
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_contact_stiffness = False
    cfg.env.test = True
    env = task_registry.get_task_class(args.task)(cfg)
    path = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, "resources", "pre_train",
                        args.task)
    with open(os.path.join(path, "policy_meta.json")) as f:
        meta = json.load(f)
    net = nets.ActorCriticRecurrent(
        num_actions=meta["num_actions"],
        actor_hidden_dims=tuple(meta["actor_hidden_dims"]),
        rnn_hidden_size=meta["rnn_hidden_size"],
        rnn_num_layers=meta["rnn_num_layers"], dtype="float32")
    params = load_flat_params(path)
    act = jax.jit(lambda c, o: net.apply(params, o, c, method=net.act))
    step = jax.jit(env.step)
    state, obs = env.reset_all(jax.random.PRNGKey(0))
    carry = net.initial_carry(args.num_envs)
    settle = args.steps // 3
    falls = 0
    for i in range(args.steps):
        mu, carry = act(carry, obs)
        state, obs, _, _, done, extras = step(state, mu)
        if i >= settle:
            falls += int(jnp.sum(done & ~extras["time_outs"]))
    print(json.dumps({"task": args.task, "num_envs": args.num_envs,
                      "steps": args.steps, "settle": settle, "falls": falls,
                      "fall_rate": falls / args.num_envs}), flush=True)


if __name__ == "__main__":
    main()
