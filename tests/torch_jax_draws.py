"""The JAX env step's random draws, handed to the port's env step, so that the
two packages can be compared past resets, pushes and observation noise.

The JAX ``LeggedEnv.step`` splits ``state.key`` into ``k_cmd, k_push,
k_reset, k_noise, k_lvl`` (``unitree_rl_gym_tpu/envs/base_env.py``) and
draws from each; the handstand's ``_sample_reset`` draws its RSI from
``fold_in(k_reset, 17)`` and its step flips contact flags from the next
key. :func:`step_draws` recomputes every one of those draws from the
step's key, in the order in which the port's step makes its draws, as the
numbers the port's ``LeggedEnv._env_draw`` returns: uniforms in [0, 1)
(``jax.random.uniform(k, shape, lo, hi)`` is ``lo + (hi - lo) * u`` of the
same ``u``, as the port's ``_rand`` scales it) and integers.
:class:`Injected` then stands in for the port env's ``_env_draw``, so the
port takes those draws instead of its generator's; nothing in either
package changes."""

import jax
import numpy as np
import torch

from unitree_rl_gym_tpu.envs.go2_handstand import CONTACT_FLIP_P
from unitree_rl_gym_tpu.envs.go2_handstand import GO2HandstandEnv as JaxHandstand


def _commands(key, n):
    kx, ky, kz = jax.random.split(key, 3)
    return [jax.random.uniform(k, (n,)) for k in (kx, ky, kz)]


def step_draws(jenv, key):
    """(the draws of one JAX ``jenv.step`` from ``state.key == key``, in the
    port's order; the state's key after the step). Traceable."""
    cfg, n, nj = jenv.cfg, jenv.num_envs, jenv.robot.num_dof
    u = jax.random.uniform
    key, k_cmd, k_push, k_reset, k_noise, k_lvl = jax.random.split(key, 6)
    out = _commands(k_cmd, n)
    if jenv.terrain is not None and cfg.terrain.curriculum:
        out.append(jax.random.randint(k_lvl, (n,), 0, cfg.terrain.num_rows))
    k1, k2, k3, k4 = jax.random.split(k_reset, 4)
    out += [u(k1, (n, nj)), u(k2, (n, 6))]
    if jenv.terrain is not None:
        out.append(u(k4, (n, 2)))
    out += _commands(k3, n)
    handstand = isinstance(jenv, JaxHandstand)
    if handstand:
        k_sel, k_th, k_yaw, k_q, k_h, k_mid, k_w = jax.random.split(
            jax.random.fold_in(k_reset, 17), 7)
        out += [u(k_sel, (n,)), u(k_mid, (n,)), u(k_th, (n,)),
                u(jax.random.fold_in(k_th, 1), (n,)), u(k_yaw, (n,)),
                u(k_q, (n, nj)), u(jax.random.fold_in(k_h, 1), (n,)),
                u(k_w, (n,)), u(jax.random.fold_in(k_w, 1), (n,))]
    if cfg.domain_rand.push_robots:
        out.append(u(k_push, (n, 2)))
    if cfg.noise.add_noise:
        out.append(u(k_noise, (n, jenv.num_obs)))
        if handstand and CONTACT_FLIP_P > 0:
            key, k = jax.random.split(key)
            out.append(u(k, (n, 4)))
    return out, key


def step_draws_fn(jenv):
    """Jitted :func:`step_draws` of ``jenv``: key -> (numpy draws, key)."""
    fn = jax.jit(lambda key: step_draws(jenv, key))

    def draws(key):
        out, key = fn(key)
        return [np.asarray(x) for x in out], key

    return draws


class Injected:
    """Replaces ``tenv._env_draw``: each draw the port's step makes takes
    the next array of :meth:`feed` (its shape checked) instead of one from
    the env's generator. ``count`` is the number of draws taken."""

    def __init__(self, tenv):
        self.queue = []
        self.count = 0
        self.device = tenv.device
        tenv._env_draw = self

    def feed(self, draws):
        self.queue.extend(draws)

    def __call__(self, draw, n, *rest):
        assert self.queue, "the port's step drew more than the JAX step"
        x = self.queue.pop(0)
        assert x.shape == (n,) + rest, (x.shape, (n,) + rest)
        self.count += 1
        t = torch.from_numpy(np.array(x))
        return (t.to(torch.int64) if t.dtype == torch.int32 else t).to(self.device)

    def done(self):
        """Every fed draw was taken."""
        assert not self.queue, f"{len(self.queue)} JAX draws not taken"
