"""The port's CLI and play loop against the JAX package's rules, on the CPU;
no JAX program is compiled.

  * ``utils/helpers.py::get_args`` accepts every option of the JAX
    package's parser (``unitree_rl_gym_tpu/utils/helpers.py``) but the
    JAX-only ``--platform`` and ``--host_devices``, with the same action,
    type and default, so a command line of the reference (``--headless``
    included) parses in the port to the same values;
  * ``scripts/play.py::rollout`` logs tracking errors, base height and
    falls at the steps ``i > settle`` and averages over the steps it
    logged, as the JAX play's loop does (``i > NUM_STEPS // 5``, its
    ``Logger`` averaging what it logged), also when a viewer ends the
    loop early. A stub env makes every step's numbers known in advance.
"""

import argparse
import types

import numpy as np
import pytest
import torch

from unitree_rl_gym_tpu.utils import helpers as jax_helpers
from unitree_rl_gym_tpu.utils.logger import Logger as JaxLogger
from unitree_rl_gym_tpu_torch.scripts import play
from unitree_rl_gym_tpu_torch.utils import helpers

JAX_ONLY = {"--platform", "--host_devices"}


def _parser(get_args, monkeypatch):
    """The ArgumentParser that ``get_args`` builds."""
    seen = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen.append(self)
        return parse(self, args, namespace)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", spy)
        get_args([])
    return seen[0]


def _options(parser):
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


def test_port_parser_takes_every_jax_option(monkeypatch):
    jax_opts = _options(_parser(jax_helpers.get_args, monkeypatch))
    port_opts = _options(_parser(helpers.get_args, monkeypatch))
    assert JAX_ONLY <= set(jax_opts)
    missing = set(jax_opts) - JAX_ONLY - set(port_opts)
    assert not missing, missing
    for name in set(jax_opts) - JAX_ONLY:
        j, t = jax_opts[name], port_opts[name]
        assert type(j) is type(t), name
        assert (j.type, j.default, j.dest) == (t.type, t.default, t.dest), name


def test_reference_command_lines_parse_alike():
    for argv in (["--task", "go2", "--headless"],
                 ["--task=g1", "--num_envs=8", "--seed=3", "--max_iterations=2",
                  "--headless", "--resume", "--experiment_name=e",
                  "--run_name=r", "--load_run=x", "--checkpoint=5", "--view"]):
        j, t = jax_helpers.get_args(argv), helpers.get_args(argv)
        for k, v in vars(j).items():
            if "--" + k not in JAX_ONLY:
                assert getattr(t, k) == v, (argv, k)
    assert helpers.get_args(["--task", "go2", "--headless"]).headless


# ---------------------------------------------------------------------------
# play's statistics window
# ---------------------------------------------------------------------------

N_ENVS = 3


class StubEnv:
    """Step i (counted from 0) puts base vx = i + 1 under a zero command, a
    yaw rate of 2 (i + 1), a base height of 10 (i + 1), and ends env 0's
    episode by a fall and env 1's by a time-out."""

    device = torch.device("cpu")
    num_envs = N_ENVS
    episode_term_names = ["a", "b"]

    def __init__(self):
        self.i = 0

    def step(self, state, actions):
        k = float(self.i + 1)
        self.i += 1
        v = torch.zeros(N_ENVS, 18)
        v[:, 3] = k
        v[:, 2] = 2.0 * k
        phys = types.SimpleNamespace(v=v, base_pos=torch.full((N_ENVS, 3), 10.0 * k))
        state = types.SimpleNamespace(phys=phys, commands=torch.zeros(N_ENVS, 4))
        done = torch.tensor([True, True, False])
        extras = {"episode_sums_at_reset": torch.ones(2),
                  "episode_reset_count": torch.tensor(2),
                  "time_outs": torch.tensor([False, True, False])}
        return state, None, None, torch.zeros(N_ENVS), done, extras


class StubPolicy:
    is_recurrent = False

    @staticmethod
    def act(obs):
        return torch.zeros(N_ENVS, 12)


class StopAt:
    """A viewer whose window closes at step ``k`` (its update returns
    False there), as ``RolloutViewer.update`` does."""

    def __init__(self, k):
        self.k, self.i = k, 0

    def update(self, state):
        self.i += 1
        return self.i <= self.k


def _jax_rule(num_steps, stop=None):
    """The JAX play's loop (``unitree_rl_gym_tpu/scripts/play.py``) on the
    stub's numbers: it breaks when the viewer closes, logs the steps
    ``i > num_steps // 5`` through its Logger, and counts falls there."""
    log, falls = JaxLogger(0.02), 0
    for i in range(num_steps):
        if stop is not None and i >= stop:
            break
        if i > num_steps // 5:
            k = i + 1.0
            log.log_states({"abs_vx_tracking_err": k, "abs_vy_tracking_err": 0.0,
                            "abs_yaw_rate_err": 2.0 * k, "base_height": 10.0 * k})
            falls += 1
    return {k: float(np.mean(v)) for k, v in log.state_log.items()}, falls, \
        len(log.state_log["base_height"])


@pytest.mark.parametrize("num_steps,stop", [(500, None), (500, 150), (13, None),
                                            (13, 7)])
def test_play_logs_the_reference_window(num_steps, stop):
    viewer = None if stop is None else StopAt(stop)
    _, _, stats = play.rollout(StubEnv(), StubPolicy(), None, None, num_steps,
                               settle=num_steps // 5, viewer=viewer)
    want, falls, n_logged = _jax_rule(num_steps, stop)
    assert n_logged > 0
    assert stats["falls"] == falls == n_logged
    for k, v in want.items():
        assert stats[k] == pytest.approx(v, rel=1e-6), k
