"""Port parity of the humanoid env for h1_2 (``H1_2Env``: 56 report
bodies, 20 contact points, sim dt 0.0025), by the checks of
tests/test_torch_env_humanoid.py (g1): the PyTorch step against the JAX
package's at N=8 and decimation 1, through two envs' resets, each env
compared up to its reset at atol 5e-5 / rtol 1e-4 (``done`` exactly), and
at its reset step the phase it observes, its episode length and the
buffers a reset zeroes. One JAX ``reset_all`` and one jitted ``env.step``
are compiled, in the module-scope fixture every case shares."""

import pytest

from tests.test_torch_env_humanoid import (
    check_done, check_output, check_physics, check_reset_step,
    check_resets_reached, check_term, humanoid_traces,
)


@pytest.fixture(scope="module")
def traces():
    return humanoid_traces("h1_2")


def test_resets_reached(traces):
    check_resets_reached(traces[1])


def test_done_matches(traces):
    check_done(traces[1])


@pytest.mark.parametrize("field", ["base_pos", "base_quat", "joint_q", "v"])
def test_physics_state_matches(traces, field):
    check_physics(traces[1], field)


@pytest.mark.parametrize("what", ["obs", "priv_obs", "reward", "commands"])
def test_env_outputs_match(traces, what):
    check_output(traces[1], what)


@pytest.mark.parametrize("term", [
    "tracking_lin_vel", "tracking_ang_vel", "lin_vel_z", "ang_vel_xy",
    "orientation", "base_height", "dof_acc", "dof_vel", "action_rate",
    "dof_pos_limits", "alive", "hip_pos", "contact_no_vel",
    "feet_swing_height", "contact"])
def test_reward_term_matches(traces, term):
    check_term(*traces, term)


def test_reset_env_observes_pre_reset_phase(traces):
    check_reset_step(*traces)
