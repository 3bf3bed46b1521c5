"""The 50 Hz deploy observation layout (counterpart of
``unitree_rl_gym_tpu/deploy/obs_layout.py``, the same table).

The humanoid deploy observation is:

    [ omega*scale (3) | projected gravity (3) | command*scale (3)
    | (q - default)*scale (na) | qd*scale (na) | last action (na)
    | sin(phase), cos(phase) (2, optional) ]

Both Python deploy paths of the port (MuJoCo sim2sim and the real-robot
controller) call :func:`build_obs` / :class:`Segments`, the exporter records
the segment table in ``policy_meta.json``, and :func:`emit_cpp_header`
returns the C++ twin that the C++ controller includes,
``unitree_rl_gym_tpu/deploy/cpp/obs_layout.gen.h``, character for character
(``tests/test_torch_deploy.py`` holds it to the committed file).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

PHASE_PERIOD_S = 0.8  # gait phase clock (g1_env.py:88-95)


@dataclasses.dataclass(frozen=True)
class Segments:
    """Offsets of every segment of the deploy observation vector."""

    num_actions: int
    with_phase: bool = True

    @property
    def ang_vel(self) -> int:
        return 0

    @property
    def gravity(self) -> int:
        return 3

    @property
    def command(self) -> int:
        return 6

    @property
    def dof_pos(self) -> int:
        return 9

    @property
    def dof_vel(self) -> int:
        return 9 + self.num_actions

    @property
    def last_action(self) -> int:
        return 9 + 2 * self.num_actions

    @property
    def phase(self) -> int:
        return 9 + 3 * self.num_actions

    @property
    def num_obs(self) -> int:
        return 9 + 3 * self.num_actions + (2 if self.with_phase else 0)

    def table(self) -> List[Tuple[str, int, int]]:
        t = [
            ("ang_vel", self.ang_vel, 3),
            ("gravity", self.gravity, 3),
            ("command", self.command, 3),
            ("dof_pos", self.dof_pos, self.num_actions),
            ("dof_vel", self.dof_vel, self.num_actions),
            ("last_action", self.last_action, self.num_actions),
        ]
        if self.with_phase:
            t.append(("phase", self.phase, 2))
        return t

    def to_meta(self) -> dict:
        return {
            "num_obs": self.num_obs,
            "phase_period_s": PHASE_PERIOD_S if self.with_phase else None,
            "segments": [
                {"name": n, "offset": o, "size": s} for n, o, s in self.table()
            ],
        }


def layout_for(num_obs: int, num_actions: int) -> Segments:
    """Recover the layout from (num_obs, num_actions) — the two numbers
    every deploy config already carries."""
    for with_phase in (True, False):
        seg = Segments(num_actions, with_phase)
        if seg.num_obs == num_obs:
            return seg
    raise ValueError(
        f"num_obs={num_obs} is not the deploy layout for "
        f"num_actions={num_actions}"
    )


def build_obs(seg: Segments, out: np.ndarray, *, ang_vel, gravity, command,
              dof_pos, dof_vel, last_action, phase_t: float = 0.0):
    """Fill ``out`` (shape [seg.num_obs]) in place. All inputs are expected
    pre-scaled (each call site owns its sensor scaling; this owns ONLY the
    ordering/offsets and the phase clock)."""
    na = seg.num_actions
    out[seg.ang_vel:seg.ang_vel + 3] = ang_vel
    out[seg.gravity:seg.gravity + 3] = gravity
    out[seg.command:seg.command + 3] = command
    out[seg.dof_pos:seg.dof_pos + na] = dof_pos
    out[seg.dof_vel:seg.dof_vel + na] = dof_vel
    out[seg.last_action:seg.last_action + na] = last_action
    if seg.with_phase:
        phase = (phase_t % PHASE_PERIOD_S) / PHASE_PERIOD_S
        out[seg.phase] = np.sin(2 * np.pi * phase)
        out[seg.phase + 1] = np.cos(2 * np.pi * phase)
    return out


def emit_cpp_header() -> str:
    """C++ twin of :class:`Segments` (included by deploy/cpp/controller.cpp).

    The committed header was generated from the JAX package's copy of this
    table; print this one with
    ``python -m unitree_rl_gym_tpu_torch.deploy.obs_layout``.
    """
    return """\
// GENERATED by unitree_rl_gym_tpu/deploy/obs_layout.py — do not edit.
// Single source of truth for the 50 Hz deploy observation layout.
#pragma once

namespace utrl {

struct ObsLayout {
  int num_actions;
  bool with_phase;

  static constexpr float kPhasePeriodS = 0.8f;

  int ang_vel() const { return 0; }
  int gravity() const { return 3; }
  int command() const { return 6; }
  int dof_pos() const { return 9; }
  int dof_vel() const { return 9 + num_actions; }
  int last_action() const { return 9 + 2 * num_actions; }
  int phase() const { return 9 + 3 * num_actions; }
  int num_obs() const { return 9 + 3 * num_actions + (with_phase ? 2 : 0); }
};

}  // namespace utrl
"""


if __name__ == "__main__":
    print(emit_cpp_header(), end="")
