"""In-sim visualization: replay the port's env rollouts in MuJoCo
(counterpart of ``unitree_rl_gym_tpu/utils/viz.py``).

Rendering stays out of the env step: a host-side replayer mirrors env 0's
kinematic state (base pose + joint angles) into a MuJoCo model each control
step; MuJoCo is already the deploy and validation oracle, so the same MJCF
scenes double as the visualization assets. Reading the state back is a
host sync per step, so only ``scripts/play.py --view`` pays it.

Scene resolution:
  * humanoids (g1/h1/h1_2): the deploy ``scene.xml`` next to the robot MJCF
  * anything else (go2, go2_handstand): the training URDF is wrapped via
    ``mujoco.MjSpec`` — freejoint added to the root, plane added to the
    world — so every robot with a URDF is viewable with zero extra assets.

Works headless: with ``viewer=False`` the replayer only runs
``mj_forward``; with a display it opens the passive viewer. ``mujoco`` is
imported by the functions that use it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from unitree_rl_gym_tpu_torch import UNITREE_RL_GYM_TPU_ROOT_DIR

# deploy scenes reused as visualization scenes
_SCENES = {
    "g1": "resources/robots/g1_description/scene.xml",
    "h1": "resources/robots/h1/scene.xml",
    "h1_2": "resources/robots/h1_2/scene.xml",
}


def _xyzw_to_wxyz(q):
    q = np.asarray(q)
    return np.concatenate((q[..., 3:4], q[..., :3]), axis=-1)


def load_view_model(task_name: str, env):
    """Build ``(MjModel, qpos_addr)`` for replaying ``env`` states.

    ``qpos_addr[i]`` is the MuJoCo qpos address of env DoF ``i`` (mapped by
    joint name so MJCF/URDF joint ordering never has to match the env's).
    The model is guaranteed to start with a freejoint (qpos[0:7] = base
    pos + wxyz quat).
    """
    import mujoco

    base = task_name.split("_handstand")[0]
    scene = _SCENES.get(base)
    if scene is not None:
        m = mujoco.MjModel.from_xml_path(
            os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, scene)
        )
    else:
        urdf = os.path.join(UNITREE_RL_GYM_TPU_ROOT_DIR, env.cfg.asset.file)
        spec = mujoco.MjSpec.from_file(urdf)
        spec.worldbody.first_body().add_freejoint()
        spec.worldbody.add_geom(
            type=mujoco.mjtGeom.mjGEOM_PLANE, size=[0, 0, 1],
            rgba=[0.85, 0.85, 0.85, 1.0],
        )
        m = spec.compile()

    if m.jnt_type[0] != mujoco.mjtJoint.mjJNT_FREE:
        raise ValueError(f"view model for {task_name} has no freejoint base")

    qpos_addr = np.zeros(env.num_actions, dtype=np.int64)
    mj_names = {m.joint(j).name: j for j in range(m.njnt)}
    for i, name in enumerate(env.robot.dof_names):
        if name not in mj_names:
            raise KeyError(
                f"env joint {name!r} not in view model "
                f"(has {sorted(mj_names)})"
            )
        qpos_addr[i] = m.jnt_qposadr[mj_names[name]]
    return m, qpos_addr


class RolloutViewer:
    """Mirror one env's state into MuJoCo, optionally in a passive viewer.

    Usage::

        rv = RolloutViewer("go2", env, realtime=env_cfg.env.test)
        for ...:
            state, obs, ... = env.step(state, actions)
            rv.update(state)
        rv.close()
    """

    def __init__(self, task_name: str, env, env_index: int = 0,
                 realtime: bool = True, viewer: Optional[bool] = None):
        import mujoco

        self._mujoco = mujoco
        self.model, self.qpos_addr = load_view_model(task_name, env)
        self.data = mujoco.MjData(self.model)
        self.env_index = env_index
        self.dt = float(env.dt)
        self.realtime = realtime
        self._next_frame = None
        self.viewer = None
        # reference viewer key events (base_task.py:91-115): ESC = QUIT,
        # V = toggle_viewer_sync (sim keeps running, rendering freezes)
        self._quit_requested = False
        self._sync_enabled = True
        if viewer is None:
            viewer = bool(os.environ.get("DISPLAY"))
        if viewer:
            import mujoco.viewer

            def _on_key(keycode):
                if keycode == 256:                  # ESC
                    self._quit_requested = True
                elif keycode in (ord("V"), ord("v")):
                    self._sync_enabled = not self._sync_enabled

            self.viewer = mujoco.viewer.launch_passive(
                self.model, self.data, key_callback=_on_key
            )

    def set_frame(self, base_pos, base_quat_xyzw, joint_q):
        d = self.data
        d.qpos[0:3] = np.asarray(base_pos)
        d.qpos[3:7] = _xyzw_to_wxyz(base_quat_xyzw)
        d.qpos[self.qpos_addr] = np.asarray(joint_q)
        self._mujoco.mj_forward(self.model, d)

    def update(self, env_state) -> bool:
        """Show the current state of env ``env_index``. Returns False once
        the viewer window has been closed (callers should stop looping)."""
        i = self.env_index
        phys = env_state.phys
        self.set_frame(*(t[i].cpu().numpy() for t in
                         (phys.base_pos, phys.base_quat, phys.joint_q)))
        if self.viewer is not None:
            if self._quit_requested or not self.viewer.is_running():
                return False
            if self._sync_enabled:
                self.viewer.sync()
        if self.realtime:
            # test-mode wall-clock pacing (legged_robot.py:631-635)
            now = time.time()
            if self._next_frame is not None:
                left = self._next_frame - now
                if left > 0:
                    time.sleep(left)
                    now = self._next_frame
            self._next_frame = now + self.dt
        return True

    def close(self):
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None
