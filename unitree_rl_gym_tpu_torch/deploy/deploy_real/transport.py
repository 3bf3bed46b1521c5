"""Transport abstraction for the real-robot controller (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_real/transport.py``, the same code).

The reference talks DDS directly through unitree_sdk2py
(deploy_real.py:39-64). Here the controller logic is transport-independent:

* :class:`DDSTransport` — the real thing; constructed only when
  unitree_sdk2py is importable (on the robot / jetson).
* :class:`MockTransport` — in-memory loopback with mock LowState/LowCmd
  messages; lets the full state machine + obs assembly + command path run
  in CI and lets tests script remote-controller input.

Both expose: ``low_state`` (latest state), ``new_cmd()``,
``send(cmd)``, ``msg_type``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from unitree_rl_gym_tpu_torch.deploy.deploy_real.common.crc import crc32_bytes
from unitree_rl_gym_tpu_torch.deploy.deploy_real.common.remote_controller import (
    RemoteController,
)

NUM_MOTORS = 35  # hg dialect message size (g1/h1_2); go uses 20 but the
                 # mock keeps one size for simplicity


# ---------------------------------------------------------------------------
# Mock messages (duck-type the unitree_sdk2py IDL surface the code touches)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MockMotorCmd:
    mode: int = 0
    q: float = 0.0
    qd: float = 0.0
    kp: float = 0.0
    kd: float = 0.0
    tau: float = 0.0


@dataclasses.dataclass
class MockMotorState:
    q: float = 0.0
    dq: float = 0.0


class MockIMUState:
    def __init__(self):
        self.quaternion = np.array([1.0, 0.0, 0.0, 0.0])  # wxyz
        self.gyroscope = np.zeros(3)


class MockLowState:
    def __init__(self):
        self.tick = 0
        self.motor_state = [MockMotorState() for _ in range(NUM_MOTORS)]
        self.imu_state = MockIMUState()
        self.wireless_remote = RemoteController.pack()
        self.mode_machine = 0


class MockLowCmd:
    def __init__(self):
        self.motor_cmd = [MockMotorCmd() for _ in range(NUM_MOTORS)]
        self.mode_machine = 0
        self.mode_pr = 0
        self.head = [0, 0]
        self.level_flag = 0
        self.gpio = 0
        self.crc = 0


class MockTransport:
    """Loopback transport: records sent commands, serves a scriptable
    low_state."""

    def __init__(self, msg_type: str = "hg"):
        self.msg_type = msg_type
        self.low_state = MockLowState()
        self.low_state.tick = 1
        self.sent: List[MockLowCmd] = []
        self.mode_machine = 0

    def new_cmd(self):
        return MockLowCmd()

    def send(self, cmd):
        # stamp CRC over the motor command payload like the SDK does
        payload = np.asarray(
            [[m.mode, m.q, m.qd, m.kp, m.kd, m.tau] for m in cmd.motor_cmd],
            dtype=np.float32,
        ).tobytes()
        cmd.crc = crc32_bytes(payload)
        self.sent.append(cmd)

    # test scripting helpers -------------------------------------------------
    def set_buttons(self, buttons: int, lx=0.0, rx=0.0, ry=0.0, ly=0.0):
        self.low_state.wireless_remote = RemoteController.pack(
            buttons, lx=lx, rx=rx, ry=ry, ly=ly
        )

    def set_motors(self, q, dq=None, idx=None):
        idx = idx if idx is not None else range(len(q))
        for j, i in enumerate(idx):
            self.low_state.motor_state[i].q = float(q[j])
            if dq is not None:
                self.low_state.motor_state[i].dq = float(dq[j])


class DDSTransport:
    """Real DDS transport over unitree_sdk2py (import deferred)."""

    def __init__(self, config, net_if: Optional[str] = None):
        from unitree_sdk2py.core.channel import (
            ChannelFactoryInitialize,
            ChannelPublisher,
            ChannelSubscriber,
        )
        from unitree_sdk2py.idl.default import (
            unitree_go_msg_dds__LowCmd_,
            unitree_go_msg_dds__LowState_,
            unitree_hg_msg_dds__LowCmd_,
            unitree_hg_msg_dds__LowState_,
        )
        from unitree_sdk2py.idl.unitree_go.msg.dds_ import (
            LowCmd_ as LowCmdGo,
            LowState_ as LowStateGo,
        )
        from unitree_sdk2py.idl.unitree_hg.msg.dds_ import (
            LowCmd_ as LowCmdHG,
            LowState_ as LowStateHG,
        )
        from unitree_sdk2py.utils.crc import CRC

        if net_if is not None:
            ChannelFactoryInitialize(0, net_if)
        self.msg_type = config.msg_type
        self._crc = CRC()
        self.mode_machine = 0
        if config.msg_type == "hg":
            self._cmd_factory = unitree_hg_msg_dds__LowCmd_
            self.low_state = unitree_hg_msg_dds__LowState_()
            self._pub = ChannelPublisher(config.lowcmd_topic, LowCmdHG)
            self._pub.Init()
            self._sub = ChannelSubscriber(config.lowstate_topic, LowStateHG)
            self._sub.Init(self._on_state_hg, 10)
        elif config.msg_type == "go":
            self._cmd_factory = unitree_go_msg_dds__LowCmd_
            self.low_state = unitree_go_msg_dds__LowState_()
            self._pub = ChannelPublisher(config.lowcmd_topic, LowCmdGo)
            self._pub.Init()
            self._sub = ChannelSubscriber(config.lowstate_topic, LowStateGo)
            self._sub.Init(self._on_state_go, 10)
        else:
            raise ValueError("Invalid msg_type")

    def _on_state_hg(self, msg):
        self.low_state = msg
        self.mode_machine = msg.mode_machine

    def _on_state_go(self, msg):
        self.low_state = msg

    def new_cmd(self):
        return self._cmd_factory()

    def send(self, cmd):
        cmd.crc = self._crc.Crc(cmd)
        self._pub.Write(cmd)
