"""LowCmd builders (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_real/common/command_helper.py``, the
same code; reference: deploy_real/common/command_helper.py).

Operate duck-typed on any cmd object exposing ``motor_cmd[i].{mode,q,qd,
kp,kd,tau}`` — real unitree_sdk2py IDL messages or the mock messages used
in tests. Semantics preserved: damping = kd 8 everywhere; go-dialect init
uses PosStopF/VelStopF sentinels and weak-motor mode bits."""

from __future__ import annotations


class MotorMode:
    PR = 0  # series control for pitch/roll joints
    AB = 1  # parallel control for A/B joints


def create_damping_cmd(cmd):
    for mc in cmd.motor_cmd:
        mc.q = 0
        mc.qd = 0
        mc.kp = 0
        mc.kd = 8
        mc.tau = 0


def create_zero_cmd(cmd):
    for mc in cmd.motor_cmd:
        mc.q = 0
        mc.qd = 0
        mc.kp = 0
        mc.kd = 0
        mc.tau = 0


def init_cmd_hg(cmd, mode_machine: int, mode_pr: int):
    cmd.mode_machine = mode_machine
    cmd.mode_pr = mode_pr
    for mc in cmd.motor_cmd:
        mc.mode = 1
        mc.q = 0
        mc.qd = 0
        mc.kp = 0
        mc.kd = 0
        mc.tau = 0


def init_cmd_go(cmd, weak_motor):
    cmd.head[0] = 0xFE
    cmd.head[1] = 0xEF
    cmd.level_flag = 0xFF
    cmd.gpio = 0
    PosStopF = 2.146e9
    VelStopF = 16000.0
    for i, mc in enumerate(cmd.motor_cmd):
        mc.mode = 1 if i in weak_motor else 0x0A
        mc.q = PosStopF
        mc.qd = VelStopF
        mc.kp = 0
        mc.kd = 0
        mc.tau = 0
