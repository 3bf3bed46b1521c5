"""Unitree wireless-remote bitfield parser (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_real/common/remote_controller.py``, the
same code; reference:
deploy_real/common/remote_controller.py — the layout is the SDK's wire
protocol: 16 button bits at bytes 2-4, float axes lx@4 rx@8 ry@12 ly@20)."""

from __future__ import annotations

import struct


class KeyMap:
    R1 = 0
    L1 = 1
    start = 2
    select = 3
    R2 = 4
    L2 = 5
    F1 = 6
    F2 = 7
    A = 8
    B = 9
    X = 10
    Y = 11
    up = 12
    right = 13
    down = 14
    left = 15


class RemoteController:
    def __init__(self):
        self.lx = 0.0
        self.ly = 0.0
        self.rx = 0.0
        self.ry = 0.0
        self.button = [0] * 16

    def set(self, data: bytes):
        keys = struct.unpack("H", data[2:4])[0]
        for i in range(16):
            self.button[i] = (keys >> i) & 1
        self.lx = struct.unpack("f", data[4:8])[0]
        self.rx = struct.unpack("f", data[8:12])[0]
        self.ry = struct.unpack("f", data[12:16])[0]
        self.ly = struct.unpack("f", data[20:24])[0]

    @staticmethod
    def pack(buttons=0, lx=0.0, rx=0.0, ry=0.0, ly=0.0) -> bytes:
        """Inverse of set() — used by the mock transport in tests."""
        buf = bytearray(40)
        struct.pack_into("H", buf, 2, buttons)
        struct.pack_into("f", buf, 4, lx)
        struct.pack_into("f", buf, 8, rx)
        struct.pack_into("f", buf, 12, ry)
        struct.pack_into("f", buf, 20, ly)
        return bytes(buf)
