"""CRC32 for Unitree low-level commands (counterpart of
``unitree_rl_gym_tpu/deploy/deploy_real/common/crc.py``, the same code).

Bitwise CRC over 32-bit words with polynomial 0x04C11DB7, init 0xFFFFFFFF
— the algorithm the Unitree SDK stamps LowCmd messages with (C++ reference:
cpp_g1/utilities.cpp:3-32 implements the same word-wise loop). Used by the
mock transport and validated against the C++ deploy implementation."""

from __future__ import annotations

import numpy as np

_POLY = 0x04C11DB7


def crc32_words(words) -> int:
    """CRC over a sequence of uint32 words (MSB-first, no reflection)."""
    crc = 0xFFFFFFFF
    for w in words:
        w = int(w) & 0xFFFFFFFF
        for bit in range(31, -1, -1):
            top = (crc >> 31) & 1
            crc = (crc << 1) & 0xFFFFFFFF
            if top ^ ((w >> bit) & 1):
                crc ^= _POLY
    return crc


def crc32_bytes(data: bytes) -> int:
    """CRC over a byte buffer, zero-padded to a word multiple,
    little-endian word packing (matching the C++ struct memory layout)."""
    pad = (-len(data)) % 4
    buf = data + b"\x00" * pad
    words = np.frombuffer(buf, dtype="<u4")
    return crc32_words(words)
