"""TensorBoard scalars in TensorBoard's own file format, standard library only.

The port's copy of the scalar part of the JAX package's ``utils/tb_native.py``:
TFRecord framing (``uint64 length | masked crc32c(length) | payload | masked
crc32c(payload)``, Castagnoli CRC with TensorFlow's rotate-and-add mask) around
hand-encoded ``Event`` / ``Summary`` protobufs. ``NativeTBWriter`` writes
``events.out.tfevents.<time>.<host>.<pid>.0`` into a run's directory; the
trainer logs its ``train/``, ``val/`` and ``test/`` scalars through it.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    n &= 0xFFFFFFFFFFFFFFFF  # int64 two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(step: Optional[int] = None, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    out = _f_double(1, time.time())
    if step is not None:
        out += _f_varint(2, int(step))
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    return _f_bytes(1, val)  # Summary.value (repeated field 1)


class NativeTBWriter:
    """``add_scalar``, ``flush`` and ``close`` of ``SummaryWriter``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}.0"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write(_event(file_version="brain.Event:2"))
        self.flush()

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", masked_crc(header))
                      + payload + struct.pack("<I", masked_crc(payload)))

    def add_scalar(self, tag: str, value, global_step: Optional[int] = None) -> None:
        self._write(_event(step=global_step, summary=_scalar_summary(tag, float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
