"""Minimal TensorBoard event-file writer (scalars), dependency-free.

TensorBoard-compatible counterpart of the reference's `TensorboardXWriter`
(`pointcept/utils/events.py:293-593`) without the tensorboardX dependency,
the port's own copy of `cdsegnet_tpu/utils/tbwriter.py`:
encodes `Event`/`Summary` protobuf messages and the TFRecord framing
(length + masked crc32c) by hand. The JAX copy is verified against
TensorBoard's own event-file loader in `tests/test_events.py`; this one
writes the same records (`tests/test_torch_trainer.py`).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(tag: int, payload: bytes) -> bytes:
    # wire type 2 (length-delimited)
    return _varint((tag << 3) | 2) + _varint(len(payload)) + payload


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    v = _field_bytes(1, tag.encode())
    v += bytes([0x15]) + struct.pack("<f", value)  # field 2, wire type 5
    # Summary { value = 1 (repeated message) }
    return _field_bytes(1, v)


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    # Event { wall_time = 1 (double); step = 2 (int64); ... }
    e = bytes([0x09]) + struct.pack("<d", wall_time)  # field 1, wire type 1
    e += bytes([0x10]) + _varint(step)  # field 2, varint
    return e + body


class TBWriter:
    """Append-only scalar event writer; one file per run directory."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}"
        )
        self._f = open(os.path.join(logdir, fname), "ab")
        # header event: file_version = field 3 (string)
        self._write(
            _event(time.time(), 0, _field_bytes(3, b"brain.Event:2"))
        )

    def _write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None):
        body = _field_bytes(5, _scalar_summary(tag, float(value)))
        self._write(_event(wall_time or time.time(), int(step), body))

    def close(self):
        self._f.close()
