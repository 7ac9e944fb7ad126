"""Pure-python TensorBoard event-file writer (the port's copy of
multi_modal_image_fusion_tpu utils/tbevents.py; no tensorboard dependency).

The reference always writes TensorBoard events (reference train.py:167,
100-110, 355-356 via torch.utils.tensorboard.SummaryWriter); this module
covers that contract without the tensorboard package: it emits the TFRecord
framing (length + masked-crc32c records) and hand-encodes the two tiny
protobuf messages TensorBoard needs for scalars:

    Event    { double wall_time = 1; int64 step = 2;
               oneof { string file_version = 3; Summary summary = 5; } }
    Summary  { repeated Value value = 1; }
    Value    { string tag = 1; float simple_value = 2; }

Files produced here load in stock TensorBoard (round-tripped against
tensorboard's own EventFileLoader in tests/test_utils.py for the JAX
package's copy, and against that copy in tests/test_torch_train_cli.py).
"""

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — table-driven, pure python
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    """TFRecord's masked crc: rotate right 15 and add a constant."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field, wire_type):
    return _varint(field << 3 | wire_type)


def _f64(field, v):
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field, v):
    return _key(field, 5) + struct.pack("<f", v)


def _i64(field, v):
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field, data):
    return _key(field, 2) + _varint(len(data)) + data


def _scalar_event(tag, value, step, wall_time):
    value_msg = _bytes(1, tag.encode()) + _f32(2, float(value))
    summary = _bytes(1, value_msg)
    return _f64(1, wall_time) + _i64(2, int(step)) + _bytes(5, summary)


def _version_event(wall_time):
    return _f64(1, wall_time) + _bytes(3, b"brain.Event:2")


class TFEventWriter:
    """Append-mode scalar event writer, API-compatible with the slice of
    SummaryWriter the trainer uses (add_scalar/flush/close)."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            time.time(), socket.gethostname())
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._record(_version_event(time.time()))

    def _record(self, payload):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag, value, step):
        self._record(_scalar_event(tag, value, step, time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
