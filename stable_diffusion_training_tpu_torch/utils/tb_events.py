"""Dependency-free TensorBoard event-file writer (and reader, for tests).

The port's own copy of ``stable_diffusion_training_tpu/utils/tb_events.py``.
Scalars are simple enough to serialize by hand, so this module implements
the on-disk format directly (no protobuf, no ``tensorboard`` package, which
the training machines need not have):

- **File**: ``events.out.tfevents.<unix_time>.<hostname>`` under the log dir;
  TensorBoard discovers it by that name pattern.
- **Record framing** (TFRecord): ``uint64 length | uint32 masked_crc32c(length
  bytes) | payload | uint32 masked_crc32c(payload)``, all little-endian.
- **Payload**: a serialized ``tensorflow.Event`` protobuf. Only three fields
  are needed — ``wall_time`` (double, field 1), ``step`` (int64, field 2),
  and either ``file_version`` (string, field 3, first record only) or
  ``summary`` (field 5) holding repeated ``Summary.Value{tag, simple_value}``.

Protobuf wire format for this shape is tiny: varint keys ``(field<<3)|wire``,
wire 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""

import os
import socket
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; TFRecord uses the "masked" variant.
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _build_table() -> None:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float32(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def encode_scalar_event(
    tag: str, value: float, step: int, wall_time: float
) -> bytes:
    """``Event{wall_time, step, summary{value{tag, simple_value}}}``."""
    summary_value = _ld(1, tag.encode("utf-8")) + _float32(2, float(value))
    summary = _ld(1, summary_value)
    return _double(1, wall_time) + _int64(2, int(step)) + _ld(5, summary)


def encode_file_version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _ld(3, b"brain.Event:2")


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class EventFileWriter:
    """Append-only scalar summary writer, TensorBoard-compatible on disk.

    Thread-safe (the trainer logs from the main loop but profiling hooks may
    flush from elsewhere); buffered writes with explicit ``flush``.
    """

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            time.time(),
            socket.gethostname(),
            filename_suffix,
        )
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "ab")
        self._lock = threading.Lock()
        self._write(frame_record(encode_file_version_event(time.time())))

    def _write(self, data: bytes) -> None:
        with self._lock:
            self._file.write(data)

    def add_scalar(
        self,
        tag: str,
        value: float,
        step: int,
        wall_time: Optional[float] = None,
    ) -> None:
        wall = time.time() if wall_time is None else wall_time
        self._write(frame_record(encode_scalar_event(tag, value, step, wall)))

    def flush(self) -> None:
        with self._lock:
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                self._file.close()


# ---------------------------------------------------------------------------
# Reader — used by tests to round-trip, and handy for offline inspection.
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, raw_value_bytes)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, _varint(val)
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:  # pragma: no cover - groups unused
            raise ValueError(f"unsupported wire type {wire}")


def read_event_file(path: str) -> List[dict]:
    """Decode an event file into dicts: ``{wall_time, step, tag, value}``
    for scalar events, ``{file_version}`` for the header. Verifies CRCs."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos : pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8 : pos + 12])
        if hcrc != masked_crc32c(header):
            raise ValueError("header CRC mismatch")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack(
            "<I", data[pos + 12 + length : pos + 16 + length]
        )
        if pcrc != masked_crc32c(payload):
            raise ValueError("payload CRC mismatch")
        pos += 16 + length

        event: dict = {}
        for field, wire, raw in _iter_fields(payload):
            if field == 1 and wire == 1:
                event["wall_time"] = struct.unpack("<d", raw)[0]
            elif field == 2 and wire == 0:
                event["step"], _ = _read_varint(raw, 0)
            elif field == 3 and wire == 2:
                event["file_version"] = raw.decode("utf-8")
            elif field == 5 and wire == 2:
                for sfield, swire, sraw in _iter_fields(raw):
                    if sfield == 1 and swire == 2:
                        for vfield, vwire, vraw in _iter_fields(sraw):
                            if vfield == 1 and vwire == 2:
                                event["tag"] = vraw.decode("utf-8")
                            elif vfield == 2 and vwire == 5:
                                event["value"] = struct.unpack("<f", vraw)[0]
        events.append(event)
    return events
