"""TFRecord file + tf.Example codec, dependency-free (port of
``alink_tpu.io.tfrecord``).

Capability parity with the reference's native record IO (reference:
core/src/main/java/com/alibaba/alink/common/dl/data/TFRecordReader.java,
TFRecordWriter.java, Crc32C.java and common/dl/coding/ExampleCodingV2.java —
the row↔tf.Example conversion used by the JVM↔Python data plane).

This is a from-scratch implementation of the two stable wire formats:
- TFRecord framing: [uint64 len][uint32 masked-crc32c(len)][payload]
  [uint32 masked-crc32c(payload)].
- tf.Example protobuf subset: Example→Features→map<string, Feature> with
  bytes_list / float_list / int64_list, hand-coded varint/length-delimited
  wire encoding (no protobuf runtime needed).

The reference frames records through its host C++ codec when it is built
(``alink_tpu/native/codec.cc``) and through the Python path otherwise; the
port keeps the Python path, which writes the same bytes.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Tuple

from .filesystem import file_open

# -- CRC32C (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- TFRecord framing --------------------------------------------------------

def write_records(path: str, payloads: Iterable[bytes]):
    with file_open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


def read_records(path: str) -> List[bytes]:
    out = []
    with file_open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("TFRecord corrupt length crc")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("TFRecord corrupt payload crc")
            out.append(payload)
    return out


# -- minimal protobuf wire helpers ------------------------------------------

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


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:
    """length-delimited field (wire type 2)."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


# -- tf.Example subset -------------------------------------------------------

def encode_example(features: Dict[str, Tuple[str, list]]) -> bytes:
    """``features``: name -> (kind, values); kind in bytes/float/int64."""
    entries = b""
    for name, (kind, values) in features.items():
        if kind == "bytes":
            inner = b"".join(
                _ld(1, v if isinstance(v, bytes) else str(v).encode("utf-8"))
                for v in values)
            feature = _ld(1, inner)
        elif kind == "float":
            packed = struct.pack(f"<{len(values)}f", *[float(v) for v in values])
            feature = _ld(2, _ld(1, packed))
        elif kind == "int64":
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                              for v in values)
            feature = _ld(3, _ld(1, packed))
        else:
            raise ValueError(f"unknown feature kind {kind}")
        entry = _ld(1, name.encode("utf-8")) + _ld(2, feature)
        entries += _ld(1, entry)
    return _ld(1, entries)  # Example.features


def _decode_feature(buf: bytes) -> Tuple[str, list]:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2, "Feature fields are messages"
        ln, pos = _read_varint(buf, pos)
        inner = buf[pos:pos + ln]
        pos += ln
        if field == 1:  # BytesList
            vals = []
            ip = 0
            while ip < len(inner):
                t, ip = _read_varint(inner, ip)
                ln2, ip = _read_varint(inner, ip)
                vals.append(inner[ip:ip + ln2])
                ip += ln2
            return "bytes", vals
        if field == 2:  # FloatList (packed)
            ip = 0
            vals = []
            while ip < len(inner):
                t, ip = _read_varint(inner, ip)
                if (t & 7) == 2:
                    ln2, ip = _read_varint(inner, ip)
                    vals.extend(struct.unpack(f"<{ln2 // 4}f",
                                              inner[ip:ip + ln2]))
                    ip += ln2
                else:  # unpacked fixed32
                    vals.extend(struct.unpack("<f", inner[ip:ip + 4]))
                    ip += 4
            return "float", vals
        if field == 3:  # Int64List (packed)
            ip = 0
            vals = []
            while ip < len(inner):
                t, ip = _read_varint(inner, ip)
                if (t & 7) == 2:
                    ln2, ip = _read_varint(inner, ip)
                    end = ip + ln2
                    while ip < end:
                        v, ip = _read_varint(inner, ip)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        vals.append(v)
                else:
                    v, ip = _read_varint(inner, ip)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    vals.append(v)
            return "int64", vals
    return "bytes", []


def decode_example(buf: bytes) -> Dict[str, Tuple[str, list]]:
    out: Dict[str, Tuple[str, list]] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        ln, pos = _read_varint(buf, pos)
        features_buf = buf[pos:pos + ln]
        pos += ln
        fp = 0
        while fp < len(features_buf):
            tag2, fp = _read_varint(features_buf, fp)
            ln2, fp = _read_varint(features_buf, fp)
            entry = features_buf[fp:fp + ln2]
            fp += ln2
            # map entry: key (field 1), value (field 2)
            ep = 0
            key = None
            feature = None
            while ep < len(entry):
                tag3, ep = _read_varint(entry, ep)
                ln3, ep = _read_varint(entry, ep)
                body = entry[ep:ep + ln3]
                ep += ln3
                if (tag3 >> 3) == 1:
                    key = body.decode("utf-8")
                else:
                    feature = body
            if key is not None and feature is not None:
                out[key] = _decode_feature(feature)
    return out
