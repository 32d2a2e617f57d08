"""Minimal tensorflow.Example wire-format codec + the reference's schema
(port of p3achygo_tpu/data/example.py; numpy and the standard library, a
copy).

Replaces the vendored proto (cc/proto/example.proto:17-19) and
MakeTfExample (cc/recorder/make_tf_example.h:20-85) without a protobuf
runtime: hand-rolled proto3 encoding of
Example{Features{map<string, Feature>}} with bytes/float/int64 lists.
Byte features are raw little-endian arrays exactly like the reference's
MakeBytesFeature memcpy.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np

FeatureValue = Union[bytes, List[float], List[int]]


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


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _encode_feature(value: FeatureValue) -> bytes:
    if isinstance(value, (bytes, bytearray)):
        # BytesList{value=1} in Feature{bytes_list=1}
        return _ld(1, _ld(1, bytes(value)))
    if len(value) > 0 and isinstance(value[0], float):
        packed = struct.pack(f"<{len(value)}f", *value)
        return _ld(2, _ld(1, packed))  # FloatList packed
    packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in value)
    return _ld(3, _ld(1, packed))  # Int64List packed


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """-> serialized tensorflow.Example."""
    feats = bytearray()
    for key in sorted(features):
        entry = _ld(1, key.encode()) + _ld(2, _encode_feature(features[key]))
        feats += _ld(1, entry)  # map entry in Features.feature
    return _ld(1, bytes(feats))  # Example.features


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 2:
            length, pos = _read_varint(buf, pos)
            yield field, buf[pos:pos + length]
            pos += length
        elif wt == 0:
            val, pos = _read_varint(buf, pos)
            yield field, val
        elif wt == 5:
            yield field, buf[pos:pos + 4]
            pos += 4
        elif wt == 1:
            yield field, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    """serialized Example -> {key: bytes | [float] | [int]}."""
    out: Dict[str, FeatureValue] = {}
    for field, payload in _iter_fields(data):
        if field != 1:
            continue
        for f2, entry in _iter_fields(payload):
            if f2 != 1:
                continue
            key = None
            value = None
            for f3, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    for f4, v4 in _iter_fields(v3):
                        if f4 == 1:  # BytesList
                            for f5, v5 in _iter_fields(v4):
                                if f5 == 1:
                                    value = v5
                        elif f4 == 2:  # FloatList
                            for f5, v5 in _iter_fields(v4):
                                if f5 == 1:
                                    value = list(struct.unpack(
                                        f"<{len(v5) // 4}f", v5))
                        elif f4 == 3:  # Int64List
                            for f5, v5 in _iter_fields(v4):
                                if f5 == 1:
                                    vals = []
                                    p = 0
                                    while p < len(v5):
                                        v, p = _read_varint(v5, p)
                                        vals.append(v)
                                    value = vals
            if key is not None:
                out[key] = value
    return out


def make_tf_example(stones: np.ndarray, last_moves: np.ndarray,
                    stones_atari: np.ndarray, stones_two_lib: np.ndarray,
                    stones_three_lib: np.ndarray, stones_ladder: np.ndarray,
                    pi: np.ndarray, pi_aux: int, pi_aux_dist: np.ndarray,
                    ownership: np.ndarray, score_margin_black: float,
                    mcts_value_dist: np.ndarray, q6: float, q16: float,
                    q50: float, q6_score: float, q16_score: float,
                    q50_score: float, color: int, komi: float,
                    bsize: int = 19) -> bytes:
    """Serialize one training example with the reference's 17-feature schema
    (make_tf_example.h:20-85). score_margin_black is the BLACK-perspective
    margin; it is flipped to the mover's perspective here like the
    reference (margin = color == BLACK ? b-w : w-b)."""
    margin = score_margin_black if color == 1 else -score_margin_black
    return encode_example({
        "bsize": np.uint8(bsize).tobytes(),
        "board": stones.astype(np.int8).tobytes(),
        "last_moves": last_moves.astype(np.int16).tobytes(),
        "stones_atari": stones_atari.astype(np.int8).tobytes(),
        "stones_two_liberties": stones_two_lib.astype(np.int8).tobytes(),
        "stones_three_liberties": stones_three_lib.astype(np.int8).tobytes(),
        "stones_in_ladder": stones_ladder.astype(np.int8).tobytes(),
        "color": np.int8(color).tobytes(),
        "komi": [float(komi)],
        "own": ownership.astype(np.int8).tobytes(),
        "pi": pi.astype(np.float32).tobytes(),
        "pi_aux": np.int16(pi_aux).tobytes(),
        "pi_aux_dist": pi_aux_dist.astype(np.float32).tobytes(),
        "mcts_value_dist": mcts_value_dist.astype(np.uint32).tobytes(),
        "score_margin": [float(margin)],
        "q6": [float(q6)], "q16": [float(q16)], "q50": [float(q50)],
        "q6_score": [float(q6_score)], "q16_score": [float(q16_score)],
        "q50_score": [float(q50_score)],
    })
