"""The port's TFRecord codec and Example encoding (data/tfrecord.py,
data/example.py) held against the JAX package's: the same records give
the same file bytes (raw) or the same inflated bytes (.zz, whose deflate
stream may differ between zlib callers), each package reads the other's
files, corruption raises, and the Example protos are byte-identical."""
import ctypes
import os
import zlib

import numpy as np
import pytest

from p3achygo_tpu.data import example as jex
from p3achygo_tpu.data import tfrecord as jtf
from p3achygo_tpu_torch.data import example as tex
from p3achygo_tpu_torch.data import tfrecord as ttf


def _records(seed=0):
    rng = np.random.default_rng(seed)
    recs = [b"", b"hello", bytes(range(256)), b"x" * 100000]
    recs += [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(1, 3000, 20)]
    return recs


def test_native_codec_serves():
    assert ttf.using_native()


@pytest.mark.parametrize("zz", [None, 6])
def test_files_match_jax_and_cross_read(tmp_path, zz):
    recs = _records()
    suffix = ".tfrecord.zz" if zz else ".tfrecord"
    port, port_py = str(tmp_path / ("port" + suffix)), str(tmp_path / ("port_py" + suffix))
    jax_py, jax_native = str(tmp_path / ("jax_py" + suffix)), str(tmp_path / ("jax" + suffix))
    ttf.write_records(port, recs, zlib_level=zz)
    ttf._py_write(port_py, recs, zz)
    jtf._py_write(jax_py, recs, zz)
    jtf.write_records(jax_native, recs, zlib_level=zz)
    blobs = [open(p, "rb").read() for p in (port, port_py, jax_py, jax_native)]
    if zz:
        blobs = [zlib.decompress(b) for b in blobs]
    assert all(b == blobs[2] for b in blobs)
    for path in (port, port_py, jax_py, jax_native):
        assert list(ttf.read_records(path)) == recs
        assert list(ttf._py_read(path)) == recs
        assert list(jtf.read_records(path)) == recs


@pytest.mark.parametrize("reader", ["native", "python"])
def test_corruption_raises(tmp_path, reader):
    read = ttf.read_records if reader == "native" else ttf._py_read
    path = str(tmp_path / "c.tfrecord")
    ttf.write_records(path, [b"payload", b"second"], zlib_level=None)
    blob = open(path, "rb").read()
    for pos in (3, 9, 14):  # length, length crc, payload
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        open(path, "wb").write(bytes(bad))
        with pytest.raises(ValueError):
            list(read(path))
    open(path, "wb").write(blob[:-3])  # truncated data crc
    with pytest.raises(ValueError):
        list(read(path))


def test_source_build_writes_the_same_bytes(tmp_path):
    """The fallback build of native/tfrecord.cc (g++ into _build/) gives a
    codec that writes what the committed library writes."""
    lib = ttf._bind(ttf._build())
    assert os.path.basename(ttf.built_path()).startswith("libtfrecord_")
    recs = _records(1)
    n = len(recs)
    path = str(tmp_path / "built.tfrecord")
    arr = (ctypes.c_char_p * n)(*recs)
    lens = (ctypes.c_uint64 * n)(*[len(r) for r in recs])
    assert lib.tfrec_write(path.encode(), arr, lens, n, -1) == 0
    ttf.write_records(str(tmp_path / "lib.tfrecord"), recs, zlib_level=None)
    assert open(path, "rb").read() == open(str(tmp_path / "lib.tfrecord"), "rb").read()


def test_example_bytes_match_jax():
    feats = {"a_bytes": b"\x01\x02\xff", "b_floats": [1.5, -2.0, 0.0, 1e-30],
             "c_ints": [7, 0, 123456789, -3], "d_empty": b""}
    data = tex.encode_example(feats)
    assert data == jex.encode_example(feats)
    assert tex.decode_example(data) == jex.decode_example(data)


def test_make_tf_example_bytes_match_jax():
    rng = np.random.default_rng(2)
    for color in (1, -1):
        kw = dict(
            stones=rng.integers(-1, 2, 361).astype(np.int8),
            last_moves=rng.integers(-1, 362, 5).astype(np.int16),
            stones_atari=rng.integers(-1, 2, 361).astype(np.int8),
            stones_two_lib=rng.integers(-1, 2, 361).astype(np.int8),
            stones_three_lib=rng.integers(-1, 2, 361).astype(np.int8),
            stones_ladder=np.zeros(361, np.int8),
            pi=rng.dirichlet(np.ones(362)).astype(np.float32), pi_aux=int(rng.integers(362)),
            pi_aux_dist=rng.random(362).astype(np.float32),
            ownership=rng.integers(-1, 2, 361).astype(np.int8),
            score_margin_black=float(rng.normal(0, 20)),
            mcts_value_dist=rng.integers(0, 100, 51).astype(np.uint32),
            q6=0.1, q16=-0.2, q50=0.3, q6_score=1.5, q16_score=-2.5, q50_score=3.0,
            color=color, komi=7.5)
        data = tex.make_tf_example(**kw)
        assert data == jex.make_tf_example(**kw)
        back = tex.decode_example(data)
        assert back["score_margin"] == [np.float32(kw["score_margin_black"] * color)]
