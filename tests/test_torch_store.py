"""The port's store bus (data/store.py) on the cases of the JAX package's
tests/test_store.py: atomic publishes, `.done` gating, discovery helpers,
and a gs:// URL failing with JAX's RuntimeError when
google-cloud-storage cannot be imported."""
import os
import sys

import pytest

from p3achygo_tpu.data import store as jstore
from p3achygo_tpu_torch.data.store import (
    GOLDEN_CHUNKS_DIR,
    MODEL_CANDS_DIR,
    MODELS_DIR,
    SGF_DIR,
    SP_CHUNKS_DIR,
    GcsStore,
    LocalStore,
    cand_name,
    list_done_chunks,
    make_store,
    model_name,
    most_recent_model,
    most_recent_model_cand,
)


def test_names_match_jax():
    assert (MODELS_DIR, MODEL_CANDS_DIR, SP_CHUNKS_DIR, GOLDEN_CHUNKS_DIR, SGF_DIR) == (
        jstore.MODELS_DIR, jstore.MODEL_CANDS_DIR, jstore.SP_CHUNKS_DIR,
        jstore.GOLDEN_CHUNKS_DIR, jstore.SGF_DIR)
    for g in (0, 7, 1234):
        assert model_name(g) == jstore.model_name(g)
        assert cand_name(g) == jstore.cand_name(g)


def test_local_store_roundtrip(tmp_path):
    s = make_store(str(tmp_path / "bus"))
    assert isinstance(s, LocalStore)
    s.write_bytes("a/b.txt", b"hello")
    assert s.read_bytes("a/b.txt") == b"hello"
    assert s.exists("a/b.txt") and not s.exists("a/c.txt")
    d = tmp_path / "art"
    d.mkdir()
    (d / "f1").write_text("x")
    (d / "sub").mkdir()
    (d / "sub" / "f2").write_text("y")
    s.put(str(d), model_name(3))
    assert most_recent_model(s) == -1  # not done yet
    s.mark_done(model_name(3))
    assert most_recent_model(s) == 3
    assert s.local_path(model_name(3)) == os.path.join(str(tmp_path / "bus"), model_name(3))
    out = s.get(model_name(3), str(tmp_path / "pull"))
    assert open(os.path.join(out, "sub", "f2")).read() == "y"
    # Republishing replaces the payload and leaves no tmp behind.
    (d / "f1").write_text("z")
    s.put(str(d), model_name(3), done=True)
    assert open(os.path.join(s.local_path(model_name(3)), "f1")).read() == "z"
    assert not os.path.exists(s.local_path(model_name(3)) + ".tmp")
    s.put(str(d / "f1"), cand_name(4), done=True)
    assert most_recent_model_cand(s) == 4 and most_recent_model(s) == 3
    s.delete(model_name(3))
    assert not s.exists(model_name(3))


def test_done_chunk_listing(tmp_path):
    """Only payloads with a `.done` marker are listed: not a payload
    without one, not a marker without its payload, not a `.tmp`."""
    s = LocalStore(str(tmp_path))
    s.write_bytes(f"{SP_CHUNKS_DIR}/c1.tfrecord.zz", b"d1")
    s.write_bytes(f"{SP_CHUNKS_DIR}/c2.tfrecord.zz", b"d2")
    s.mark_done(f"{SP_CHUNKS_DIR}/c2.tfrecord.zz")
    s.mark_done(f"{SP_CHUNKS_DIR}/c3.tfrecord.zz")
    s.write_bytes(f"{SP_CHUNKS_DIR}/c4.tfrecord.zz.tmp", b"torn")
    assert list_done_chunks(s) == ["c2.tfrecord.zz"]
    assert list_done_chunks(s) == jstore.list_done_chunks(jstore.LocalStore(str(tmp_path)))
    assert list_done_chunks(s, "nothing_here") == []


def test_gs_url_without_library(monkeypatch):
    monkeypatch.setitem(sys.modules, "google.cloud", None)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    with pytest.raises(RuntimeError, match="google-cloud-storage"):
        make_store("gs://bucket/prefix")
    with pytest.raises(RuntimeError, match="google-cloud-storage"):
        GcsStore("gs://bucket")
