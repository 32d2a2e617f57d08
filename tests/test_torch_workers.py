"""The port's actor/learner workers over a local store bus
(rl/workers.py, `python -m p3achygo_tpu_torch.rl --role actor|learner`),
on the protocol assertions of the JAX package's tests/test_workers.py and
tests/test_resume.py's tiny configuration, on the CPU: the learner seeds
the bus with gen 0, the actor syncs it, plays, publishes a `.done` chunk,
the learner ingests it (once), trains a generation and publishes the next
golden, and the actor hot-swaps it bit for bit, its gen following the
bus."""
import dataclasses
import json
import os
import threading

import numpy as np
import torch

from p3achygo_tpu_torch.data.export import CHUNK_FORMAT, read_game_chunk
from p3achygo_tpu_torch.data.store import (SP_CHUNKS_DIR, list_done_chunks, make_store,
                                           model_name, most_recent_model)
from p3achygo_tpu_torch.rl import __main__ as rl_main
from p3achygo_tpu_torch.rl.config import RunConfig
from p3achygo_tpu_torch.rl.workers import Learner, SelfplayActor
from p3achygo_tpu_torch.selfplay.records import GameExamples
from test_resume import tiny_run_cfg as jax_tiny_run_cfg

torch.set_num_threads(2)


def tiny_run_cfg(**kw) -> RunConfig:
    """tests/test_resume.py's tiny configuration as the port's RunConfig."""
    return RunConfig(**{**dataclasses.asdict(jax_tiny_run_cfg()), **kw})


def _same_examples(a: GameExamples, b: GameExamples) -> bool:
    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(GameExamples))


def test_actor_learner_roundtrip(tmp_path):
    cfg = tiny_run_cfg()
    store = make_store(str(tmp_path / "bus"))

    learner = Learner(cfg, store, run_dir=str(tmp_path / "learner"), device="cpu")
    assert most_recent_model(store) < 0
    learner.publish_golden()
    assert most_recent_model(store) == 0

    actor = SelfplayActor(cfg, store, worker_id="wA", scratch_dir=str(tmp_path / "actor"),
                          seed=3, device="cpu")
    assert actor.sync_model() is True
    assert actor.model_gen == 0
    assert actor.sync_model() is False  # idempotent: nothing newer

    sunk = []
    actor.loop.game_sink = lambda ex: (sunk.append(ex), actor._pending.append(ex))
    name = actor.play_and_publish(cfg.games_per_gen)
    assert name.startswith(SP_CHUNKS_DIR + "/") and store.is_done(name)
    base = os.path.basename(name)
    assert base.startswith(f"gen000_b000_g{len(sunk):03d}_n") and base.endswith("_wA.tfrecord.zz")
    assert len(sunk) == actor.loop.replay.games_added >= cfg.games_per_gen
    # The chunk decodes to the sunk games under the reconstruction rules
    # (their z, weight and has_pi_aux_dist are those rules' values).
    back = read_game_chunk(store.local_path(name))
    cat = GameExamples(**{f.name: np.concatenate([getattr(e, f.name) for e in sunk])
                          for f in dataclasses.fields(GameExamples)})
    cat.weight = np.ones_like(cat.weight)
    assert _same_examples(back, cat)

    got = learner.wait_for_examples(min_examples=1, timeout_s=5.0)
    assert got == len(back)
    assert len(learner.loop.replay) == got
    assert learner.ingest_new_chunks() == 0  # re-ingest is a no-op

    info = learner.train_generation(eval_gating=False)
    assert info["gen"] == 1
    assert most_recent_model(store) == 1

    # Hot swap: the actor's golden equals the published one bit for bit and
    # its search rebinds at the bus generation's n/k.
    assert actor.loop._sp is not None
    assert actor.sync_model() is True
    assert actor.model_gen == 1 and actor.loop.gen == 1 and actor.loop._sp is None
    want = learner.loop.golden.state_dict()
    have = actor.loop.golden.state_dict()
    assert have.keys() == want.keys() and all(torch.equal(have[k], want[k]) for k in want)
    assert actor.play_and_publish(cfg.games_per_gen).startswith(f"{SP_CHUNKS_DIR}/gen001_b001_")


def test_two_actors_one_learner(tmp_path):
    """Scale-out shape: two actors publish to one bus; the learner ingests
    both workers' chunks (worker_id keeps chunk names disjoint)."""
    cfg = tiny_run_cfg()
    store = make_store(str(tmp_path / "bus"))
    learner = Learner(cfg, store, run_dir=str(tmp_path / "learner"), device="cpu")
    learner.publish_golden()
    names = []
    for i, wid in enumerate(("w0", "w1")):
        actor = SelfplayActor(cfg, store, worker_id=wid, scratch_dir=str(tmp_path / f"a{i}"),
                              seed=i, device="cpu")
        actor.sync_model()
        names.append(actor.play_and_publish(1))
    assert len(set(names)) == 2
    # A payload without its .done marker is not ingested.
    store.write_bytes(f"{SP_CHUNKS_DIR}/" + CHUNK_FORMAT % (0, 9, 1, 1, 0, "w9"), b"torn")
    assert sorted(list_done_chunks(store)) == sorted(os.path.basename(n) for n in names)
    assert learner.wait_for_examples(min_examples=1, timeout_s=5.0) > 0
    assert learner._seen_chunks == {os.path.basename(n) for n in names}


def test_roles_complete_one_generation(tmp_path, capsys):
    """`--role learner` and `--role actor`, each main() in a thread of its
    own, share one store and finish generation 1: the learner waits for
    games_per_gen * 60 examples, trains, gates and publishes model_0001;
    the actor then sees gen 1 on the bus and exits."""
    cfg_path = tmp_path / "cfg.json"
    # 16 boards: a tiny seeded net passes early, and the learner waits for
    # 60 examples, so a chunk should hold many games.
    cfg_path.write_text(json.dumps(dataclasses.asdict(tiny_run_cfg(
        games_per_gen=1, eval_games=2, eval_max_game_len=6, selfplay_batch_size=16))))
    store_dir = str(tmp_path / "bus")
    errors = []

    def run(role):
        try:
            rl_main.main(["--config", str(cfg_path), "--gens", "1", "--role", role,
                          "--store", store_dir, "--run-dir", str(tmp_path / role),
                          "--device", "cpu"])
        except BaseException as e:  # reported by the test below
            errors.append((role, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in ("learner", "actor")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    store = make_store(store_dir)
    assert store.is_done(model_name(1)) and most_recent_model(store) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert any(x.get("gen") == 1 for x in lines)
    assert any(x.get("actor_gen") == 0 and x["chunk"] for x in lines)
    assert sum(len(read_game_chunk(store.local_path(f"{SP_CHUNKS_DIR}/{n}")))
               for n in list_done_chunks(store)) >= 60
