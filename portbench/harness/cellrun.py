"""One run of one cell: set-up, the timed window of self-play, the traced
plies, and what the correctness check needs.

The window drives `selfplay.loop.selfplay_step_tiered` with a reuse tree,
followed every `reset_every`-th ply by `reset_finished(...,
max_raw_policy_moves=0)`, the production harvest cadence. The eval
function is `mcts.gumbel.make_eval_fn` on a bf16 `models.build_model`
network with `symmetrize` on, through the traffic's route, one of
`ROUTES`, and from the configuration file's `models.config.ModelConfig`
fields (`build_eval_fn`). Weights come from `weights.make_weights`; start
positions from the benchmark's own rules engine
(`reference.rules.random_games`), handed over by `game.board.from_stones`.

Taps the harness puts around the program, without editing it:
- `EvalTap` around the eval function: counts positions, keeps a sample of
  leaf batches (inputs and outputs) for the check, and, while plies are
  profiled, opens a `nn_eval` range;
- `SearchTap` around `search_root` as the step calls it: each call's
  (n, k) and, for its boards, the target, the root's priors in the tree,
  its child visits and Q after the search and the child visits a reused
  tree brought;
- `PlyRecorder`: after each ply, the move, the policy target, the root's
  own utility and the stones of a sample of boards, with the ply's search
  calls matched to those boards by their targets, and each reset's
  finished flags;
- in a traced run only, wrappers of the trunk and liberty kernels' entry
  points that note each call's shapes while plies are profiled, and
  `step` / `search` / `reset` ranges.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness.weights import make_weights, torch_seed
from portbench.reference import rules
from portbench.reference import search as ref_search

# The eval function's keyword arguments of each forward route a traffic
# file may name. Two are controls (portbench/control.py), which no cell
# runs: "serveq", the program's int8 path, calibrated on the cell's start
# positions (`calibrate`), and "e4m3", the plain route with every
# product's weight and input rounded to float8 e4m3 by the harness
# (`round_products_e4m3`), the H100's next precision below bf16, which
# every trunk type has.
ROUTES = {
    "plain": {},
    "fused": {"use_fused_trunk": True},
    "fold": {"serve_fold": True},
    "serveq": {"serve_q_scales": None},
    "e4m3": {},
}
E4M3_MAX = 448.0

# What the correctness check samples: the boards whose games are replayed,
# one leaf call in `leaf_call_every` (from an offset drawn from the seed),
# `leaf_rows_per_call` rows of it up to `leaf_rows_max`, and at most
# `pi_positions_max` of the replayed roots.
CHECK = {"boards": 128, "leaf_call_every": 3, "leaf_rows_per_call": 32,
         "leaf_rows_max": 1024, "pi_positions_max": 1024}


def start_positions(B: int, max_plies: int, seed: int):
    """(stones int8[B, 361], to_move int8[B]): B random games whose lengths
    are the same evenly spread set over 0..max_plies for every seed, in an
    order drawn from the seed."""
    rng = np.random.default_rng(seed)
    lengths = np.round(np.arange(B) * max_plies / max(B - 1, 1)).astype(np.int64)
    stones, to_move, _ = rules.random_games(rng.permutation(lengths), rng)
    return stones, to_move


def calibrate(model, tr: dict, seed: int, device):
    """int8 scales of the program's own int8 serving path (the "serveq"
    route) from 256 of this cell's start positions."""
    from p3achygo_tpu_torch.features import batched_features
    from p3achygo_tpu_torch.game.board import from_stones
    from p3achygo_tpu_torch.nn.serve_q import calibrate as calibrate_q

    st, tm = start_positions(256, tr["start_plies_max"], seed + 1)
    states = from_stones(torch.from_numpy(st), tr["komi"], torch.from_numpy(tm), device=device)
    planes, scalars = batched_features(states, planes_dtype=torch.bfloat16)
    return calibrate_q(model, planes, scalars)


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 on a per-tensor amax scale, then back to
    t's dtype."""
    f = t.float()
    scale = f.abs().amax().clamp(min=torch.finfo(torch.float32).tiny) / E4M3_MAX
    q = (f / scale).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(t.dtype)


@torch.no_grad()
def round_products_e4m3(model) -> None:
    """The "e4m3" route: the weight of every product module of the model
    (`Conv`, `Dense` and so `FlaxDense`, `Projection`) rounded in place by
    `to_e4m3`, and its input by a forward pre-hook. The model holds its own
    copy of the weights: the dict the reference reads is untouched."""
    from p3achygo_tpu_torch.models.blocks import Conv, Dense
    from p3achygo_tpu_torch.models.transformer import Projection

    for mod in model.modules():
        if isinstance(mod, (Conv, Dense, Projection)):
            mod.weight.copy_(to_e4m3(mod.weight))
            mod.register_forward_pre_hook(lambda _, args: (to_e4m3(args[0]),) + args[1:])


def build_eval_fn(cell: dict, params: Dict[str, torch.Tensor], route: str, seed: int, device):
    """(model, eval function) of the program for `cell` on `params`: a bf16
    `models.build_model` network from the configuration file's
    `models.config.ModelConfig` fields, through `route`. Where the
    program's int8 path does not take the configuration (`q_supported`),
    "serveq" gets no scales and `make_eval_fn` serves the plain forward, as
    it would for any caller: control.py refuses such a route."""
    from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
    from p3achygo_tpu_torch.models.config import ModelConfig
    from p3achygo_tpu_torch.models.model import build_model
    from p3achygo_tpu_torch.nn.serve_q import q_supported

    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; routes: {sorted(ROUTES)}")
    cfg = cell["config"]
    fields = {f.name: cfg[f.name] for f in dataclasses.fields(ModelConfig) if f.name in cfg}
    model = build_model(ModelConfig(**fields), torch.bfloat16, device)
    model.load_state_dict(params, strict=True)
    kw = dict(ROUTES[route])
    if "serve_q_scales" in kw and q_supported(model.config):
        kw["serve_q_scales"] = calibrate(model, cell["traffic"], seed, device)
    if route == "e4m3":
        round_products_e4m3(model)
    return model, make_eval_fn(model, symmetrize=True, **kw)


class EvalTap:
    """The eval function with the harness's counters and samples around it."""

    def __init__(self, fn, every: int, offset: int, rows_per_call: int, rows_max: int):
        self.fn = fn
        self.every, self.offset = every, offset
        self.rows_per_call, self.rows_max = rows_per_call, rows_max
        self.positions = 0
        self.calls = 0
        self.sampling = False
        self.annotate = False
        self.samples: List[tuple] = []
        self.rows = 0

    def __call__(self, states):
        n = states.stones.shape[0]
        self.positions += n
        self.calls += 1
        ctx = torch.profiler.record_function("nn_eval") if self.annotate else contextlib.nullcontext()
        with ctx:
            out = self.fn(states)
        if (self.sampling and n > 0 and self.rows < self.rows_max
                and (self.calls + self.offset) % self.every == 0):
            step = max(1, n // self.rows_per_call)
            idx = torch.arange(self.calls % step, n, step, device=states.stones.device)
            idx = idx[:min(self.rows_per_call, self.rows_max - self.rows)]
            self.rows += idx.shape[0]
            self.samples.append(tuple(t[idx] for t in (
                states.stones, states.to_move, states.last_moves, states.komi,
                out.log_priors, out.outcome_value, out.score_est, out.score_var, out.err_est)))
        return out


class SearchTap:
    """`search_root` as the self-play step calls it. Keeps of each call the
    (n, k) it was given and, for each of its boards, the policy target, the
    root's priors as the tree holds them, the root's child visits and Q
    after the search, and the child visits the reused tree brought to the
    root (0 for a fresh one), until `take`."""

    def __init__(self, fn):
        self.fn = fn
        self.calls: List[tuple] = []
        self.__name__ = getattr(fn, "__name__", "search_root")

    def __call__(self, states, eval_fn, params, *args, **kwargs):
        init = kwargs.get("init_tree")
        pre = (init.edge_n[:, 0].sum(dim=-1, dtype=torch.int32) if init is not None
               else torch.zeros(states.stones.shape[0], dtype=torch.int32,
                                device=states.stones.device))
        out = self.fn(states, eval_fn, params, *args, **kwargs)
        res = out if hasattr(out, "pi_improved") else out[0]
        self.calls.append((params.n, params.k, res.pi_improved, res.root_priors,
                           res.root_child_visits, res.root_child_q, pre))
        return out

    def take(self) -> List[tuple]:
        calls, self.calls = self.calls, []
        return calls


def match_search(pi: np.ndarray, calls: List[tuple]) -> dict:
    """The search call rows whose target is each of the K recorded targets
    `pi` [K, 362], found by equal bytes: {matched bool[K], n, k int[K],
    priors f32[K, 362], visits int32[K, 362], q f32[K, 362], pre int[K],
    tiers [(n, k, rows)]}."""
    K, A = pi.shape
    out = {"matched": np.zeros(K, bool), "n": np.zeros(K, np.int64),
           "k": np.zeros(K, np.int64), "priors": np.zeros((K, A), np.float32),
           "visits": np.zeros((K, A), np.int32), "q": np.zeros((K, A), np.float32),
           "pre": np.zeros(K, np.int64),
           "tiers": [(c[0], c[1], int(c[2].shape[0])) for c in calls]}
    where = {}
    for c, call in enumerate(calls):
        for r, row in enumerate(call[2]):
            where.setdefault(row.tobytes(), (c, r))
    for i in range(K):
        hit = where.get(np.ascontiguousarray(pi[i], np.float32).tobytes())
        if hit is None:
            continue
        c, r = hit
        n, k, _, priors, visits, q, pre = calls[c]
        out["matched"][i] = True
        out["n"][i], out["k"][i] = n, k
        out["priors"][i], out["visits"][i], out["q"][i] = priors[r], visits[r], q[r]
        out["pre"][i] = pre[r]
    return out


class PlyRecorder:
    """Per ply, for the sampled boards `rows`: whether each was finished
    before the ply, the move recorded, its policy target, the root's own
    utility (`nn_q`, which completes the unvisited children's Q) and the
    stones after, with the ply's search calls; per reset, the finished flags
    and the stones after."""

    def __init__(self, rows: torch.Tensor, max_game_len: int):
        self.rows = rows
        self.max_len = max_game_len
        self.events: List[tuple] = []

    def before(self, states, finished):
        return states.move_count[self.rows], finished[self.rows]

    def after(self, pre, states, buf, calls):
        mc, fin = pre
        t = mc.long().clamp(0, self.max_len - 1)
        self.events.append(("ply", fin, buf.move[self.rows, t], buf.pi[self.rows, t],
                            states.stones[self.rows], buf.nn_q[self.rows, t], calls))

    def reset(self, done, states):
        self.events.append(("reset", done[self.rows], states.stones[self.rows]))

    def to_host(self) -> List[tuple]:
        """The events on the host, each ply's search calls matched to the
        sampled boards (the ply's last element)."""
        out = []
        for e in self.events:
            if e[0] == "ply":
                host = tuple(t.cpu().numpy() for t in e[1:6])
                calls = [(n, k) + tuple(t.cpu().numpy() for t in ts)
                         for n, k, *ts in e[6]]
                out.append(("ply",) + host + (match_search(host[2], calls),))
            else:
                out.append((e[0],) + tuple(t.cpu().numpy() for t in e[1:]))
        return out


class ShapeTap:
    """Wraps a kernel entry point; while `on`, notes each call's shapes."""

    def __init__(self, fn, shape_of):
        self.fn, self.shape_of = fn, shape_of
        self.on = False
        self.calls: List[tuple] = []
        self.launches = 0
        self.__name__ = fn.__name__

    def __call__(self, *args, **kwargs):
        if self.on:
            self.calls.append(self.shape_of(*args, **kwargs))
        return self.fn(*args, **kwargs)


def _rebind(original, replacement) -> int:
    """Point every binding of `original` in the program's modules at
    `replacement`; returns how many were changed."""
    n = 0
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("p3achygo_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if val is original:
                setattr(mod, attr, replacement)
                n += 1
    return n


def _ranged(fn, name: str, flag):
    def wrapped(*args, **kwargs):
        if not flag():
            return fn(*args, **kwargs)
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", name)
    return wrapped


class CellRun:
    """Builds the program for one cell and runs it. `device` is the card
    in a benchmark run; tests pass the CPU. `eval_wrap` / `step_wrap`, if
    given, wrap the program's eval function / step (the fault tests);
    `route` replaces the traffic's route (a control's), and
    `check` entries replace those of `CHECK` (smaller samples in tests)."""

    def __init__(self, cell: dict, seed: int, device, trace: bool, log=print,
                 eval_wrap=None, step_wrap=None, route=None, check=None):
        from p3achygo_tpu_torch.game.board import from_stones
        from p3achygo_tpu_torch.mcts import gumbel
        from p3achygo_tpu_torch.mcts.gumbel import SearchParams
        from p3achygo_tpu_torch.mcts.tree import make_tree
        from p3achygo_tpu_torch.selfplay import loop

        self.cell, self.seed, self.device, self.log = cell, seed, device, log
        self.loop, self.gumbel = loop, gumbel
        cfg, tr = cell["config"], cell["traffic"]
        self.tr = tr
        self.profiling = False
        self.check = {**CHECK, **(check or {})}
        self.taps: Dict[str, ShapeTap] = {}
        self.search_root = loop.search_root
        self.search_tap = SearchTap(loop.search_root)
        loop.search_root = self.search_tap
        if trace:
            self._install_taps()

        t0 = time.perf_counter()
        self.params = make_weights(cfg, seed, device, cell["bench_dir"])
        model, fn = build_eval_fn(cell, self.params, route or tr["route"], seed, device)
        if eval_wrap is not None:
            fn = eval_wrap(fn)
        chk = self.check
        rng = np.random.default_rng(seed)
        self.eval_tap = EvalTap(fn, chk["leaf_call_every"], int(rng.integers(chk["leaf_call_every"])),
                                chk["leaf_rows_per_call"], chk["leaf_rows_max"])
        self.model = model
        t1 = time.perf_counter()
        B = tr["batch"]
        self.sp_cfg = loop.SelfplayConfig(batch_size=B, komi=tr["komi"],
                                          max_game_len=tr["max_game_len"],
                                          trainable_move_prob=tr["selected_share"])
        sp = lambda d: SearchParams(n=d["n"], k=d["k"], noise_scale=1.0,
                                    max_depth=tr["max_depth"], visit_group=tr["visit_group"],
                                    c_visit=tr["c_visit"], c_scale=tr["c_scale"])
        self.params_sel, self.params_fast = sp(tr["selected"]), sp(tr["fast"])
        self.start_stones, self.start_to_move = start_positions(B, tr["start_plies_max"], seed)
        self.states = from_stones(torch.from_numpy(self.start_stones), tr["komi"],
                                  torch.from_numpy(self.start_to_move), device=device)
        t2 = time.perf_counter()
        log(f"set-up parts: weights, model and eval function {t1 - t0:.2f} s; start positions "
            f"and boards {t2 - t1:.2f} s")
        self.buf = loop.make_game_buffer(B, tr["max_game_len"], device)
        self.gen = torch.Generator(device=device).manual_seed(torch_seed(seed) ^ 0x5EED)
        self.aux = loop.make_aux(B, self.gen, max_raw_moves=0, device=device)
        self.aux = self.aux._replace(raw_until=self.aux.raw_until * 0)
        self.tree = make_tree(B, tr["reuse_capacity"], device)
        self.sampled = np.sort(rng.choice(B, size=min(chk["boards"], B), replace=False))
        self.recorder = PlyRecorder(torch.from_numpy(self.sampled).to(device), tr["max_game_len"])
        self.step_fn = loop.selfplay_step_tiered if step_wrap is None else step_wrap(
            loop.selfplay_step_tiered)
        self.plies_played = 0

    def _install_taps(self):
        from p3achygo_tpu_torch.nn import trunk_kernel
        from p3achygo_tpu_torch.ops import liberties

        def seg_shape(x, w):
            return (x.shape[0],) + tuple(w.aff.shape[:2]) + tuple(w.wr.shape[1:])

        for name, orig, shape_of in (
                ("trunk_segment", trunk_kernel.trunk_segment, seg_shape),
                ("trunk_broadcast", trunk_kernel.trunk_broadcast,
                 lambda x, w: (x.shape[0], w.wf.shape[0])),
                ("point_liberties_batch", liberties.point_liberties_batch,
                 lambda stones, chain: (stones.shape[0],))):
            tap = ShapeTap(orig, shape_of)
            self.taps[name] = tap
            if name.startswith("trunk"):
                setattr(trunk_kernel, name, tap)
            else:
                _rebind(orig, tap)
        flag = lambda: self.profiling
        self.search_tap.fn = _ranged(self.search_tap.fn, "search", flag)

    def _set_profiling(self, on: bool):
        self.profiling = on
        self.eval_tap.annotate = on
        for tap in self.taps.values():
            tap.on = on

    def ply(self):
        loop = self.loop
        fin = loop.finished_mask(self.states, self.sp_cfg)
        pre = self.recorder.before(self.states, fin)
        ctx = (torch.profiler.record_function("step") if self.profiling
               else contextlib.nullcontext())
        with ctx:
            self.states, self.buf, self.aux, self.tree = self.step_fn(
                self.states, self.buf, self.aux, self.eval_tap, self.params_sel,
                self.params_fast, self.sp_cfg, generator=self.gen, reuse_tree=self.tree,
                reuse_capacity=self.tr["reuse_capacity"])
        self.recorder.after(pre, self.states, self.buf, self.search_tap.take())
        self.plies_played += 1
        return ~fin

    def reset(self):
        loop = self.loop
        ctx = (torch.profiler.record_function("reset") if self.profiling
               else contextlib.nullcontext())
        with ctx:
            done = loop.finished_mask(self.states, self.sp_cfg)
            self.states, self.buf, self.aux, self.tree = loop.reset_finished(
                self.states, self.buf, self.aux, done, self.tr["komi"], generator=self.gen,
                max_raw_policy_moves=0, reuse_tree=self.tree)
        self.recorder.reset(done, self.states)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        t0 = time.perf_counter()
        for _ in range(self.tr["warm_plies"]):
            self.ply()
        self.reset()
        self.sync()
        self.log(f"set-up parts: {self.tr['warm_plies']} warm plies and a reset "
                 f"{time.perf_counter() - t0:.2f} s")

    def window(self, seconds: float) -> dict:
        """Whole plies until the first that ends past `seconds`; the moves
        of boards active at each ply's start over all the window's time."""
        every = self.tr["reset_every"]
        syncs0 = sum(self.gumbel.COUNTERS.syncs.values())
        causes0 = dict(self.gumbel.COUNTERS.syncs)
        pos0 = self.eval_tap.positions
        moves = torch.zeros((), dtype=torch.int64, device=self.device)
        plies = 0
        self.eval_tap.sampling = True
        self.sync()
        t0 = time.perf_counter()
        ends = []
        while True:
            active = self.ply()
            moves += active.sum()
            plies += 1
            if plies % every == 0:
                self.reset()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        self.sync()
        dt = time.perf_counter() - t0
        per_ply = np.diff([0.0] + ends)
        causes = {k: v - causes0.get(k, 0) for k, v in self.gumbel.COUNTERS.syncs.items()}
        self.log(f"window plies on the host clock: min {per_ply.min():.4f} median "
                 f"{np.median(per_ply):.4f} max {per_ply.max():.4f} s; search syncs by cause "
                 f"{causes}; each {[round(float(x), 3) for x in per_ply]}")
        tr = self.tr
        lanes = sum(rows * (1 + sum(k * v for k, v in ref_search.schedule(d["n"], d["k"])))
                    for rows, d in zip(ref_search.tier_sizes(tr["batch"], tr["selected_share"]),
                                       (tr["selected"], tr["fast"])))
        self.log(f"window: {(self.eval_tap.positions - pos0) / plies:.1f} positions evaluated a "
                 f"ply; a root and every lane of every sweep of each board's schedule are {lanes}")
        self.eval_tap.sampling = False
        self.window_plies = plies
        return {"seconds": dt, "plies": plies, "moves": int(moves),
                "positions": self.eval_tap.positions - pos0,
                "syncs": sum(self.gumbel.COUNTERS.syncs.values()) - syncs0}

    def profiled_plies(self, n: int):
        """`n` more plies under the profiler (the reset cadence kept)."""
        from torch.profiler import ProfilerActivity, profile

        every = self.tr["reset_every"]
        calls0 = {k: len(t.calls) for k, t in self.taps.items()}
        self.sync()
        self._set_profiling(True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                self.ply()
                self.window_plies += 1
                if self.window_plies % every == 0:
                    self.reset()
            self.sync()
        self._set_profiling(False)
        calls = {k: t.calls[calls0[k]:] for k, t in self.taps.items()}
        return prof, calls

    def free_program(self):
        """Drop the program's state before the reference runs."""
        for attr in ("states", "buf", "aux", "tree", "model", "eval_tap"):
            if hasattr(self, attr):
                if attr == "eval_tap":
                    self.eval_tap.fn = None
                else:
                    delattr(self, attr)
        self.step_fn = None
        self.loop.search_root = self.search_root
        self.search_tap.calls = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
