"""Evaluation cells: the window drives `video_gcp_torch.evaluation.evaluator.
Evaluator.eval`, top-of-100 under the configuration's pruning scheme, on
seeded batches, whole calls back to back, with `reset()` between them.

A call is long, so the window runs whole calls: it starts one only while
the time left is at least the first timed call's length, and always runs
one. Set-up warms every shape with a top-of-1 call (two samples: the
forward, the matching and the metrics of a call). Each call draws its noise
from a generator seeded for it, so the reference can replay any call.

The window's first call is the one checked, on every example of its batch:
its metrics, its top-of-N choice, and the node each frame was matched to
by `video_gcp_torch.ops.dtw.batched_dtw_alignment`, which the call's own
DTW returns and the benchmark keeps (a reference to each result, no copy).
"""
from __future__ import annotations

import contextlib
import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from gcpbench import generate, trace, weights, yardstick
from gcpbench.program import build_model

METRIC_KEYS = ("mse", "psnr", "ssim")


class State:
    pass


def _attrdict(batch):
    from video_gcp_torch.core.attrdict import AttrDict
    return AttrDict(batch)


def _evaluator(s, top_of_100: bool):
    from video_gcp_torch.evaluation.evaluator import Evaluator
    return Evaluator(s.model, s.logdir, s.hp, s.hp["max_seq_len"],
                     pruning_scheme=s.ctx.config["evaluation"]["pruning_scheme"],
                     top_of_100=top_of_100)


def setup(ctx) -> State:
    s = State()
    s.ctx, mix = ctx, ctx.mix
    s.model, s.hp = build_model(ctx.root, ctx.config, ctx.device, ctx.hp_override)
    s.weight_seed, s.noise_seed, s.data_seed = (ctx.seed + k for k in (0, 1, 2))
    weights.assign(s.model, s.weight_seed)
    s.batches = generate.batches(mix, s.hp["img_sz"], s.data_seed, ctx.device)
    s.logdir = tempfile.mkdtemp(prefix="gcpbench_eval_")  # under TMPDIR
    s.evaluator = _evaluator(s, ctx.config["evaluation"]["top_of_100"])
    s.top_of = 100 if ctx.config["evaluation"]["top_of_100"] else 1  # the protocol's
    s.single = _evaluator(s, False)
    s.single.eval(_attrdict(s.batches[0]), _gen(s, -1))
    s.single.reset()
    s.calls = []
    return s


def _gen(s, k: int) -> torch.Generator:
    return torch.Generator(s.ctx.device).manual_seed(s.noise_seed + 1000 * k)


def _call(s, evaluator, k: int):
    res = evaluator.eval(_attrdict(s.batches[k % len(s.batches)]), _gen(s, k))
    evaluator.reset()
    return res


def calibration_setup(ctx) -> State:
    """Set-up and the window's first call, which is the one checked."""
    s = setup(ctx)
    window(s, 0.0)
    return s


@contextlib.contextmanager
def _keeping_matches(kept: list):
    """While the block runs, keep what each DTW returns."""
    from video_gcp_torch.ops import dtw
    plain = dtw.batched_dtw_alignment

    def keep(C, end_inds):
        inds, dist = plain(C, end_inds)
        kept.append(inds)
        return inds, dist

    dtw.batched_dtw_alignment = keep
    try:
        yield
    finally:
        dtw.batched_dtw_alignment = plain


def window(s: State, seconds: float) -> dict:
    times = []
    t0 = time.perf_counter()
    while True:
        first, kept = not s.calls, []
        t = time.perf_counter()
        with _keeping_matches(kept) if first else contextlib.nullcontext():
            res = _call(s, s.evaluator, len(s.calls))  # ends on the host: synchronised
        times.append(time.perf_counter() - t)
        s.calls.append({k: np.asarray(v, dtype=np.float64) for k, v in res.metrics.items()})
        if kept:  # the first call's top-of-N samples' matches, [B, N, T]
            s.calls[0]["match"] = torch.stack(kept[:s.top_of], 1).cpu().numpy()
        if seconds - (time.perf_counter() - t0) < times[0]:
            break
    failed = sum(not all(np.isfinite(v).all() for v in c.values()) for c in s.calls)
    return dict(units=len(times), seconds=sum(times), failed=failed)


def end_to_end(s: State, win: dict) -> dict:
    frames = s.top_of * generate.n_frames(s.ctx.mix) * win["units"]
    return {"eval_frames_per_s": frames / win["seconds"]}


def span_targets(s: State) -> list:
    from video_gcp_torch.evaluation import evaluator as ev
    from video_gcp_torch.ops import dtw
    return [(type(s.evaluator), "eval", "eval"), (s.model, "forward", "forward"),
            (dtw, "batched_dtw_alignment", "dtw"), (ev, "dense_sample", "matching")]


def traced(s: State) -> dict:
    """A span pass over one more top-of-100 call, and a profiled pass over
    one top-of-1 call at the window's shapes (a top-of-100 call's trace
    would hold ~2 million kernels)."""
    spans = trace.span_pass(lambda: _call(s, s.evaluator, 0), span_targets(s))
    tr = trace.profiled_pass(lambda: _call(s, s.single, 0), span_targets(s), 1)
    return dict(trace=tr, spans=spans)


def unit_numbers(s: State) -> dict:
    """Per call of the window: the prior forwards' FLOPs; per DTW call its
    bytes."""
    b = s.ctx.mix["batch"]
    nodes = 2 ** s.hp["hierarchy_levels"] - 1
    return dict(flops=s.ctx.config["flops"]["prior_forward_per_example"] * b
                * (s.top_of + min(5, s.top_of)),
                dtw_bytes=yardstick.dtw_bytes(b, nodes, s.ctx.mix["seq_len"]))


def release(s: State) -> None:
    s.batches = s.batches[:1]
    del s.model, s.evaluator, s.single
    shutil.rmtree(s.logdir, ignore_errors=True)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def checked_examples(s: State) -> list:
    """Every example of the first call's batch."""
    return list(range(len(s.batches[0]["end_ind"])))


def program_readings(s: State) -> dict:
    return s.calls[0]


def _shift(inds):
    """The planted fault: each frame takes the previous frame's match."""
    return torch.cat([inds[:, :1], inds[:, :-1]], 1)


def reference_readings(s: State, tf32: bool, alter=None) -> dict:
    """The reference's metrics and matches of the first call's examples;
    `alter` changes the matches where the DTW produces them."""
    from gcpbench.reference import evaluate, model as ref
    ref.precision(tf32)
    try:
        model = ref.build(s.hp, s.ctx.device).eval()
        weights.assign(model, s.weight_seed)
        out = evaluate.sample_metrics(
            model, s.batches[0], _gen(s, 0), s.top_of, checked_examples(s),
            s.ctx.config["evaluation"]["pruning_scheme"], s.hp["max_seq_len"], alter=alter)
    finally:
        ref.precision(False)
    del model
    gc.collect()
    return dict(out, end_ind=s.batches[0]["end_ind"].cpu().numpy())


def fault_readings(s: State, ref: dict) -> dict:
    """Planted in the reference: half of the samples left out (top-of-50:
    the first half of the reference's own samples, whose draws those are),
    and each frame matched to the previous frame's node."""
    half = {k: (v[:, :s.top_of // 2] if k in METRIC_KEYS + ("match",) else v)
            for k, v in ref.items()}
    return {"half_samples": half, "shifted_match": reference_readings(s, False, _shift)}



def gaps(prog: dict, ref: dict) -> dict:
    """Over every example of the checked call:
    `best`: the answer's relative gap, the worst of the three metrics of
    the best sample by MSE (each side its own pick), at the median example
    (`best_worst` at the worst one, not compared);
    `pick`: the share of examples whose top-of-N choice (the best sample's
    index) differs, 1 where the sides drew different numbers of samples;
    `match`: the share of matched nodes that differ, over the samples both
    sides drew and each example's frames up to its end (1 where the program
    returned no matches).
    (Where rounding flips a matching decision between frames that look
    alike, a few matches of a sample differ and its metrics move by up to
    ~1e-4 in one example: the worst example swings, the median does not.)"""
    pick_p, pick_r = np.argmin(prog["mse"], 1), np.argmin(ref["mse"], 1)
    rows = np.arange(len(pick_p))
    per_example = np.max([np.abs(prog[k][rows, pick_p] - ref[k][rows, pick_r])
                          / np.abs(ref[k][rows, pick_r]) for k in METRIC_KEYS], 0)
    pick = (float(np.mean(pick_p != pick_r)) if prog["mse"].shape == ref["mse"].shape
            else 1.0)
    out = dict(best=float(np.median(per_example)), best_worst=float(np.max(per_example)),
               pick=pick)
    if "match" in ref:
        out["match"] = 1.0
        if "match" in prog:
            n = min(prog["match"].shape[1], ref["match"].shape[1])
            frames = np.arange(ref["match"].shape[2])
            valid = (frames[None, :] <= ref["end_ind"][:, None])[:, None, :]
            differ = (prog["match"][:, :n] != ref["match"][:, :n]) & valid
            out["match"] = float(differ.sum() / (valid.sum() * n))
    return out


def explain(prog: dict, ref: dict) -> list:
    """Per example: its index, the answer's gap at its best sample, whether
    both sides picked the same sample, and the share of its matches that
    differ."""
    pick_p, pick_r = np.argmin(prog["mse"], 1), np.argmin(ref["mse"], 1)
    out = []
    for e in range(len(pick_p)):
        gap = max(abs(prog[k][e, pick_p[e]] - ref[k][e, pick_r[e]]) / abs(ref[k][e, pick_r[e]])
                  for k in METRIC_KEYS)
        row = [e, float(gap), bool(pick_p[e] == pick_r[e])]
        if "match" in prog and "match" in ref and prog["match"].shape == ref["match"].shape:
            end = int(ref["end_ind"][e]) + 1
            row.append(float(np.mean(prog["match"][e, :, :end] != ref["match"][e, :, :end])))
        out.append(row)
    return out


def check(s: State) -> dict:
    g = gaps(program_readings(s), reference_readings(s, tf32=False))
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in g.items()}
