"""Readers of the per-layer metrics, shared by the files of metrics/. A
reader takes the run (its window, its unit numbers, its trace and spans) and
returns a value, or None where the run holds nothing to read."""
from __future__ import annotations

from gcpbench import yardstick


def device_idle(run):
    t = run.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run):
    w, flops = run["window"], run["unit"].get("flops")
    if not flops or not w["units"]:
        return None
    return 100.0 * flops * w["units"] / w["seconds"] / yardstick.F32_FLOPS_PER_S


def _roofline(run, kernel, bound_key):
    t, bound = run.get("trace"), run["unit"].get(bound_key)
    spent = sum(s for n, s in t.kernels.items() if kernel in n) if t else 0.0
    if not spent or not bound:
        return None
    return 100.0 * bound * t.units / spent


def k1_roofline(run):
    return _roofline(run, yardstick.K1_KERNEL, "k1_bound_s")


def k2_roofline(run):
    return _roofline(run, yardstick.K2_KERNEL, "k2_bound_s")


def span_share(run, span: str, whole: str):
    """Seconds inside `span` over seconds inside `whole`, from the span pass."""
    seconds = (run.get("spans") or {}).get("seconds", {})
    if not seconds.get(span) or not seconds.get(whole):
        return None
    return 100.0 * seconds[span] / seconds[whole]


def dtw_roofline(run):
    """The eval DTW's own bytes (read C once, write the matches) at the
    HBM's rate, over the seconds of its spans."""
    spans, nbytes = run.get("spans"), run["unit"].get("dtw_bytes")
    if not spans or not nbytes or not spans["seconds"].get("dtw"):
        return None
    least = nbytes * spans["calls"]["dtw"] / yardstick.HBM_BYTES_PER_S
    return 100.0 * least / spans["seconds"]["dtw"]
