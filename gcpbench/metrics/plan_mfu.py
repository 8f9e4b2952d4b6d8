"""The planner's share of the card's float32 peak: the simulator's candidate
forwards of a `_plan` (counted in the span pass) times the reference's FLOPs
of one, over the window's mean `_plan` seconds. The learned cost's MLP adds
under 1e-4 of that and is left out."""
from gcpbench import yardstick


def read(run):
    w, spans = run["window"], run.get("spans") or {}
    per = run["unit"].get("flops_per_candidate")
    n = spans.get("candidates_per_request")
    if not per or not n or not w["units"]:
        return None
    return 100.0 * n * per * w["units"] / w["seconds"] / yardstick.F32_FLOPS_PER_S
