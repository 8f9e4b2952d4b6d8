"""Share of an Evaluator.eval call spent in ops.dtw.batched_dtw_alignment,
from the span pass (each span's edges synchronised)."""
from gcpbench.readers import span_share


def read(run):
    return span_share(run, "dtw", "eval")
