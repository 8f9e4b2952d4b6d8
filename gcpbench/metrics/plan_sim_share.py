"""Share of a `_plan` call spent in the simulator's model calls
(GCPSimulator.run_model), from the span pass."""
from gcpbench.readers import span_share


def read(run):
    return span_share(run, "simulator", "plan")
