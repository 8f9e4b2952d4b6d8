"""Training cells of the GCP tree whose traced pass also reads the program's
own spans and counters: `loops/train.py` in everything (the checked steps in
set-up, the window back to back over a pool of batches on the device, the
reference's replay, the faults and the TF32 control), but for `traced`.

The traced pass runs `gcpbench.program_trace.program_passes` over
PROFILED_STEPS steps: a span pass, with a tracing session open, whose spans
and counters (`train.grad_mask`, `train.optimizer`, `train.update_tensors`)
reach the readers; then the profiled pass under the tree loop's wrappers, so
that the tree readers (idle, MFU, K1/K2 rooflines) read it as they read
`loops/train.py`'s, and the launch calls inside `train_step` are counted.
"""
from __future__ import annotations

import sys
import time

from gcpbench import program_trace
from gcpbench.loops.train import (  # noqa: F401  the loop's interface, shared
    BETA2, CHECKED_STEPS, FAULT_BETA2, PROFILED_STEPS, State, _step, calibration_setup,
    check, end_to_end, explain, fault_readings, gaps, program_readings,
    reference_readings, release, setup, span_targets, unit_numbers, window)


def traced(s: State) -> dict:
    """The span pass and the profiled pass, PROFILED_STEPS more steps each;
    their seconds go to standard error."""
    def work():
        for _ in range(PROFILED_STEPS):
            _step(s)
    t0 = time.perf_counter()
    program = program_trace.program_passes(work, work, span_targets(s), PROFILED_STEPS)
    print(f"gcpbench: traced passes {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return dict(trace=program["profiled"]["trace"], program=program)

