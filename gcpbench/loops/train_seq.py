"""Training cells of the sequential VRNN: the tree's training loop
(`loops/train.py`: the checked steps in set-up, the window back to back over
a pool of batches on the device, the reference's replay, the faults and the
TF32 control) with the reference's `SequentialModel` in its place.

A step rolls the VRNN max_seq_len - 1 dependent steps, forward and back, on
the order of 10^5 launch calls. The traced pass runs the program's own spans
and counters (`gcpbench.program_trace.program_passes`) over PROFILED_STEPS
steps, so that `model.rollout`, `rollout.bwd` and the launch calls inside
`train_step` reach the readers.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from gcpbench import program_trace, weights
from gcpbench.loops.train import (  # noqa: F401  the loop's interface, shared
    CHECKED_STEPS, BETA2, FAULT_BETA2, State, _norms, _step, calibration_setup,
    end_to_end, explain, gaps, program_readings, release, setup, window)

PROFILED_STEPS = 2  # a step holds ~10^5 launch calls: two make a trace of ~0.4 GB


def span_targets(s: State) -> list:
    return [(s.ts, "train_step", "train_step"), (s.model.encoder, "forward", "encoder"),
            (s.model, "predict_sequence", "predict_sequence"),
            (s.model.decoder, "forward", "decoder"),
            (torch.autograd, "backward", "backward"), (s.opt, "step", "optimizer")]


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


def unit_numbers(s: State) -> dict:
    """What the per-layer readers need of one unit (a step): its FLOPs."""
    return dict(flops=s.ctx.config["flops"]["train_step_per_example"] * s.ctx.mix["batch"])


def reference_readings(s: State, tf32: bool, batches=None, beta2: float = BETA2) -> dict:
    """The reference VRNN's checked steps from the same weights, batches and
    noise: each step's loss, the first gradient's and the change's norms."""
    batches = s.batches if batches is None else batches
    from gcpbench.reference import sequential_model as ref
    ref.precision(tf32)
    try:
        model = ref.build(s.hp, s.ctx.device).train()
        weights.assign(model, s.weight_seed)
        opt_cfg = s.ctx.config["optimizer"]
        opt = ref.RAdam([p for p in model.parameters() if p.requires_grad],
                        lr=opt_cfg["lr"], betas=(opt_cfg["beta"], beta2))
        gen = torch.Generator(s.ctx.device).manual_seed(s.noise_seed)
        losses = []
        for k in range(CHECKED_STEPS):
            loss, grads = ref.train_step(model, opt, batches[k], k, gen)
            losses.append(float(loss))
            if k == 0:
                first_grad = _norms(grads)
        start = weights.seeded_values(model.named_parameters(), s.weight_seed, s.ctx.device)
        change = _norms({n: p.detach() - start[n] for n, p in model.named_parameters()
                         if n in start})
    finally:
        ref.precision(False)
    del model, opt
    gc.collect()
    return dict(losses=losses, first_grad=first_grad, change=change)


def fault_readings(s: State, ref: dict) -> dict:
    """Planted in the reference, as the tree's loop plants them: half of
    each batch left out, and RAdam with a wrong beta2."""
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in s.batches[:CHECKED_STEPS]]
    return {"half_batch": reference_readings(s, tf32=False, batches=half),
            "wrong_beta2": reference_readings(s, tf32=False, beta2=FAULT_BETA2)}


def check(s: State) -> dict:
    g = gaps(program_readings(s), reference_readings(s, tf32=False))
    return {k: math.inf if math.isnan(v) else v for k, v in g.items()}
