"""Training cells: the window drives `video_gcp_torch.parallel.train_step.
train_step` back to back, on the configuration's RAdam, with a seeded
device generator, over a pool of batches resident on the device.

Set-up builds the one model and optimizer, drives them through their first
CHECKED_STEPS steps (which also run every shape of the window) and keeps
what those steps read; the window goes on from there. The reference follows
those steps from the same weights, batches and noise.

RAdam moves by the bias-corrected momentum alone while rho_t <= 5 (steps
1-5 at beta2 0.999); from step 6 on it takes the rectified update, the one
every step of the window takes. Eight checked steps hold three rectified
updates in the change, so beta2, eps and the rectification are compared.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from gcpbench import generate, trace, weights, yardstick
from gcpbench.program import build_model

CHECKED_STEPS = 8  # of the pool's 8 batches: three rectified RAdam updates
BETA2 = 0.999  # RAdam's second-moment decay in the program (make_optimizer)
FAULT_BETA2 = 0.99
PROFILED_STEPS = 4


class State:
    pass


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def setup(ctx) -> State:
    from video_gcp_torch.parallel import train_step as ts
    s = State()
    s.ctx, s.ts, cfg, mix = ctx, ts, ctx.config, ctx.mix
    s.model, s.hp = build_model(ctx.root, cfg, ctx.device, ctx.hp_override)
    s.model.train()
    if mix["seq_len"] != s.hp["max_seq_len"]:
        raise ValueError(f"the mix's seq_len {mix['seq_len']} is not the configuration's "
                         f"max_seq_len {s.hp['max_seq_len']}")
    if mix["pool_batches"] < CHECKED_STEPS:
        raise ValueError(f"the checked steps read {CHECKED_STEPS} different batches; "
                         f"the mix's pool holds {mix['pool_batches']}")
    s.weight_seed, s.noise_seed, s.data_seed = (ctx.seed + k for k in (0, 1, 2))
    weights.assign(s.model, s.weight_seed)
    opt = cfg["optimizer"]
    s.opt = ts.make_optimizer([p for p in s.model.parameters() if p.requires_grad],
                              opt["name"], lr=opt["lr"], beta=opt["beta"])
    s.batches = generate.batches(mix, s.hp["img_sz"], s.data_seed, ctx.device)
    s.gen = torch.Generator(ctx.device).manual_seed(s.noise_seed)
    s.step = 0
    losses = []
    for k in range(CHECKED_STEPS):
        m = _step(s)
        losses.append(m.total)
        if k == 0:  # the first gradient as the optimizer got it: exp_avg = (1 - b1) g
            s.first_grad = _norms({
                n: s.opt.state[p]["exp_avg"] / (1 - opt["beta"]) if p in s.opt.state
                else torch.zeros(()) for n, p in s.model.named_parameters()
                if p.requires_grad})
    start = weights.seeded_values(s.model.named_parameters(), s.weight_seed, ctx.device)
    s.change = _norms({n: p.detach() - start[n] for n, p in s.model.named_parameters()
                       if n in start})
    s.losses = [float(v) for v in losses]
    return s


def _step(s):
    batch = s.batches[s.step % len(s.batches)]
    m = s.ts.train_step(s.model, s.opt, _attrdict(batch), s.step, s.gen)
    s.step += 1
    return m


def _attrdict(batch):
    from video_gcp_torch.core.attrdict import AttrDict
    return AttrDict(batch)


def window(s: State, seconds: float) -> dict:
    flags = []
    trace.sync()
    t0 = time.perf_counter()
    while True:
        m = _step(s)
        flags.append(m.grads_finite & torch.isfinite(m.total))
        if time.perf_counter() - t0 >= seconds:
            break
    trace.sync()
    elapsed = time.perf_counter() - t0
    return dict(units=len(flags), seconds=elapsed,
                failed=int((~torch.stack(flags)).sum()))


def end_to_end(s: State, win: dict) -> dict:
    return {"train_frames_per_s": win["units"] * generate.n_frames(s.ctx.mix) / win["seconds"]}


def span_targets(s: State) -> list:
    levels = [(lvl, "forward", "tree_level") for lvl in s.model.tree_levels]
    return [(s.ts, "train_step", "train_step"), (s.model.encoder, "forward", "encoder"),
            *levels, (s.model.decoder, "forward", "decoder"),
            (torch.autograd, "backward", "backward"), (s.opt, "step", "optimizer")]


def traced(s: State) -> dict:
    """The profiled pass: PROFILED_STEPS more steps."""
    def work():
        for _ in range(PROFILED_STEPS):
            _step(s)
    return dict(trace=trace.profiled_pass(work, span_targets(s), PROFILED_STEPS))


def unit_numbers(s: State) -> dict:
    """What the per-layer readers need of one unit (a step)."""
    b, t = s.ctx.mix["batch"], s.ctx.mix["seq_len"]
    sites = yardstick.train_gn_sites(s.hp, b, t)
    return dict(flops=s.ctx.config["flops"]["train_step_per_example"] * b,
                k1_bound_s=sum(yardstick.k1_bound_s(x) for x in sites),
                k2_bound_s=sum(yardstick.k2_bound_s(x) for x in sites))


def release(s: State) -> None:
    """Free the program's state; keep the readings and the inputs."""
    s.batches = s.batches[:CHECKED_STEPS]
    del s.model, s.opt, s.gen
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_readings(s: State, tf32: bool, batches=None, beta2: float = BETA2) -> dict:
    """The reference's checked steps from the same weights, batches and
    noise: each step's loss, the first gradient's and the change's norms."""
    batches = s.batches if batches is None else batches
    from gcpbench.reference import model as ref
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


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, and the
    worst leaf's gap of the first gradient's and of the change's norms (the
    change over the leaves the reference's gradient moves)."""
    moving = yardstick.moving_leaves(ref["first_grad"])
    return dict(
        loss=max(yardstick.rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])),
        first_grad=yardstick.leaf_gap(prog["first_grad"], ref["first_grad"]),
        change=yardstick.leaf_gap(prog["change"], ref["change"], moving),
        change_median=statistics.median(
            yardstick.rel_gap(prog["change"][n], ref["change"][n]) for n in moving))


def explain(prog: dict, ref: dict, top: int = 4) -> dict:
    """The leaves that set `first_grad` and `change`: name, gap, the
    program's and the reference's norms, and the median leaf's norm."""
    out = {}
    for key in ("first_grad", "change"):
        names = yardstick.moving_leaves(ref["first_grad"]) if key == "change" else list(ref[key])
        med = statistics.median(ref[key][n] for n in names)
        gap = {n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med) for n in names}
        out[key] = [[n, gap[n], prog[key][n], ref[key][n], med]
                    for n in sorted(gap, key=gap.get, reverse=True)[:top]]
    return out


calibration_setup = setup  # the checked steps need no window


def fault_readings(s: State, ref: dict) -> dict:
    """Planted in the reference: half of each batch left out, the mean
    taken over the rest; and RAdam with a wrong beta2, which only the
    rectified updates read. (A step that leaves its state unchanged reads 1
    on `change_median` by its measure and needs no run.)"""
    half = [{k: v[:len(v) // 2] for k, v in b.items()} for b in s.batches[:CHECKED_STEPS]]
    return {"half_batch": reference_readings(s, tf32=False, batches=half),
            "wrong_beta2": reference_readings(s, tf32=False, beta2=FAULT_BETA2)}


def program_readings(s: State) -> dict:
    return dict(losses=s.losses, first_grad=s.first_grad, change=s.change)


def check(s: State) -> dict:
    g = gaps(program_readings(s), reference_readings(s, tf32=False))
    if any(math.isnan(v) for v in g.values()):
        g = {k: math.inf if math.isnan(v) else v for k, v in g.items()}
    return g
