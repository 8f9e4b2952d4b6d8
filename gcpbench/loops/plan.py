"""Planning cells: one caller in a closed loop sends the window's requests
to `video_gcp_torch.planning.planner_policy.ImageCEMPolicy._plan`, each a
(start, goal) image pair, timed on the host from call to return (`_plan`
copies its plan to the host, so it returns synchronised).

The policy is built from the control experiment's config as the control
runner builds it, with the pretrained weights the configuration file names.
Each request hands the planner its noise: np.random (the CEM sampler's
draws) and the simulator's host generator are seeded with the request's
seed before the call, so the reference can replay any request.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from gcpbench import maze, trace
from gcpbench.program import encode

WARM_REQUESTS = 2
KEPT_REQUESTS = 64  # the plans kept for the check, the window's first ones
CHECKED_REQUESTS = 3  # the first and two drawn from the seed
PROFILED_REQUESTS = 5


class State:
    pass


def _policy(ctx, logdir):
    from video_gcp_torch.planning.run import load_control_config
    cfg = ctx.config
    conf = load_control_config(ctx.root / cfg["experiment"])
    params = dict(conf["policy"])
    cls = params.pop("type")
    weights = str(ctx.root / cfg["weights"])
    cem = dict(params["cem_params"])
    if encode({k: v for k, v in cem.items() if k != "cost_config"}) != cfg["cem_params"]:
        raise RuntimeError("the control config's CEM parameters differ from the "
                           "configuration file's")
    cem["cost_config"] = dict(cem["cost_config"], load_epoch=weights)
    params.update(cem_params=cem, load_epoch=weights)
    if ctx.hp_override:
        params["params"] = dict(params["params"], **ctx.hp_override)
    policy = cls(dict(T=conf["agent"]["T"], device=str(ctx.device), log_dir=logdir), params)
    if not ctx.hp_override and encode(dict(policy.planner_hp)) != cfg["hparams"]:
        raise RuntimeError("the planner's hparams differ from the configuration file's")
    return policy


def _pairs(s) -> list:
    """The mix's (start, goal) uint8 image pairs, rendered in the maze from
    the mix's `pool_seed` (gcpbench/maze.py), in an order drawn from the
    run's seed. Every seed plans the same set of pairs: a plan's work
    follows its pair (the predicted lengths), so the seed orders the work
    and does not change it."""
    pairs = maze.pairs(s.ctx.mix, s.hp["img_sz"])
    return [pairs[i] for i in np.random.default_rng(s.ctx.seed).permutation(len(pairs))]


def setup(ctx) -> State:
    s = State()
    s.ctx = ctx
    s.noise_seed = ctx.seed + 1
    s.logdir = tempfile.mkdtemp(prefix="gcpbench_plan_")  # under TMPDIR
    s.policy = _policy(ctx, s.logdir)
    s.hp = dict(s.policy.planner_hp)
    s.pairs = _pairs(s)
    s.plans = []
    for k in range(WARM_REQUESTS):
        _request(s, -1 - k)
    return s


def _seed(s, k: int) -> int:
    return (s.noise_seed + 7919 * k) % 2 ** 32  # np.random takes 32 bits


def _request(s, k: int):
    start, goal = s.pairs[k % len(s.pairs)]
    np.random.seed(_seed(s, k))
    s.policy._cem_simulator.host_generator.manual_seed(_seed(s, k))
    t = time.perf_counter()
    s.policy._plan(start, goal[None], 0)
    elapsed = time.perf_counter() - t
    s.policy._cem_planner.log_verbose(None, 0, "val", 0, None)  # as after a task
    return elapsed


def _outputs(policy) -> dict:
    return dict(images=np.asarray(policy.image_plan), cost=float(policy.plan_cost))


def window(s: State, seconds: float) -> dict:
    times = []
    t0 = time.perf_counter()
    while True:
        times.append(_request(s, len(times)))
        if len(s.plans) < KEPT_REQUESTS:
            s.plans.append(_outputs(s.policy))
        if time.perf_counter() - t0 >= seconds:
            break
    failed = sum(not (np.isfinite(p["cost"]) and np.isfinite(p["images"]).all())
                 for p in s.plans)
    return dict(units=len(times), seconds=sum(times), failed=failed, times=times)


def calibration_setup(ctx) -> State:
    s = setup(ctx)
    while len(s.plans) < KEPT_REQUESTS:
        _request(s, len(s.plans))
        s.plans.append(_outputs(s.policy))
    return s


def end_to_end(s: State, win: dict) -> dict:
    return {"plan_ms.p95": 1e3 * float(np.percentile(win["times"], 95))}


def span_targets(s: State) -> list:
    from video_gcp_torch.planning import planner_policy
    sim = s.policy._cem_simulator
    return [(planner_policy.ImageCEMPolicy, "_plan", "plan"),
            (sim, "run_model", "simulator"), (s.policy._cem_planner._cost_fcn, "net", "cost"),
            (s.policy._cem_planner._sampler, "sample", "sampler")]


def traced(s: State) -> dict:
    """A span pass and a profiled pass of PROFILED_REQUESTS requests each;
    the span pass also counts the simulator's candidates."""
    sim = s.policy._cem_simulator
    candidates = []
    plain = sim.run_model

    def counted(inputs):
        candidates.append(int(inputs.I_0.shape[0]))
        return plain(inputs)

    def work():
        for k in range(PROFILED_REQUESTS):
            _request(s, k)

    sim.run_model = counted
    try:
        spans = trace.span_pass(work, span_targets(s))
    finally:
        del sim.run_model
    spans["candidates_per_request"] = sum(candidates) / PROFILED_REQUESTS
    return dict(trace=trace.profiled_pass(work, span_targets(s), PROFILED_REQUESTS),
                spans=spans)


def unit_numbers(s: State) -> dict:
    return dict(flops_per_candidate=s.ctx.config["flops"]["plan_forward_per_candidate"])


def release(s: State) -> None:
    del s.policy
    shutil.rmtree(s.logdir, ignore_errors=True)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def checked_requests(s: State) -> list:
    rng = np.random.default_rng(s.ctx.seed)
    rest = rng.permutation(np.arange(1, len(s.plans)))[:CHECKED_REQUESTS - 1]
    return [0] + sorted(int(k) for k in rest)


def program_readings(s: State) -> dict:
    return {k: s.plans[k] for k in checked_requests(s)}


def reference_readings(s: State, tf32: bool) -> dict:
    """The reference's plans of the checked requests."""
    from gcpbench.reference import model as ref, plan as ref_plan
    ref.precision(tf32)
    try:
        hp = dict(s.ctx.config["hparams"], **(s.ctx.hp_override or {}))
        cem = ref_plan.planner(hp, _classless(s.ctx.config["cem_params"]),
                               str(s.ctx.root / s.ctx.config["weights"]), s.ctx.device)
        out = {}
        for k in checked_requests(s):
            start, goal = s.pairs[k % len(s.pairs)]
            out[k] = ref_plan.plan(cem, start, goal, _seed(s, k))
    finally:
        ref.precision(False)
    del cem
    gc.collect()
    return out


def _classless(cem_params: dict) -> dict:
    """The file's CEM parameters without the classes (the reference brings its own)."""
    return {k: v for k, v in cem_params.items() if k not in ("sampler", "cost_fcn")}


def fault_readings(s: State, ref: dict) -> dict:
    """Planted in the reference: the plan handed back reversed in time."""
    return {"reversed_plan": {k: dict(p, images=p["images"][::-1]) for k, p in ref.items()}}


def gaps(prog: dict, ref: dict) -> dict:
    """Worst over the checked requests: the plan cost's relative gap, and
    the widest gap of the plan (its frames and latents as `_plan` returns
    them) over its largest reference magnitude (1 where the plans' lengths
    differ)."""
    def widest(a, b):
        if a.shape != b.shape:
            return 1.0
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    return dict(
        cost=max(abs(prog[k]["cost"] - ref[k]["cost"]) / abs(ref[k]["cost"]) for k in ref),
        plan=max(widest(prog[k]["images"], ref[k]["images"]) for k in ref))


def check(s: State) -> dict:
    g = gaps(program_readings(s), reference_readings(s, tf32=False))
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in g.items()}
