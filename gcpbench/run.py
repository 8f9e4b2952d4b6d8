"""Run one cell of BENCHMARK.json once and print one JSON line.

    python -m gcpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program and warms every shape the cell uses; the window
then measures for `--seconds`. With `--trace 0` the result holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, read from a
profiled pass after the window. Then the program's state is freed and the
plain reference decides `correct`. The numbers compared are printed beside
their limits as the last lines on standard error and under `checks`, the
result's last key.

Exits non-zero and prints no result without a CUDA device (or with fewer
than the cell asks for), without the program beside the benchmark, or when
the process holds JAX or the JAX package after the window.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_START = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "video_gcp_tpu")


def _process_start() -> float:
    """perf_counter() at this process's start (/proc's clock ticks), or at
    this module's import where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _START



class RunError(Exception):
    """A run that cannot give a result; its exit code."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    program's own nvcc builds go to video_gcp_torch/_build/ beside it."""
    cache = root / ".gcpbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    os.environ["USE_FLAX"] = "0"  # keep transformers-like libraries off JAX


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a loop's set-up reads: the cell's files, the seed, the device;
    `hp_override` resizes the model for the CPU tests."""

    def __init__(self, cell, seed: int, device, hp_override=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.root, self.config, self.mix = cell.root, cell.config, cell.mix
        self.hp_override = hp_override


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, traced: bool, device="cuda",
             hp_override=None) -> dict:
    """One run of `cell`; returns the result (without the device entry)."""
    import torch
    from gcpbench import spec, trace as trace_mod
    start = _process_start()
    loop = spec.loop_module(cell.mix["kind"])
    state = loop.setup(Context(cell, seed, torch.device(device), hp_override))
    trace_mod.sync()
    setup_s = time.perf_counter() - start
    win = loop.window(state, seconds)
    result = dict(attempted=win["units"], failed=win["failed"])
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if torch.cuda.is_available() else 0)
    names = [m["name"] for m in (cell.per_layer if traced else cell.end_to_end)]
    units = {m["name"]: m["unit"] for m in cell.per_layer + cell.end_to_end}
    if traced:
        run = dict(cell=cell.name, window=win, unit=loop.unit_numbers(state),
                   **loop.traced(state))
        values = {n: spec.metric_reader(n)(run) for n in names}
        result["trace"] = run["trace"]
        result["breakdown"] = trace_mod.breakdown(run["trace"])
    else:
        values = dict(loop.end_to_end(state, win), setup_s=setup_s)
    result["metrics"] = {n: {"value": values[n], "unit": units[n]} for n in names
                         if values.get(n) is not None}
    loop.release(state)
    gc.collect()
    gaps = loop.check(state)
    result["checks"] = {k: {"value": gaps[k], "limit": lim} for k, lim in cell.limits.items()}
    result["correct"] = (win["failed"] == 0
                         and all(gaps[k] <= lim for k, lim in cell.limits.items()))
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    try:
        result = _run(args, root)
    except RunError as e:
        print(f"gcpbench: {e}", file=sys.stderr)
        return e.code
    print(json.dumps(result))
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0


def _run(args, root: Path) -> dict:
    from gcpbench import spec
    if not (root / "BENCHMARK.json").is_file():
        raise RunError(f"no BENCHMARK.json in {root}: run from the checkout's root", 2)
    try:
        cell = spec.load_cell(args.workload, root)
    except spec.UnknownWorkload as e:
        raise RunError(str(e), 2)
    try:
        import video_gcp_torch  # noqa: F401  the system under test
    except ImportError as e:
        raise RunError(f"the program video_gcp_torch is not beside the benchmark: {e}", 1)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        raise RunError(f"{cell.name} needs {cell.chips} CUDA device(s); "
                       f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                       f"device_count()={torch.cuda.device_count()}", 3)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        raise RunError(f"the process holds {found} after the window", 4)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": result.pop("memory_peak_bytes"),
              "card": power_limit()}
    trace = result.pop("trace", None)
    if trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = result["checks"]
    return out


if __name__ == "__main__":
    sys.exit(main())
