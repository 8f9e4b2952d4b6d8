"""Readings that set a cell's correctness limits (not run by the benchmark's
own runs): for each seed, the program's numbers against the reference's
(the lower readings), the control's (the reference in the precision below
the configuration's, TF32 for float32) and each planted fault's.

    python -m gcpbench.calibrate --workload <cell> --seeds <n,n,...> [--control 1]

Prints one JSON line per seed and, last, the largest program reading and
the smallest control and fault readings of each number.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gcpbench import run, spec


def readings(cell, seed: int, control: bool, device="cuda", hp_override=None,
             explain: bool = False) -> dict:
    loop = spec.loop_module(cell.mix["kind"])
    s = loop.calibration_setup(run.Context(cell, seed, device, hp_override))
    prog = loop.program_readings(s)
    loop.release(s)
    ref = loop.reference_readings(s, tf32=False)
    out = {"seed": seed, "program": loop.gaps(prog, ref)}
    if explain and hasattr(loop, "explain"):
        out["explain"] = loop.explain(prog, ref)
    if control:
        out["control"] = loop.gaps(loop.reference_readings(s, tf32=True), ref)
        for name, faulty in loop.fault_readings(s, ref).items():
            out[name] = loop.gaps(faulty, ref)
    return out


def summary(rows: list) -> dict:
    kinds = [k for k in rows[0] if k not in ("seed", "explain")]
    out = {}
    for kind in kinds:
        pick = max if kind == "program" else min
        out[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--explain", type=int, default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, Path.cwd())
    rows = []
    for seed in (int(x) for x in args.seeds.split(",")):
        rows.append(readings(cell, seed, bool(args.control), explain=bool(args.explain)))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": cell.name, "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
