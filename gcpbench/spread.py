"""Run a cell in sets of runs, one process a run, and report each metric's
spread: the distance between the first and the third quartile
(statistics.quantiles(n=4)) as a share of the median, for each set.

    python -m gcpbench.spread --workload <cell> --seeds <n,n,...> [--sets 2]
        [--seconds <s>] [--trace 0] [--out <file.jsonl>]

Every set runs the same seeds in order. The bounds of BENCHMARK.json are set
from these spreads (about five times the widest, never under 1%).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def spread(values: list) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads(Path("BENCHMARK.json").read_text())["run_seconds"]
    sets = []
    for _ in range(args.sets):
        runs = []
        for seed in args.seeds.split(","):
            cmd = [sys.executable, "-m", "gcpbench.run", "--workload", args.workload,
                   "--seed", seed, "--seconds", str(seconds), "--trace", str(args.trace)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "{}"
            run = dict(json.loads(line), seed=int(seed), rc=proc.returncode)
            if proc.returncode != 0:
                run["stderr"] = proc.stderr[-3000:]
            runs.append(run)
            print(json.dumps(run), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(run) + "\n")
        sets.append(runs)
    summary = {}
    for i, runs in enumerate(sets):
        ok = [r for r in runs if r.get("rc") == 0]
        names = ok[0]["metrics"] if ok else {}
        summary[f"set{i}"] = {
            n: {"median": statistics.median(r["metrics"][n]["value"] for r in ok),
                "spread": spread([r["metrics"][n]["value"] for r in ok]) if len(ok) > 1 else None}
            for n in names}
        summary[f"set{i}"]["correct"] = sum(bool(r.get("correct")) for r in runs)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
