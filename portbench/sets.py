"""Run one cell several times, one process a run, and summarise.

    python3 portbench/sets.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 [--trace 1] [--control float8] [--fault half_batch] \
        [--benchmark other/BENCHMARK.json] [--out file.json]

Prints each run's result line, then per metric the median and the spread
(the distance between the first and third quartiles of
statistics.quantiles(values, n=4), as a share of the median), and per
number compared its largest reading. This is how the bounds and limits in
BENCHMARK.json and limits/ were measured; the benchmark's own runs never
call it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--benchmark", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, RUN, "--workload", args.workload, "--seed",
               seed, "--seconds", str(args.seconds), "--trace",
               str(args.trace)]
        if args.control:
            cmd += ["--control", args.control]
        if args.fault:
            cmd += ["--fault", args.fault]
        if args.benchmark:
            cmd += ["--benchmark", args.benchmark]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            line = None
        runs.append({"seed": int(seed), "rc": p.returncode, "wall_s": wall,
                     "line": line, "stderr": p.stderr[-3000:]})
        print(json.dumps({"seed": int(seed), "rc": p.returncode,
                          "wall_s": round(wall, 2), "line": line}),
              flush=True)
        if line is None:
            print(p.stderr[-3000:], flush=True)
    ok = [r["line"] for r in runs if r["line"]]
    summary = {"workload": args.workload, "seconds": args.seconds,
               "trace": args.trace, "control": args.control,
               "fault": args.fault,
               "correct": [l["correct"] for l in ok], "metrics": {},
               "checks": {}}
    for name in (ok[0]["metrics"] if ok else {}):
        vals = [l["metrics"][name]["value"] for l in ok
                if name in l["metrics"]]
        summary["metrics"][name] = {
            "values": vals, "median": statistics.median(vals),
            "spread": spread(vals)}
    for name in (ok[0]["checks"] if ok else {}):
        vals = [l["checks"][name]["value"] for l in ok]
        summary["checks"][name] = {"values": vals, "max": max(vals),
                                   "min": min(vals)}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "runs": runs}, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
