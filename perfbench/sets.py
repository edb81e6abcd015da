"""Runs of one cell in series, each a process of its own, and the spread
of each metric over them:

    python3 perfbench/sets.py --workload CELL --seconds S --seeds 1,2,3 \\
        [--trace 0|1] [--control 1] [--out FILE]

prints each run's last line and, at the end, per metric the median and
the spread (the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, as a share of the median); with
``--out`` also writes them as JSON. The first run of a cell in a checkout
makes the DB and builds the kernels; its set-up is left out of the
spread (``first_setup_s``)."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list[float]) -> dict:
    med = statistics.median(values)
    out = {"n": len(values), "median": med, "min": min(values),
           "max": max(values)}
    if len(values) >= 2 and med:
        q1, _, q3 = statistics.quantiles(values, n=4)
        out["spread"] = (q3 - q1) / abs(med)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--control", default="0")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
               args.workload, "--seed", seed, "--seconds", args.seconds,
               "--trace", args.trace]
        if args.control != "0":
            cmd += ["--control", args.control]
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t
        last = p.stdout.strip().splitlines()[-1:] if p.stdout.strip() else []
        res = None
        if p.returncode == 0 and last:
            res = json.loads(last[0])
        runs.append({"seed": seed, "rc": p.returncode, "wall_s": wall,
                     "result": res, "stderr": p.stderr[-3000:]})
        print(json.dumps({"seed": seed, "rc": p.returncode,
                          "wall_s": round(wall, 1)}), flush=True)
        print(p.stderr[-1500:], file=sys.stderr, flush=True)
        print(last[0] if last else "(no result)", flush=True)
    ok = [r["result"] for r in runs if r["result"]]
    summary = {"workload": args.workload, "runs": len(runs),
               "correct": [r["correct"] for r in ok], "metrics": {}}
    names = sorted({k for r in ok for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in ok
                if name in r["metrics"]]
        if name == "setup_s" and len(vals) > 1:
            summary["first_setup_s"] = vals[0]
            vals = vals[1:]
        summary["metrics"][name] = spread(vals)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"summary": summary, "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
