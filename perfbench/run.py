"""One run of one benchmark cell of the port's ``classify``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration (``perfbench/configs/<name>.json``: the reference DB and
the classify settings) and a traffic mix (``perfbench/traffic/<name>.json``:
the reads). A run

1. makes the DB on its first use in the checkout (``perfbench/cache/``),
   and draws the run's samples from ``--seed`` (FASTQ files in TMPDIR);
2. builds the program's libraries (a checkout's first run compiles
   them), then one ``Classifier`` of the DB (timed: ``db_load_s``), and
   classifies one warm-up sample;
3. calls ``classify_file`` on the samples, one after another in turn,
   until the first that ends after ``--seconds`` (the window);
4. checks the written lines against the plain reference on reads drawn
   from the seed, and every report against the lines;
5. prints the compared numbers with their limits on standard error, then
   one JSON line on standard output: the end-to-end metrics, or with
   ``--trace 1`` the per-layer metrics (``perfbench/metrics/<name>.py``)
   read from the summaries, the program's counters and a profiler trace.

``--control 1`` puts the reference, with its scores kept in bfloat16,
in the program's place (the check's control; never run by the check).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import (dbcache, modules, peaks, program, reference,  # noqa: E402
                     taxonomer, trace, traffic)


def log(*parts):
    print("perfbench:", *parts, file=sys.stderr, flush=True)


def load_cell(root: str, bench: str, name: str):
    """(cell, configuration, mix, BENCHMARK.json) of workload ``name``."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(bench, "traffic", cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    return cell, cfg, mix, spec


def read_metric(bench: str, name: str, ctx):
    """Per-layer metric ``name`` from its reader, ``metrics/<name>.py``."""
    path = os.path.join(bench, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def check_reads(mix: dict, seed: int, k: int) -> np.ndarray:
    """The reads of sample ``k`` whose lines are checked, drawn from the
    seed."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 1 << 20, k])
    n = min(mix["check_reads"], mix["reads"])
    return np.sort(rng.choice(mix["reads"], size=n, replace=False))


def judge_pass(lines: list[str], report: str, sample, want: dict,
               tax) -> dict:
    """Counts of what one classified sample got wrong: rows missing, out
    of place or with another read length than their read's, checked lines
    unlike the reference's, a report unlike the one its lines give."""
    body = lines[1:]
    names = sample.names()
    read_lens = sum(reference.used_len(m.lens) for m in sample.mates)
    bad = abs(len(body) - len(names))
    for i, ln in enumerate(body[:len(names)]):
        cols = ln.split("\t", 4)
        if (len(cols) < 5 or cols[1] != names[i]
                or cols[3] != str(read_lens[i])):
            bad += 1
    wrong = sum(1 for i, ref in want.items()
                if i >= len(body) or body[i] != ref)
    return {"rows_bad": bad, "lines_mismatched": wrong,
            "reports_mismatched": int(reference.report(tax, body) != report)}


def main(argv=None, device: str = "cuda", root: str = ROOT,
         bench: str = HERE, t0: float = T0) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)
    cell, cfg, mix, spec = load_cell(root, bench, args.workload)
    if importlib.util.find_spec("metabuli_tpu_torch") is None:
        log("the program (metabuli_tpu_torch) is not in this checkout")
        return 2
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    work = tempfile.mkdtemp(prefix="perfbench-")
    try:
        return run(args, cell, cfg, mix, spec, device, bench, work, t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(args, cell, cfg, mix, spec, device, bench, work, t0) -> int:
    cuda = device == "cuda"
    db = dbcache.ensure(cfg, os.path.join(bench, "cache"), device, log=log)
    settings = cfg["classify"]
    n_samples = mix["samples"]
    # the warm-up sample is drawn after the window's
    samples = [traffic.sample(mix, db.genomes, args.seed, k)
               for k in range(n_samples + 1)]
    files = [s.write(work, f"s{k}") for k, s in enumerate(samples)]
    q = lambda k: (files[k][0], files[k][1] if len(files[k]) > 1 else None)

    ctx = SimpleNamespace(batches=0, stage_ms={}, main_cpu_s=None,
                          finish_s=0.0, finish_overlap_s=0.0, launches={},
                          trace=None, trace_complete=False, k2_bytes=None,
                          index_resident_bytes=None, peaks=peaks.H100_SXM)
    passes: list[tuple[int, str]] = []
    metrics = {}
    peak = 0
    if not args.control:
        # the libraries are built before the timed load: only a
        # checkout's first run builds them, and db_load_s is the load alone
        program.build(cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        clf = program.classifier(db.db_dir, settings, device)
        if cuda:
            torch.cuda.synchronize()
        db_load_s = time.perf_counter() - t
        if cuda:
            ctx.index_resident_bytes = torch.cuda.memory_allocated()
        # where the reader cuts a batch: --batch-reads 0 sizes it here
        batch_reads, batch_bases = clf.par.batch_reads, clf.batch_bases
        log(f"db_load_s {db_load_s:.3f}; a batch: {batch_reads} reads"
            + (f" or {batch_bases} bases" if batch_bases else ""))
        profiling = args.trace == 1
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # warm-up: one sample through the whole path (under a throwaway
        # profile in a traced run: a kernel's first trace in a process
        # can miss launches)
        with (torch.profiler.profile(activities=acts) if profiling
              else nullcontext()):
            clf.classify_file(*q(n_samples), os.path.join(work, "warm"),
                              "job")
        gc.collect()
        before_ms = dict(clf.timer.ms)
        before_launches = program.launches()
        prof = (torch.profiler.profile(activities=acts) if profiling
                else nullcontext())
        main_cpu = finish = overlap = 0.0
        reads = batches = 0
        sample_s = []
        tw0 = time.perf_counter()
        setup_s = tw0 - t0
        with prof:
            with torch.profiler.record_function("window"):
                while True:
                    k = len(passes) % n_samples
                    out = os.path.join(work, f"p{len(passes)}")
                    ts = time.perf_counter()
                    with torch.profiler.record_function("classify_file"):
                        s = clf.classify_file(*q(k), out, "job")
                    sample_s.append(time.perf_counter() - ts)
                    passes.append((k, out))
                    # (the summary's "reads" counts every call of the
                    # Classifier; a sample's lines are all checked below)
                    reads += mix["reads"]
                    batches += s["batches"]
                    main_cpu += s["main_cpu_s"]
                    finish += s["finish_s"]
                    overlap += s["finish_overlap_s"]
                    if time.perf_counter() - tw0 >= args.seconds:
                        break
        window_s = time.perf_counter() - tw0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        ctx.batches = batches
        ctx.stage_ms = {k: v - before_ms.get(k, 0.0)
                        for k, v in clf.timer.ms.items()}
        after = program.launches()
        ctx.launches = {k: v - before_launches.get(k, 0)
                        for k, v in after.items()}
        ctx.main_cpu_s, ctx.finish_s, ctx.finish_overlap_s = (
            main_cpu, finish, overlap)
        if profiling:
            ctx.trace = trace.from_profiler(prof)
            ctx.trace_complete = (ctx.trace is not None
                                  and trace.launches_agree(ctx.trace,
                                                           ctx.launches))
            if not ctx.trace_complete:
                log("the trace misses launches the program counted; no "
                    f"profiler metric (counted {ctx.launches})")
        metrics = {"reads_per_s": reads / window_s, "db_load_s": db_load_s,
                   "setup_s": setup_s}
        if cuda:
            metrics["peak_device_gib"] = peak / 2**30
        log(f"window {window_s:.3f} s, {len(passes)} samples, {reads} reads, "
            f"setup {setup_s:.3f} s, main thread CPU {main_cpu:.3f} s, "
            f"finish {finish:.3f} s; samples "
            + " ".join(f"{x:.3f}" for x in sample_s))
        del clf, prof
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # ---- the check, after the window, on the freed card
    t = time.perf_counter()
    table = reference.Table(db.values(), db.taxids(), db.taxonomy, device)
    log(f"reference table {time.perf_counter() - t:.3f} s")
    par = taxonomer.Params(seq_mode=settings["seq_mode"])

    def lines_of(k: int, num) -> dict:
        """The reference's lines of sample ``k``'s checked reads."""
        idx = check_reads(mix, args.seed, k)
        names = samples[k].names()
        return dict(zip(idx.tolist(), reference.classify_reads(
            table, [m.take(idx) for m in samples[k].mates],
            [names[i] for i in idx], par, num)))

    want = {k: lines_of(k, taxonomer.F32) for k in range(n_samples)}
    counts = {"rows_bad": 0, "lines_mismatched": 0, "reports_mismatched": 0}
    checked = 0
    if args.control:
        counts = {"lines_mismatched": 0}
        for k in range(n_samples):
            got = lines_of(k, taxonomer.bf16)
            counts["lines_mismatched"] += sum(got[i] != want[k][i]
                                              for i in got)
            checked += len(got)
    else:
        for k, out in passes:
            with open(os.path.join(out, "job_classifications.tsv")) as fh:
                lines = fh.readlines()
            with open(os.path.join(out, "job_report.tsv")) as fh:
                rep = fh.read()
            for key, v in judge_pass(lines, rep, samples[k], want[k],
                                     db.taxonomy).items():
                counts[key] += v
            checked += len(want[k])
    log(f"reference {time.perf_counter() - t:.3f} s, {checked} lines checked")
    if args.trace and not args.control:
        t = time.perf_counter()
        ctx.k2_bytes = k2_window_bytes(table, samples, passes, batch_reads,
                                       batch_bases)
        log(f"k2 bytes {ctx.k2_bytes} ({time.perf_counter() - t:.3f} s); "
            f"{ctx.batches} batches")
    del table
    attempted = mix["reads"] * max(len(passes), 1 if args.control else 0)
    failed = counts.get("rows_bad", 0) + counts["lines_mismatched"]
    correct = all(v == 0 for v in counts.values())

    names = [m["name"] for m in spec["per_layer" if args.trace
                                     else "end_to_end"]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    out_metrics = {}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    for name in names:
        if args.control:
            continue
        if args.trace:
            v = read_metric(bench, name, ctx)
            if v is not None:
                out_metrics[name] = {"value": v, "unit": units[name]}
        elif name in metrics:
            out_metrics[name] = {"value": metrics[name], "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        dev["busy_s"] = trace.busy_s(ctx.trace)
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(ctx.trace),
                               "idle_gaps": trace.idle_gaps(ctx.trace)}
    bad = modules.forbidden(sys.modules)
    if bad:
        log("the process loaded JAX or the JAX package: " + ", ".join(bad))
        return 3
    limits = {k: {"value": v, "limit": 0} for k, v in counts.items()}
    result["checks"] = limits
    for k, v in limits.items():
        print(f"perfbench: check {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def k2_window_bytes(table, samples, passes, batch_reads: int,
                    batch_bases: int) -> int:
    """The least bytes of the window's K2 launches: each sample's batches,
    cut as the program's reader cuts them, joined by the reference, times
    the passes of that sample."""
    per_sample = {}
    for k in sorted({k for k, _ in passes}):
        mates = samples[k].mates
        per_sample[k] = sum(
            reference.k2_bytes(table, [m.part(a, b) for m in mates])["bytes"]
            for a, b in reference.cuts(sum(m.lens for m in mates),
                                       batch_reads, batch_bases))
    return sum(per_sample[k] for k, _ in passes)


if __name__ == "__main__":
    sys.exit(main())
