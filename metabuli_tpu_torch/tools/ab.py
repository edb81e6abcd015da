"""End-to-end A/B of the port's classify CLI between two checkouts.

    python -m metabuli_tpu_torch.tools.ab PARENT CHANGE READS DB [--pairs 5]
        [-- CLI flags]

Runs ``metabuli_tpu_torch.cli classify READS DB`` from each checkout in
turn, one process per run (each loads the DB and its kernels as a user's
run does), alternating which checkout goes first in each pair. The CLI
flags default to chip_smoke.py's classify phase (``--seq-mode 1
--batch-reads 8192``). Each checkout's kernels and native library are built
before its first run, so no run times a build. Prints one JSON line per
run: the pair, the side, reads/s, classify_s, classified reads, stage_ms,
and the host seconds of the batches' drain (``drain_s``: the wait for
the copies to the host and the native finish; on a serial loop the
copies themselves) and of the native finish alone (``finish_s``), timed
around ``DeviceTaxonomer.drain`` and ``DeviceTaxonomer._finish``, and,
where the classifier reports them (the batch pipeline), the seconds of
the finish during which the main thread parsed or dispatched another
batch (``overlap_s``) and the finishing thread's CPU seconds in it
(``finish_cpu_s``); null otherwise.

With ``--one-process`` both checkouts' packages are imported into this
one process under names of their own, each side's classifier loads the
DB once, and the sides then take turns classifying READS (after one
run each not reported), so no process start, DB load or page cache lies
between them; the records carry ``"process": "one"``.

Both sides' DB and reads may come from
``python -m metabuli_tpu_torch.tools.world DIR`` (chip_smoke.py's).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

BUILD = ("from metabuli_tpu_torch.csrc import build; "
         "from metabuli_tpu_torch import native; "
         "build.get_lib(); native.get_lib()")


def child(checkout: str, argv) -> None:
    """One classify run from ``checkout``; prints its JSON record."""
    sys.path.insert(0, checkout)
    from metabuli_tpu_torch.classify.device_taxonomer import DeviceTaxonomer
    from metabuli_tpu_torch.cli import main

    host = {"drain_s": 0.0, "finish_s": 0.0}

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[key] += time.perf_counter() - t0
        return run

    DeviceTaxonomer.drain = timed(DeviceTaxonomer.drain, "drain_s")
    DeviceTaxonomer._finish = timed(DeviceTaxonomer._finish, "finish_s")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise SystemExit(rc)
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps({"reads_per_s": s["reads"] / s["classify_s"],
                      "classify_s": s["classify_s"],
                      "classified": s["classified"],
                      "stage_ms": s["stage_ms"], **host,
                      "overlap_s": s.get("finish_overlap_s"),
                      "finish_cpu_s": s.get("finish_cpu_s")}))


def _import_as(checkout: str, name: str):
    """``checkout``'s package imported as ``name`` (its modules import one
    another relatively, so two checkouts can share a process)."""
    import importlib.util

    pkg = os.path.join(checkout, "metabuli_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def one_process(sides: dict, reads: str, db: str, cli: list, pairs: int,
                out: str) -> None:
    """Both sides' classifiers in this process (see the module
    docstring); prints one record per reported run."""
    import importlib

    runs = {}
    for side, co in sides.items():
        name = f"_ab_{side}"
        _import_as(co, name)
        mod = lambda m: importlib.import_module(f"{name}.{m}")
        params = mod("params")
        ap = argparse.ArgumentParser()
        ap.add_argument("--device", default="cuda")
        params.add_to_parser(ap, params.ClassifyParams)
        args = ap.parse_args(cli)
        clf = mod("classify.classifier").Classifier(
            db, params.from_args(params.ClassifyParams, args),
            device=args.device)
        host = {"drain_s": 0.0, "finish_s": 0.0}
        dtx = clf.device_taxonomer
        if dtx is not None:
            for attr, key in (("drain", "drain_s"), ("_finish", "finish_s")):
                fn = getattr(dtx, attr)

                def timed(*a, _fn=fn, _key=key, _host=host, **k):
                    t0 = time.perf_counter()
                    try:
                        return _fn(*a, **k)
                    finally:
                        _host[_key] += time.perf_counter() - t0
                setattr(dtx, attr, timed)
        runs[side] = (clf, host)

    def run(side, tag):
        clf, host = runs[side]
        # a run's own counters: the classifier adds to them across runs
        clf.timer.ms.clear()
        clf.stats = dict.fromkeys(clf.stats, 0)
        for k in host:
            host[k] = 0.0
        s = clf.classify_file(reads, None, os.path.join(out, tag), "ab")
        return {"reads_per_s": s["reads"] / s["classify_s"],
                "classify_s": s["classify_s"],
                "classified": s["classified"], "stage_ms": dict(s["stage_ms"]),
                **host, "overlap_s": s.get("finish_overlap_s"),
                "finish_cpu_s": s.get("finish_cpu_s"), "process": "one"}

    for side in sides:
        run(side, f"warm_{side}")
    for i in range(pairs):
        for side in (["parent", "change"] if i % 2 else ["change", "parent"]):
            print(json.dumps({"pair": i, "side": side,
                              **run(side, f"{i}_{side}")}), flush=True)


def _run(cmd, cwd: str) -> str:
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"{cmd[:4]} in {cwd} exited {p.returncode}:\n"
                           + p.stderr[-3000:])
    return p.stdout


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cli = ["--seq-mode", "1", "--batch-reads", "8192"]
    if "--" in argv:
        cli = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch.tools.ab")
    ap.add_argument("parent", help="checkout of the parent commit")
    ap.add_argument("change", help="checkout of the change")
    ap.add_argument("reads", help="FASTA/Q to classify")
    ap.add_argument("db", help="database directory")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--one-process", action="store_true",
                    help="both checkouts in this process, the DB loaded "
                         "once a side")
    a = ap.parse_args(argv)
    sides = {"parent": os.path.abspath(a.parent),
             "change": os.path.abspath(a.change)}
    for co in sides.values():
        _run([sys.executable, "-c", BUILD], co)
    out = tempfile.mkdtemp(prefix="metabuli_ab_")
    try:
        if a.one_process:
            one_process(sides, os.path.abspath(a.reads), os.path.abspath(a.db),
                        cli, a.pairs, out)
            return 0
        for i in range(a.pairs):
            order = ["parent", "change"] if i % 2 else ["change", "parent"]
            for side in order:
                res = _run([sys.executable, os.path.abspath(__file__),
                            "--child", sides[side], "classify",
                            os.path.abspath(a.reads), os.path.abspath(a.db),
                            os.path.join(out, f"{i}_{side}"), "ab", *cli],
                           sides[side])
                rec = json.loads(res.strip().splitlines()[-1])
                print(json.dumps({"pair": i, "side": side, **rec}),
                      flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3:])
    else:
        sys.exit(main())
