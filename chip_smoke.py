"""Smoke run of the PyTorch port's classify path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  device    the CUDA device, its capability (must be 9.0), and
            nvidia-smi's name and power limit
  build     nvcc builds the kernels, g++ the native host library
  probes    the device-cost probes P1-P4 (metabuli_tpu_torch.tools.probes,
            not on the classify path) against their plain versions at the
            profiling scripts' sizes, with their median ms
  db        the smoke DB: the adversarial "skew" world of
            metabuli_tpu_torch.tools.world (2 genera x 192 species, a 6 kb
            wobble-diverged core + 94 kb unique each; the same genomes as
            bench.py's from the same seed), 6-frame metamers of
            every genome window extracted with K1, unique per (value,
            species), padded with never-matching decoy rows to 2^28 rows
  kernels   K1-K4 against their plain versions at the main path's shapes
            (8,192 reads of 150 bp), and K1 also at the DB build's shape
            (one launch of 64 genomes of 100 kb): integers equal, float32
            bitwise; the median ms of each over 5 runs after a warm-up,
            from CUDA events, for the wrapper (ms) and the plain version;
            its kernels' device time alone (launch_ms, mean of 5 from a
            torch.profiler trace); bound_ms from the batch's own bytes
            (tools/probes.bound); K2's stash size and the warps whose write
            walked again
  parity    one 8,192-read batch classified through the kernels and
            through the plain versions gives identical classification lines
  tiny      the two-genome world of .claude/skills/verify/SKILL.md through
            the CLI: all 120 reads classified, the report 50/50
  classify  the CLI on 65,536 reads of 150 bp (tools.world.sample_reads,
            max_mut 2, 10 % random reads), 8,192 per batch: reads/s, stage
            times, peak memory, and every kernel's launch count > 0

The last three lines are the kernels' JSON record (K1-K4, then the probes
P1-P4 with their launches in the classify run, 0 since they are off the
path, and launch_ms = their wrapper ms), nvidia-smi's name and power
limit, and the device record.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS = 1 << 28  # smoke DB rows after decoy padding
DB_CHUNK = 64   # genomes per K1 launch of the DB build
# classified reads of the 65,536 (world and reads from seed 0): the count
# every earlier run of this script gave on the card
CLASSIFIED = 58_985

# kernel name -> its CUDA functions, as the profiler names them
KERNEL_FUNCTIONS = {"extract_metamers": ["extract_kernel"],
                    "search_scan": ["count_kernel", "write_kernel"],
                    "chain_matches": ["chain_kernel"],
                    "combine_paths": ["combine_kernel"]}

KERNELS = [
    # name, source, the XLA block it replaces
    ("extract_metamers", "metabuli_tpu_torch/csrc/extract.cu",
     "metabuli_tpu/ops/encode.py:72"),
    ("search_scan", "metabuli_tpu_torch/csrc/search_scan.cu",
     "metabuli_tpu/classify/pipeline.py:607"),
    ("chain_matches", "metabuli_tpu_torch/csrc/chain.cu",
     "metabuli_tpu/classify/device_chain.py:89"),
    ("combine_paths", "metabuli_tpu_torch/csrc/combine.cu",
     "metabuli_tpu/classify/device_combine.py:66"),
]


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def fail(phase: str, msg: str) -> None:
    print(f"[{phase}] FAILED: {msg}", flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ world
def build_db(db_dir: str, tax, genomes, device, rows: int = 0) -> dict:
    """Metamer DB of species-level genomes: 6-frame metamers of every
    window (K1, DB_CHUNK genomes a launch), unique per (value, species)
    (each genome is its own species, so the LCA taxid is that species),
    optionally padded with decoy rows to ``rows`` (the decoy scheme of
    the repository's benchmark script, bench.py)."""
    import torch

    from metabuli_tpu_torch.db.formats import DbParameters
    from metabuli_tpu_torch.db.index import MetamerIndex
    from metabuli_tpu_torch.ops import encode
    from metabuli_tpu_torch.ops.encode import srl
    from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded

    t0 = time.perf_counter()
    sp_int = [tax.to_internal(sp) for _, sp in genomes]
    assert all(int(tax.species_of[t]) == t for t in sp_int)
    vals, taxs = [], []
    for i in range(0, len(genomes), DB_CHUNK):
        chunk = genomes[i:i + DB_CHUNK]
        codes, lens = encode_seqs_padded([g for g, _ in chunk])
        mm = encode.extract_metamers(torch.from_numpy(codes).to(device),
                                     torch.from_numpy(lens).to(device))
        t = torch.tensor(sp_int[i:i + DB_CHUNK], dtype=torch.int64,
                         device=device)
        vals.append(mm.value[mm.valid])
        taxs.append(t[:, None, None].expand(mm.valid.shape)[mm.valid])
        del mm
    v = torch.cat(vals)
    t = torch.cat(taxs)
    del vals, taxs
    flip = -(1 << 63)  # signed order of v ^ 2^63 == unsigned order of v

    def sort_vt(v, t):
        o = torch.sort(t, stable=True)[1]
        o = o[torch.sort(v[o] ^ flip, stable=True)[1]]
        return v[o], t[o]

    v, t = sort_vt(v, t)
    keep = torch.ones(v.numel(), dtype=torch.bool, device=device)
    keep[1:] = (v[1:] != v[:-1]) | (t[1:] != t[:-1])
    v, t = v[keep], t[keep]
    n_real = int(v.numel())
    n_decoys = max(0, rows - n_real) if rows else 0
    if n_decoys:
        # bench.py's decoys: uniform 40-bit AA keys (colliding
        # keys dropped, so every genome-derived group stays as it is),
        # uniform codons, taxids drawn from the real species; a 0.1 %
        # surplus of draws makes up for the dropped keys so the table has
        # exactly `rows`
        rng = np.random.default_rng(12345)
        n_draw = n_decoys + n_decoys // 1000 + 1024
        aa = torch.from_numpy(rng.integers(0, 1 << 40, size=n_draw,
                                           dtype=np.uint64).view(np.int64))
        aa = aa.to(device)
        aa = aa[~torch.isin(aa, torch.unique(srl(v, 24)))][:n_decoys]
        dna = torch.from_numpy(rng.integers(0, 1 << 24, size=aa.numel(),
                                            dtype=np.int64)).to(device)
        species = np.unique(np.asarray(sp_int, np.int64))
        dt = torch.from_numpy(rng.choice(species, size=aa.numel())).to(device)
        v, t = sort_vt(torch.cat([v, (aa << 24) | dna]), torch.cat([t, dt]))
        del aa, dna, dt
    values = v.cpu().numpy().view(np.uint64)
    taxids = t.to(torch.int32).cpu().numpy().view(np.uint32)
    del v, t, keep
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    aa = values >> np.uint64(24)
    change = np.nonzero(aa[1:] != aa[:-1])[0]
    bounds = np.concatenate([[-1], change, [len(aa) - 1]])
    max_group = int(np.diff(bounds).max())
    del aa, change, bounds
    MetamerIndex(values=values, taxids=taxids, taxonomy=tax,
                 params=DbParameters(db_name="smoke", skip_redundancy=1),
                 max_group=max_group).save(db_dir)
    return {"rows": len(values), "genome_rows": n_real,
            "decoy_rows": len(values) - n_real, "max_group": max_group,
            "build_s": round(t1 - t0, 3),
            "write_s": round(time.perf_counter() - t1, 3)}


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")


def run_cli(argv) -> dict:
    """metabuli_tpu_torch.cli.main(argv); returns its JSON summary."""
    from metabuli_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"cli exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# ---------------------------------------------------------------- kernels
def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over every output; integers compare
    exactly and float32 outputs must also match bit for bit."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if not torch.is_tensor(g):
            err = max(err, abs(float(g) - float(w)))
            continue
        if g.shape != w.shape:
            return float("inf")
        if g.numel() == 0:
            continue
        if g.dtype == torch.float32 and not torch.equal(
                g.view(torch.int32), w.view(torch.int32)):
            err = max(err, float("nan") if torch.isnan(g).any() else 1e-30)
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def kernel_phase(clf, metas, rows, db_chunk) -> dict:
    """K1-K4 against their plain versions on one batch's tensors, and K1
    also on one launch of the DB build (``db_chunk``: its genomes)."""
    import torch

    from metabuli_tpu_torch.classify import device_chain, device_combine
    from metabuli_tpu_torch.classify import pipeline
    from metabuli_tpu_torch.classify.device_compact import compact_paths
    from metabuli_tpu_torch.ops import encode
    from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded
    from metabuli_tpu_torch.tools.probes import bound, median_ms

    dev = clf.device
    codes, lens = encode_seqs_padded([r[0] for r in rows])
    codes = torch.from_numpy(codes).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    n = len(rows)
    offs = torch.zeros(n, dtype=torch.int32, device=dev)
    qids = torch.arange(n, dtype=torch.int32, device=dev)
    out = {}

    def launch_ms(name, fn, runs=5):
        """Device time of the kernels that ``fn`` launches (their launches
        alone, not the wrapper's glue), from a torch.profiler trace of
        ``runs`` calls after a warm-up: per kernel function the mean over
        its launches in the trace (each call launches each once), and
        their sum."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        times = {f: [] for f in KERNEL_FUNCTIONS[name]}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for f in times:
                if re.search(rf"(^|::){f}\b", e.name):
                    times[f].append(e.time_range.elapsed_us() / 1e3)
        if not all(times.values()):
            fail("kernels", f"the trace shows no launch of {times}")
        parts = [sum(t) / len(t) for t in times.values()]
        return sum(parts), parts

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def record(name, fn_k, fn_p, cost, shape=None):
        """``cost(outputs)`` -> least bytes of the call; a second ``shape``
        of a kernel is kept under that key of its record."""
        got, want = fn_k(), fn_p()
        torch.cuda.synchronize()
        # K2's count of warps that walked again is the kernel's own
        same = lambda r: (r[:-1] if isinstance(r, pipeline.Candidates)
                          else r)
        err = max_abs_err(same(got), same(want))
        b_ms, b_by = bound(cost(got))
        l_ms, parts = launch_ms(name, fn_k)
        rec = {"max_abs_err": err, "ms": median_ms(fn_k), "launch_ms": l_ms,
               "plain_ms": median_ms(fn_p), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        if shape is None:
            out[name] = rec
        else:
            out[name][shape] = rec
        say("kernels", kernel=name, **({} if shape is None else
                                       {"shape": shape}), equal=err == 0,
            **{k: round(rec[k], 4)
               for k in ("ms", "launch_ms", "plain_ms", "bound_ms")},
            bound_by=b_by, launch_parts_ms=[round(p, 4) for p in parts])
        if err != 0:
            fail("kernels", f"{name} differs from its plain version ({err})")
        return got

    # least bytes: every input read once, every output written once (K2:
    # only the table entries its queries need; K4: only what it must read)
    mm = record("extract_metamers",
                lambda: encode.extract_metamers(codes, lens),
                lambda: encode.extract_metamers_plain(codes, lens),
                lambda mm: nbytes([codes, lens, *mm]))
    gc, gl = encode_seqs_padded([g for g, _ in db_chunk])
    gc, gl = torch.from_numpy(gc).to(dev), torch.from_numpy(gl).to(dev)
    say("kernels", db_chunk_rows=gc.shape[0], db_chunk_bases=gc.shape[1])
    record("extract_metamers",
           lambda: encode.extract_metamers(gc, gl),
           lambda: encode.extract_metamers_plain(gc, gl),
           lambda r: nbytes([gc, gl, *r]), shape="db_chunk")
    del gc, gl
    idx, W = clf.dev_index, mm.value.shape[2]
    q = (mm.value.reshape(-1), mm.valid.reshape(-1), mm.dna48.reshape(-1))
    gs, ge, hit = pipeline._search_groups(idx, q[0], q[1])
    n_valid, n_hit = int(q[1].sum()), int(hit.sum())
    n_window = int((torch.minimum(ge, gs + clf.cap) - gs).sum())
    say("kernels", slots=q[0].numel(), valid_slots=n_valid,
        hit_slots=n_hit, window_rows=n_window)
    cand = record("search_scan",
                  lambda: pipeline.search_scan(idx, *q, W, clf.cap),
                  lambda: pipeline.search_scan_plain(idx, *q, W, clf.cap),
                  lambda c: (17 * q[0].numel() + 12 * n_valid + 8 * n_hit
                             + 8 * n_window + 12 * c.row.numel()))
    say("kernels", stash_per_slot=pipeline.stash_per_slot(idx),
        rows_per_hit=round(idx.rows_per_hit, 3),
        warps=(q[0].numel() + 31) // 32, warps_walked_again=cand.n_rewalk)
    m, counts = pipeline.classify_core(idx, clf.d_species, codes, lens, offs,
                                       qids, cap=clf.cap)
    frame, ham = m.packed & 7, (m.packed >> 3) & 0xFF
    h16 = (m.packed >> 11) & 0xFFFF
    dtx = clf.device_taxonomer
    cargs = (m.qid, m.species, frame, m.pos, ham, m.dna, h16, dtx.min_depth)
    kw = dict(max_shift=dtx.p.max_codon_shift)
    # K3 loads each of its seven int32 columns per row and the int32
    # min_depth table, and writes five 32-bit path columns and a flag a row
    chain = record("chain_matches",
                   lambda: device_chain.chain_matches(*cargs, **kw),
                   lambda: device_chain.chain_matches_plain(*cargs, **kw),
                   lambda r: nbytes([*cargs, *r]))
    paths, gstart = device_combine.sort_paths(
        compact_paths(chain, m.qid, m.species, m.pos, h16))
    rl = torch.as_tensor(np.array([x.read_len for x in metas], np.int32),
                         device=dev)
    # K4 reads every path's start, end and score, a boundary-codon word
    # (sh16 or eh16) only for each side of a path that a trim cuts, and per
    # group its bounds, its head's read and that read's length (once per
    # read); it writes a score per group
    P, G = paths.read.numel(), gstart.numel() - 1
    n_trim = int(device_combine.combine_trims_plain(paths, gstart, rl)[1])
    n_read = int(torch.unique(paths.read[gstart[:-1].long()]).numel())
    record("combine_paths",
           lambda: [device_combine.combine_paths(paths, gstart, rl)],
           lambda: [device_combine.combine_paths_plain(paths, gstart, rl)],
           lambda r: 12 * P + 4 * n_trim + 4 * (G + 1) + 8 * G + 4 * n_read)
    say("kernels", matches=counts["n_matches"], paths=P, groups=G,
        trimmed_sides=n_trim, group_reads=n_read)
    return out


# ------------------------------------------------------------------- main
def main() -> int:
    # ---- device
    import torch

    if not torch.cuda.is_available():
        fail("device", "no CUDA device: the smoke run needs one H100")
    dev = torch.device("cuda:0")
    cap = torch.cuda.get_device_capability(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    say("device", name=repr(torch.cuda.get_device_name(dev)),
        capability=cap, count=torch.cuda.device_count())
    print(card, flush=True)
    if cap != (9, 0):
        fail("device", f"capability {cap}, the kernels are built for sm_90a")
    sys.path.insert(0, ROOT)
    from metabuli_tpu_torch import native
    from metabuli_tpu_torch.classify.classifier import Classifier
    from metabuli_tpu_torch.csrc import build
    from metabuli_tpu_torch.params import ClassifyParams

    # ---- build
    t0 = time.perf_counter()
    build.get_lib()
    t1 = time.perf_counter()
    native.get_lib()
    say("build", nvcc_s=round(t1 - t0, 3),
        gxx_s=round(time.perf_counter() - t1, 3))

    # ---- probes (not on the classify path)
    from metabuli_tpu_torch.tools import probes

    probe_res = probes.run(dev)
    for name, r in probe_res.items():
        say("probes", kernel=name, replaces=r["replaces"],
            equal=r["max_abs_err"] == 0, ms=round(r["ms"], 4),
            plain_ms=round(r["plain_ms"], 4),
            bound_ms=round(r["bound_ms"], 4), bound_by=r["bound_by"],
            library_ms=(None if r["library_ms"] is None
                        else round(r["library_ms"], 4)),
            **{k: round(r[k], 3) for k in ("ns_per_query", "gb_per_s")
               if k in r})
        if r["max_abs_err"] != 0:
            fail("probes", f"{name} differs from its plain version")
    torch.cuda.empty_cache()

    from metabuli_tpu_torch.tools import world

    tmp = tempfile.mkdtemp(prefix="metabuli_smoke_")
    try:
        # ---- db
        tax, genomes, rng = world.skew_world(tmp)
        db = os.path.join(tmp, "db")
        info = build_db(db, tax, genomes, dev, rows=ROWS)
        say("db", **info)
        if info["rows"] != ROWS:
            fail("db", f"{info['rows']} rows, asked for {ROWS}")
        reads = world.sample_reads(genomes, rng, 65_536, 150, max_mut=2)
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, reads)

        # ---- kernels + parity (one classifier, one 8,192-read batch)
        par = ClassifyParams(seq_mode=1, batch_reads=8192)
        clf = Classifier(db, par, device=dev)
        resident = torch.cuda.memory_allocated(dev)
        say("kernels", db_load_s=round(clf.load_s, 3), cap=clf.cap,
            index_rows=clf.dev_index.n,
            resident_gib=round(resident / 2**30, 3))
        metas, rows = next(clf._iter_batches(fq, None))
        timings = kernel_phase(clf, metas, rows, genomes[:DB_CHUNK])
        lines = {}
        for plain in (False, True):
            torch.cuda.reset_peak_memory_stats(dev)
            res = clf.classify_batch(metas, rows, plain=plain)
            batch_peak = torch.cuda.max_memory_allocated(dev) - resident
            lines[plain] = [clf.reporter.classification_row(mt.name, rc,
                                                            mt.read_len)
                            for mt, rc in zip(metas, res)]
            if not plain:
                kernel_batch_peak = batch_peak
        same = lines[False] == lines[True]
        n_cls = sum(rc.is_classified for rc in res)
        say("parity", reads=len(metas), classified=n_cls, identical=same,
            batch_peak_gib=round(kernel_batch_peak / 2**30, 3),
            plain_batch_peak_gib=round(batch_peak / 2**30, 3))
        if not same:
            fail("parity", "kernel and plain classifications differ")
        del clf
        torch.cuda.empty_cache()

        # ---- tiny: the verify skill's two-genome world
        trng = np.random.default_rng(3)
        acgt = np.array(list(b"ACGT"), np.uint8)
        g1 = bytes(trng.choice(acgt, 20000))
        g2 = bytes(trng.choice(acgt, 20000))
        tdir = os.path.join(tmp, "tiny")
        world.write_taxonomy(os.path.join(tdir, "taxonomy"),
                             [(1, 1, "no rank"), (2, 1, "genus"),
                              (4, 2, "species"), (8, 2, "species")],
                             {t: f"Name{t}" for t in (1, 2, 4, 8)})
        from metabuli_tpu_torch.db.taxonomy import Taxonomy

        ttax = Taxonomy.from_dmp(*(os.path.join(tdir, "taxonomy", f) for f in
                                   ("names.dmp", "nodes.dmp", "merged.dmp")))
        build_db(os.path.join(tdir, "db"), ttax, [(g1, 4), (g2, 8)], dev)
        treads = ([g1[i * 160:i * 160 + 150] for i in range(60)]
                  + [g2[i * 160:i * 160 + 150] for i in range(60)])
        write_fastq(os.path.join(tdir, "reads.fq"), treads)
        s = run_cli(["classify", os.path.join(tdir, "reads.fq"),
                     os.path.join(tdir, "db"), os.path.join(tdir, "out"),
                     "e2e", "--seq-mode", "1", "--batch-reads", "128"])
        report = open(os.path.join(tdir, "out", "e2e_report.tsv")).read()
        split = [ln.split("\t") for ln in report.splitlines()
                 if ln.split("\t")[-1].strip() in ("Name4", "Name8")]
        halves = sorted(float(c[0]) for c in split)
        say("tiny", reads=s["reads"], classified=s["classified"],
            report_pct=halves)
        if s["classified"] != 120 or halves != [50.0, 50.0]:
            fail("tiny", "expected 120 classified reads split 50/50")

        # ---- classify: the CLI on 65,536 reads, kernels counted
        for k in build.launches:
            build.launches[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        s = run_cli(["classify", fq, db, os.path.join(tmp, "out"), "smoke",
                     "--seq-mode", "1", "--batch-reads", "8192"])
        peak = torch.cuda.max_memory_allocated(dev)
        counts = {name: build.launches[name] for name, _, _ in KERNELS}
        with open(os.path.join(tmp, "out", "smoke_classifications.tsv")) as fh:
            n_lines = sum(1 for ln in fh if not ln.startswith("#"))
        rate = s["reads"] / s["classify_s"]
        say("classify", reads=s["reads"], classified=s["classified"],
            db_load_s=round(s["load_s"], 3),
            reads_per_s=round(rate, 1), classify_s=round(s["classify_s"], 3),
            peak_mem_gib=round(peak / 2**30, 3), launches=counts)
        say("classify", stage_ms={k: round(v, 3)
                                  for k, v in s["stage_ms"].items()})
        if s["reads"] != 65_536 or n_lines != 65_536:
            fail("classify", f"{s['reads']} reads, {n_lines} output lines")
        if s["classified"] != CLASSIFIED:
            fail("classify", f"{s['classified']} reads classified, "
                             f"expected {CLASSIFIED}")
        if min(counts.values()) == 0:
            fail("classify", f"a kernel never launched: {counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    probe_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **timings[name]}
        for name, src, rep in KERNELS] + [
        {"name": name, "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": build.launches[name],
         "launch_ms": r["ms"], **{k: r[k] for k in probe_keys}}
        for name, r in probe_res.items()]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
