"""A benchmark made of files alone, at a size the CPU runs in seconds:
its own BENCHMARK.json, a configuration, a traffic mix and, beside the
real metric readers, a metric of its own. ``make(root)`` lays it out;
``python perfbench/tests/tiny.py ROOT [--device D] [--fault NAME] -- RUN ARGS`` runs
the harness on it on the CPU (the look for a card skipped), with one of
the faults a run must catch planted in the program.

``tiny.long`` is single reads of drawn lengths with insertions and
deletions, batched by ``--batch-reads 0``. The automatic batch ends at
``BATCH_BASES`` bases here (the program sizes it from device memory, at
millions of bases), so that its small samples are cut by bases, as a
long-read sample of real size is on the card."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

CONFIG = {
    "name": "tiny_skew",
    "source": "test", "rows": 200000, "genomes": 12,
    "world": {"clades": 2, "per_clade": 6, "core_len": 600,
              "unique_len": 3000, "divergence": 0.002, "wobble": 0.2,
              "seed": 0},
    "decoys": {"seed": 12345},
    "db": {"kmer_format": 2, "skip_redundancy": 1},
    "classify": {"seq_mode": 2, "batch_reads": 64, "threads": 2,
                 "device_tax": 1},
}
LONG = dict(CONFIG, name="tiny_long", rows=100000,
            world=dict(CONFIG["world"], clades=2, per_clade=2),
            classify=dict(CONFIG["classify"], seq_mode=3, batch_reads=0))
BATCH_BASES = 4000
MIXES = {
    "tiny_pe": {"reads": 160, "read_len": 150, "paired": True,
                "fragment_len": 400, "random_share": 0.1,
                "reverse_share": 0.5, "sub_rate": 0.005, "samples": 2,
                "check_reads": 160},
    "tiny_long": {"reads": 40, "len_mean": 600, "len_sd": 300,
                  "min_len": 150, "max_len": 1500, "length_seed": 7,
                  "paired": False, "random_share": 0.1,
                  "reverse_share": 0.5, "sub_rate": 0.01, "ins_rate": 0.01,
                  "del_rate": 0.01, "samples": 2, "check_reads": 40},
}
# a per-layer metric that no file of the real benchmark has
NEW_METRIC = '''"""Batches in the window."""


def read(ctx):
    return float(ctx.batches) or None
'''


def make(root: str) -> dict:
    """Lay the tiny benchmark out under ``root``; its BENCHMARK.json."""
    bench = os.path.join(root, "perfbench")
    for d in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(bench, d), exist_ok=True)
    for f in os.listdir(os.path.join(BENCH, "metrics")):
        if f.endswith(".py"):
            shutil.copy(os.path.join(BENCH, "metrics", f),
                        os.path.join(bench, "metrics", f))
    with open(os.path.join(bench, "metrics", "batches_seen.py"), "w") as fh:
        fh.write(NEW_METRIC)
    for cfg in (CONFIG, LONG):
        with open(os.path.join(bench, "configs", cfg["name"] + ".json"),
                  "w") as fh:
            json.dump(cfg, fh)
    for name, mix in MIXES.items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as fh:
            json.dump(mix, fh)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        real = json.load(fh)
    cells = ["tiny.pe", "tiny.long"]
    spec = dict(real)
    spec["configs"] = [
        {"name": c["name"], "source": "test",
         "file": f"perfbench/configs/{c['name']}.json", "reduced": [],
         "why": "test"} for c in (CONFIG, LONG)]
    spec["workloads"] = [
        {"name": "tiny.pe", "config": "tiny_skew", "traffic": "tiny_pe",
         "chips": 1, "why": "test"},
        {"name": "tiny.long", "config": "tiny_long", "traffic": "tiny_long",
         "chips": 1, "why": "test"}]
    spec["per_layer"] = [dict(m, workloads=cells) for m in real["per_layer"]]
    spec["per_layer"].append(
        {"name": "batches_seen", "unit": "batches", "better": "higher",
         "source": "program_counter", "layer": "batch pipeline, main thread",
         "moves": "reads_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return spec


def cut_by_bases() -> None:
    """The automatic batch ends at ``BATCH_BASES`` bases at the most."""
    from metabuli_tpu_torch.classify.classifier import Classifier

    real = Classifier._auto_batch

    def auto(self):
        reads, bases, budget = real(self)
        return reads, min(bases, BATCH_BASES), budget

    Classifier._auto_batch = auto


def plant(fault: str) -> None:
    """Break the program's timed path: ``altered`` changes every eighth
    read's answer where the finish makes it; ``half`` leaves out the second
    half of every batch (its reads come back unclassified); ``jax`` makes
    the process hold a module named ``jax``."""
    if fault == "jax":
        import types

        sys.modules["jax"] = types.ModuleType("jax")
        return
    from metabuli_tpu_torch.classify import device_taxonomer

    real = device_taxonomer.DeviceTaxonomer.drain

    def drain(self, host, read_lens, n_reads):
        out = real(self, host, read_lens, n_reads)
        if fault == "altered":
            for rc in out[::8]:
                if rc.is_classified:
                    rc.taxid = 1 if rc.taxid != 1 else 2
                else:
                    rc.score += 1.0
        elif fault == "half":
            from metabuli_tpu_torch.classify.taxonomer import (
                ReadClassification)

            h = len(out) // 2
            out[h:] = [ReadClassification() for _ in out[h:]]
        return out

    device_taxonomer.DeviceTaxonomer.drain = drain


if __name__ == "__main__":
    sys.path[:0] = [BENCH, REPO]
    args = sys.argv[1:]
    root = args.pop(0)
    device = "cpu"
    if args[0] == "--device":
        device = args[1]
        args = args[2:]
    if args[0] == "--fault":
        plant(args[1])
        args = args[2:]
    assert args.pop(0) == "--"
    cut_by_bases()
    import run

    sys.exit(run.main(args, device=device, root=root,
                      bench=os.path.join(root, "perfbench")))
