"""The end-to-end A/B tool (``metabuli_tpu_torch.tools.ab``) on the CPU:
two checkouts (here both this one) classify the two-genome world of
.claude/skills/verify/SKILL.md in alternating order, and every run reports
its reads/s, its stages and its drain's host time, with all 120 reads
classified."""

import json
import os

import numpy as np
import torch

from metabuli_tpu_torch.db.taxonomy import Taxonomy
from metabuli_tpu_torch.tools import ab, world


def test_ab_alternates_checkouts_and_reports_each_run(tmp_path, monkeypatch,
                                                      capsys):
    rng = np.random.default_rng(3)
    g1, g2 = (bytes(rng.choice(world.ACGT, 20000)) for _ in range(2))
    tdir = str(tmp_path / "taxonomy")
    world.write_taxonomy(tdir, [(1, 1, "no rank"), (2, 1, "genus"),
                                (4, 2, "species"), (8, 2, "species")],
                         {t: f"Name{t}" for t in (1, 2, 4, 8)})
    tax = Taxonomy.from_dmp(*(os.path.join(tdir, f) for f in
                              ("names.dmp", "nodes.dmp", "merged.dmp")))
    db, reads = str(tmp_path / "db"), str(tmp_path / "reads.fq")
    world.build_db(db, tax, [(g1, 4), (g2, 8)], torch.device("cpu"))
    world.write_fastq(reads, [g[i * 160:i * 160 + 150]
                                   for g in (g1, g2) for i in range(60)])
    monkeypatch.setattr(ab, "BUILD", "pass")  # CPU runs need no kernels
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(ab.__file__))))
    assert ab.main([root, root, reads, db, "--pairs", "2", "--", "--device",
                    "cpu", "--seq-mode", "1", "--batch-reads", "128"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["pair"], r["side"]) for r in recs] == [
        (0, "change"), (0, "parent"), (1, "parent"), (1, "change")]
    for r in recs:
        assert r["classified"] == 120 and r["reads_per_s"] > 0
        assert r["drain_s"] >= r["finish_s"] > 0
        assert {"upload", "extract", "finish"} <= set(r["stage_ms"])
        assert 0 <= r["overlap_s"] <= r["classify_s"]
