"""The port's smoke world (``metabuli_tpu_torch.tools.world``) draws the
same skew genomes, taxonomy and reads as the benchmark script
(``bench.py``) from the same seed."""

import numpy as np
import pytest

import bench
from metabuli_tpu_torch.tools import world


@pytest.mark.parametrize("seed", [0, 1])
def test_skew_world_and_reads_equal_bench(tmp_path, monkeypatch, seed):
    # bench.build_world draws from default_rng(0); hand it ``seed``
    # instead, so both sides start from the same generator state
    default_rng = np.random.default_rng
    monkeypatch.setattr(bench.np.random, "default_rng",
                        lambda _=None: default_rng(seed))
    b_dir = tmp_path / "bench"
    b_dir.mkdir()
    _, b_genomes, b_rng = bench.build_world(str(b_dir), "skew")
    monkeypatch.undo()
    _, genomes, rng = world.make_world(str(tmp_path), "skew", seed)
    assert len(genomes) == 384 and genomes == b_genomes
    for f in ("nodes.dmp", "names.dmp"):
        assert ((tmp_path / "skew_taxonomy" / f).read_text()
                == (b_dir / f).read_text())
    reads = world.sample_reads(genomes, rng, 3000, 150, max_mut=2)
    assert reads == bench.sample_reads(b_genomes, b_rng, 3000, 150, max_mut=2)
    assert world.SKEW == bench.WORLDS["skew"]


def test_uniform_world_and_long_reads_equal_bench(tmp_path):
    """bench.py's longread configuration: the uniform world (8 x 200 kb
    genomes) and 3,000-base reads at max_mut = read_len // 100."""
    b_dir = tmp_path / "bench"
    b_dir.mkdir()
    _, b_genomes, b_rng = bench.build_world(str(b_dir), "uniform")
    _, genomes, rng = world.make_world(str(tmp_path), "uniform")
    assert len(genomes) == 8 and genomes == b_genomes
    for f in ("nodes.dmp", "names.dmp"):
        assert ((tmp_path / "uniform_taxonomy" / f).read_text()
                == (b_dir / f).read_text())
    c = bench.CONFIGS["longread"]
    assert (c["world"], c["read_len"], c["n_reads"]) == ("uniform", 3000,
                                                          8192)
    reads = world.sample_reads(genomes, rng, 64, 3000, max_mut=30)
    assert reads == bench.sample_reads(b_genomes, b_rng, 64, 3000, max_mut=30)
    assert world.UNIFORM == bench.WORLDS["uniform"]


def test_never_match_decoys_change_no_classification(tmp_path):
    """``build_db(never_match=True)``: every decoy sorts after the genome
    rows and no read meets one, so a DB padded with them classifies
    reads, random ones too, as the genome rows alone do."""
    import torch

    from metabuli_tpu_torch.cli import main
    from metabuli_tpu_torch.db.index import MetamerIndex

    tax, genomes, rng = world.make_world(str(tmp_path), "uniform")
    genomes = [(g[:20_000], sp) for g, sp in genomes]
    reads = world.sample_reads(genomes, rng, 40, 1000, max_mut=10)
    fq = str(tmp_path / "reads.fq")
    world.write_fastq(fq, reads)
    cpu = torch.device("cpu")
    out = {}
    for name, rows in (("genome", 0), ("padded", 600_000)):
        db = str(tmp_path / name)
        info = world.build_db(db, tax, genomes, cpu, rows=rows,
                              never_match=True)
        if rows:
            assert info["rows"] == rows and info["decoy_rows"] > 200_000
            v = MetamerIndex.load(db).values
            n = info["genome_rows"]
            assert np.all(v[n:] >> np.uint64(59) == 31)
            assert np.all(v[:n] >> np.uint64(59) < 21)
        assert main(["classify", fq, db, str(tmp_path / f"out_{name}"), "u",
                     "--seq-mode", "3", "--batch-reads", "16", "--device",
                     "cpu"]) == 0
        out[name] = (tmp_path / f"out_{name}" / "u_classifications.tsv"
                     ).read_bytes()
    assert out["padded"] == out["genome"]
    assert out["genome"].count(b"\n1\t") >= 30
