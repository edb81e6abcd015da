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
    _, genomes, rng = world.skew_world(str(tmp_path), seed=seed)
    assert len(genomes) == 384 and genomes == b_genomes
    for f in ("nodes.dmp", "names.dmp"):
        assert ((tmp_path / "skew_taxonomy" / f).read_text()
                == (b_dir / f).read_text())
    reads = world.sample_reads(genomes, rng, 3000, 150, max_mut=2)
    assert reads == bench.sample_reads(b_genomes, b_rng, 3000, 150, max_mut=2)
    assert world.SKEW == bench.WORLDS["skew"]
