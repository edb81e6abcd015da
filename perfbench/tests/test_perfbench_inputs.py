"""The benchmark's inputs: the frozen generators repeat by seed and
agree with the port's own (the tests may import the port; the harness's
reference may not)."""

import numpy as np
import pytest
import torch

from harness import dbcache, metamers, traffic, world

SPEC = dict(clades=2, per_clade=3, core_len=600, unique_len=2000,
            divergence=0.002, wobble=0.2, seed=0)
MIX = dict(reads=200, read_len=150, paired=True, fragment_len=400,
           random_share=0.1, reverse_share=0.5, sub_rate=0.005)
LONG = dict(reads=30, read_len=900, paired=False, random_share=0.1,
            reverse_share=0.5, sub_rate=0.01)


def test_world_is_the_ports():
    from metabuli_tpu_torch.tools import world as port_world

    spec = {k: v for k, v in SPEC.items() if k != "seed"}
    _, _, theirs = port_world.world_genomes(spec, np.random.default_rng(0))
    assert world.genomes(SPEC)[2] == theirs


@pytest.mark.parametrize("mix", [MIX, LONG], ids=["pairs", "long"])
def test_samples_repeat_by_seed(mix):
    g = world.genomes(SPEC)[2]
    big = 2**31 + 11  # the driver's seeds pass 32 signed bits
    a, b = traffic.sample(mix, g, big, 0), traffic.sample(mix, g, big, 0)
    c = traffic.sample(mix, g, big + 1, 0)
    d = traffic.sample(mix, g, big, 1)
    assert len(a.mates) == (2 if mix["paired"] else 1)
    for x, y, z, w in zip(a.mates, b.mates, c.mates, d.mates):
        assert x.shape == (mix["reads"], mix["read_len"]) == z.shape
        assert np.array_equal(x, y)
        assert not np.array_equal(x, z) and not np.array_equal(x, w)
        assert set(np.unique(x).tobytes()) <= set(b"ACGT")


def test_samples_keep_sizes_across_seeds():
    """Every seed gives the same number of random reads: the seed draws
    which reads, not how much work."""
    g = world.genomes(SPEC)[2]
    mix = dict(MIX, sub_rate=0.0)
    for seed in (1, 2, 3):
        s = traffic.sample(mix, g, seed, 0)
        genome = b"".join(x for x, _ in g)
        rc = lambda r: r.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
        found = sum(1 for r in s.mates[0]
                    if r.tobytes() in genome or rc(r.tobytes()) in genome)
        assert found == mix["reads"] - round(mix["reads"] * 0.1)


@pytest.mark.parametrize("length", [40, 150, 151, 152, 900])
def test_metamers_are_the_ports(length):
    from metabuli_tpu_torch.ops import encode

    rng = np.random.default_rng(length)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (4, length))]
    codes = torch.from_numpy(metamers.to_codes(seqs))
    lens = torch.full((4,), length)
    ex = metamers.Extractor("cpu")
    value, dna48, pos, valid = ex.extract(codes, lens)
    mm = encode.extract_metamers_plain(codes, lens.to(torch.int32))
    assert torch.equal(value, mm.value) and torch.equal(valid, mm.valid)
    assert torch.equal(dna48, mm.dna48)
    assert torch.equal(pos.to(torch.int32), mm.pos)
    assert torch.equal(ex.row_dna48(value)[valid], dna48[valid])


def test_diffidx_is_metabulis():
    from metabuli_tpu_torch.db import formats

    rng = np.random.default_rng(0)
    v = np.unique(np.concatenate([
        rng.integers(0, 2**63, 5000, dtype=np.uint64) * np.uint64(2),
        np.array([0, 1, 2**15, 2**30, 2**45, 2**60, 2**64 - 1], np.uint64)]))
    assert np.array_equal(dbcache.delta_stream(v), formats.delta_encode(v))
    split = np.concatenate([dbcache.delta_stream(v[:777]),
                            dbcache.delta_stream(v[777:], int(v[776]))])
    assert np.array_equal(split, formats.delta_encode(v))


def test_db_loads_in_the_port(tmp_path):
    from metabuli_tpu_torch.db.index import MetamerIndex

    cfg = {"name": "t", "rows": 60000, "world": SPEC,
           "decoys": {"seed": 1},
           "db": {"kmer_format": 2, "skip_redundancy": 1}}
    db = dbcache.ensure(cfg, str(tmp_path), "cpu", log=lambda *a: None)
    values, taxids = db.values(), db.taxids()
    assert len(values) == 60000
    assert np.all(values[1:] >= values[:-1])
    idx = MetamerIndex.load(db.db_dir)
    assert np.array_equal(idx.values, values)
    assert np.array_equal(idx.taxids, taxids)
    assert idx.params.kmer_format == 2 and idx.params.skip_redundancy == 1
    sp = idx.taxonomy.species_of
    assert all(int(sp[t]) == t for t in np.unique(taxids))
    # a second call finds it made
    again = dbcache.ensure(cfg, str(tmp_path), "cpu",
                           log=lambda *a: pytest.fail("made again"))
    assert np.array_equal(again.values(), values)
