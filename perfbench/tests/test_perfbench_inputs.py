"""The benchmark's inputs: the frozen generators repeat by seed and
agree with the port's own, and the harness cuts batches as the port's
reader does (the tests may import the port; the harness's reference may
not)."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import run
import tiny
from harness import dbcache, metamers, reference, traffic, world

SPEC = dict(clades=2, per_clade=3, core_len=600, unique_len=2000,
            divergence=0.002, wobble=0.2, seed=0)
MIX = dict(reads=200, read_len=150, paired=True, fragment_len=400,
           random_share=0.1, reverse_share=0.5, sub_rate=0.005)
LONG = dict(reads=30, len_mean=900, len_sd=500, min_len=100, max_len=2000,
            length_seed=3, paired=False, random_share=0.1,
            reverse_share=0.5, sub_rate=0.01, ins_rate=0.01, del_rate=0.01)
# sha256 of pe150's two FASTQ files on the tiny_skew world, taken with the
# generator as it was before it drew lengths and indels
PE150 = {
    (2**31 + 5, 0): "8f441d0648b00affbf0c938c8d00bb0bea82de5e46ce95945575cb31c2f5a8e8",
    (2**31 + 5, 3): "9c886c55d3cee99d0291550147ecb1f4f830c146449ea9fdda00f4a1165baa8d",
    (12345, 0): "18f63a85ae20dbc4bb2fcbef92cd3adf4c4359ebefbb840ac7d769553f10d91c",
    (12345, 3): "a994bb630280f7004aa0048c6da6042c7a0ddc4c2350a1b8699fcfef80cefe03",
}


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
        assert np.array_equal(x.lens, traffic.lengths(mix))
        assert np.array_equal(x.lens, z.lens)
        assert x.bases.size == x.lens.sum() == z.bases.size
        assert np.array_equal(x.bases, y.bases)
        assert not np.array_equal(x.bases, z.bases)
        assert not np.array_equal(x.bases, w.bases)
        assert set(np.unique(x.bases).tobytes()) <= set(b"ACGT")


def test_samples_keep_sizes_across_seeds():
    """Every seed gives the same number of random reads: the seed draws
    which reads, not how much work."""
    g = world.genomes(SPEC)[2]
    mix = dict(MIX, sub_rate=0.0)
    for seed in (1, 2, 3):
        s = traffic.sample(mix, g, seed, 0)
        genome = b"".join(x for x, _ in g)
        rc = lambda r: r.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
        m = s.mates[0]
        found = sum(1 for r in m.bases.reshape(len(m.lens), -1)
                    if r.tobytes() in genome or rc(r.tobytes()) in genome)
        assert found == mix["reads"] - round(mix["reads"] * 0.1)


@pytest.mark.parametrize("seed,index", sorted(PE150))
def test_pe150_bytes_are_pinned(seed, index, tmp_path):
    """pe150's samples, byte for byte as before the drawn lengths."""
    with open(os.path.join(tiny.BENCH, "traffic", "pe150.json")) as fh:
        mix = json.load(fh)
    g = world.genomes(tiny.CONFIG["world"])[2]
    h = hashlib.sha256()
    for p in traffic.sample(mix, g, seed, index).write(str(tmp_path), "x"):
        with open(p, "rb") as fh:
            h.update(fh.read())
    assert h.hexdigest() == PE150[seed, index]


def test_long_reads_keep_sizes_across_seeds():
    """A long mix: the same read count, lengths and bases on every seed,
    each read exactly its drawn length, and, without errors, each read
    of the genome's but the random ones."""
    g = world.genomes(SPEC)[2]
    genome = b"".join(x for x, _ in g)
    rc = lambda r: r.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
    clean = dict(LONG, reads=200, sub_rate=0.0, ins_rate=0.0, del_rate=0.0)
    want = traffic.lengths(clean)
    assert want.min() >= 100 and want.max() <= 2000 and np.ptp(want) > 500
    for mix in (clean, dict(LONG, reads=200)):
        for seed in (1, 2**31 + 11, 2**40 + 3):
            s = traffic.sample(mix, g, seed, 2)
            (m,) = s.mates
            assert s.n == 200 and np.array_equal(m.lens, want)
            assert m.bases.size == want.sum()
            seqs = [m.take([i]).bases.tobytes() for i in range(s.n)]
            assert [len(x) for x in seqs] == want.tolist()
            if mix is clean:
                found = sum(1 for r in seqs if r in genome or rc(r) in genome)
                assert found == 200 - 20


def test_paired_reads_take_no_drawn_lengths():
    g = world.genomes(SPEC)[2]
    with pytest.raises(ValueError, match="single reads"):
        traffic.sample(dict(MIX, ins_rate=0.01), g, 1, 0)


@pytest.mark.parametrize("kind", ["sub", "ins", "del"])
def test_error_rates(kind):
    """Each kind of error, alone at 3 %, measured on the generator's edit
    of numbered source bases (a kept base reads its position plus 256, a
    substituted or inserted one a base letter): within 5 binomial standard
    deviations of the rate, and one event a read for the cut."""
    rate, n = 0.03, 2000
    mix = {"sub_rate": 0.0, f"{kind}_rate": rate}
    lens = np.random.default_rng(0).integers(500, 1500, n)
    win = traffic.window_lens(lens, mix.get("del_rate", 0.0))
    src = 256 + np.arange(int(win.sum()), dtype=np.int64)
    out = traffic.edit(src, win, lens, mix, np.random.default_rng(1))
    assert out.size == lens.sum()
    reads = np.split(out, np.cumsum(lens)[:-1])
    letters = int(np.count_nonzero(out < 256))
    if kind == "sub":
        hits, trials = letters, out.size
    elif kind == "ins":
        hits, trials = letters, out.size - letters
    else:
        assert letters == 0
        hits = sum(int(r[-1] - r[0] + 1 - r.size) for r in reads)
        trials = sum(int(r[-1] - r[0] + 1) for r in reads)
    for r in reads:  # kept bases in order, each once
        kept = r[r >= 256]
        assert np.all(np.diff(kept) > 0)
    tol = 5 * np.sqrt(trials * rate * (1 - rate)) + n
    assert abs(hits - rate * trials) <= tol, (hits, rate * trials, tol)


def test_all_errors_together_keep_each_length():
    mix = {"sub_rate": 0.05, "ins_rate": 0.05, "del_rate": 0.05}
    lens = np.random.default_rng(2).integers(1, 3000, 500)
    win = traffic.window_lens(lens, mix["del_rate"])
    src = traffic.ACGT[np.random.default_rng(3).integers(0, 4, win.sum())]
    out = traffic.edit(src, win, lens, mix, np.random.default_rng(4))
    assert out.size == lens.sum()
    assert set(np.unique(out).tobytes()) <= set(b"ACGT")


def test_a_short_window_keeps_the_read_length():
    """A window with more deletions than it can spare gives its read all
    the bases it has left: only its first deletions apply."""
    lens = np.array([50, 50])
    win = np.array([52, 52])
    src = 256 + np.arange(104, dtype=np.int64)
    out = traffic.edit(src, win, lens, {"sub_rate": 0.0, "del_rate": 0.5},
                       np.random.default_rng(5))
    a, b = out[:50], out[50:]
    assert np.all(np.diff(a) > 0) and np.all(np.diff(b) > 0)
    assert a[0] >= 256 and a[-1] < 256 + 52 and b[0] >= 256 + 52


def _reader_batches(sample, d, batch_reads, batch_bases):
    from metabuli_tpu_torch.io.batch_reader import BatchReader

    files = sample.write(d, "s")
    with BatchReader(files[0], files[1] if len(files) > 1 else None,
                     batch_reads, batch_bases) as reader:
        return list(reader)


CUTS = [("pairs", dict(MIX, reads=300), 64, 0),
        ("long", dict(LONG, reads=60), 1 << 20, 3000),
        ("long_reads_first", dict(LONG, reads=60), 7, 3000)]


@pytest.mark.parametrize("name,mix,batch_reads,batch_bases", CUTS,
                         ids=[c[0] for c in CUTS])
def test_cuts_are_the_readers(name, mix, batch_reads, batch_bases, tmp_path):
    g = world.genomes(SPEC)[2]
    s = traffic.sample(mix, g, 9, 0)
    got = [len(b.names) for b in _reader_batches(s, str(tmp_path),
                                                 batch_reads, batch_bases)]
    bases = sum(m.lens for m in s.mates)
    cuts = reference.cuts(bases, batch_reads, batch_bases)
    assert [b - a for a, b in cuts] == got
    if batch_bases:
        assert len(got) > 2


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    cfg = {"name": "t", "rows": 60000, "world": SPEC,
           "decoys": {"seed": 1},
           "db": {"kmer_format": 2, "skip_redundancy": 1}}
    db = dbcache.ensure(cfg, str(tmp_path_factory.mktemp("db")), "cpu",
                        log=lambda *a: None)
    return db, reference.Table(db.values(), db.taxids(), db.taxonomy, "cpu")


@pytest.mark.parametrize("name,mix,batch_reads,batch_bases", CUTS[:2],
                         ids=[c[0] for c in CUTS[:2]])
def test_k2_bytes_over_the_readers_batches(name, mix, batch_reads,
                                          batch_bases, small_db, tmp_path):
    """The window's K2 bytes: each batch the reader cuts, joined whole
    from the reader's own rows, times the passes of its sample."""
    db, table = small_db
    samples = [traffic.sample(mix, db.genomes, 9, k) for k in range(2)]
    want = []
    for k, s in enumerate(samples):
        d = tmp_path / f"s{k}"
        d.mkdir()
        total = 0
        for b in _reader_batches(s, str(d), batch_reads, batch_bases):
            j = reference.Join(table, b.codes, b.lens.astype(np.int64))
            rows = int((torch.searchsorted(table.aa, table.aa[j.groups],
                                           right=True) - j.groups).sum())
            total += 8 * (j.kmers + rows + j.matches)
        want.append(total)
    passes = [(0, "a"), (1, "b"), (0, "c")]
    got = run.k2_window_bytes(table, samples, passes, batch_reads,
                              batch_bases)
    assert got == 2 * want[0] + want[1] > 0


def test_k2_bytes_in_blocks(small_db, monkeypatch):
    """Joined in blocks of reads by length, a batch moves the bytes it
    moves joined whole: a group met in several blocks counts once."""
    db, table = small_db
    s = traffic.sample(dict(LONG, reads=60), db.genomes, 4, 0)
    whole = reference.k2_bytes(table, s.mates)
    monkeypatch.setattr(reference, "BLOCK_CELLS", 3000)
    assert reference.k2_bytes(table, s.mates) == whole
    assert whole["group_rows"] > 0 and whole["matches"] > 0


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
