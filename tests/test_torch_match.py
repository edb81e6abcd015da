"""Port parity: the match core (extraction, group search, candidate scan,
compaction, fetch, 5-key sort) against the JAX package's ``_classify_core``
with its default index and flows (direct probe, two-tier cap, deep tier).

Tolerance is zero: the sorted match columns and the match count must be
equal. The port sizes its windows exactly, so it runs one cap where the
JAX flows use tiers; ``--max-cap`` truncation is checked against the JAX
single-tier flow at the same cap."""

import numpy as np
import pytest
import torch

from metabuli_tpu.classify.pipeline import (build_dev_index as jax_index,
                                            classify_batch_indexed,
                                            matches_to_host)
from metabuli_tpu.ops import encode as jenc
from metabuli_tpu.ops.genetic_code import encode_seqs_padded
from metabuli_tpu_torch.classify.pipeline import build_dev_index, classify_core

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _port(values, taxids, t2s, reads, max_len, cap):
    index = build_dev_index(values, taxids)
    codes, lens = encode_seqs_padded(reads, max_len)
    n = len(reads)
    m, counts = classify_core(
        index, torch.from_numpy(t2s), torch.from_numpy(codes),
        torch.from_numpy(lens), torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), cap=cap)
    return m, counts


def _jax(index, t2s, reads, max_len, max_matches=1 << 17, **kw):
    codes, lens = encode_seqs_padded(reads, max_len)
    n = len(reads)
    bm = classify_batch_indexed(
        index, t2s, codes, lens, np.zeros(n, np.int32),
        np.arange(n, dtype=np.int32), max_matches=max_matches, **kw)
    return matches_to_host(bm, t2s)


def _assert_same(m, counts, want):
    n = want["n_matches"]
    assert n > 0
    assert counts["n_matches"] == n
    packed = want["frame"] | (want["hamming"] << 3) | (want["h16"] << 11)
    for name, col in (("qid", m.qid), ("species", m.species), ("pos", m.pos),
                      ("dna", m.dna), ("taxid", m.taxid)):
        assert np.array_equal(col.numpy(), want[name][:n]), name
    assert np.array_equal(m.packed.numpy(), packed[:n])


def _metamers(seqs):
    codes, lens = encode_seqs_padded(seqs)
    mm = jenc.extract_metamers(codes, lens)
    return np.asarray(mm.value), np.asarray(mm.valid)


@pytest.fixture(scope="module")
def direct_world():
    """tests/test_direct_search.py's world: ~300k groups, so the direct
    map has multi-group slots and dmap2 double collisions."""
    rng = np.random.default_rng(202)
    source = [bytes(rng.choice(ACGT, 112)) for _ in range(2000)]
    v, ok = _metamers(source)
    values = np.unique(v[ok])
    taxids = ((values % np.uint64(37)).astype(np.int64) % 40 + 3).astype(np.int32)
    return values, taxids, np.arange(64, dtype=np.int32), source[::7][:300]


def skew_data(n_genomes: int = 40):
    """tests/test_two_tier_cap.py's world: a block shared verbatim by
    ``n_genomes`` genomes (species 3, 4, ...) makes AA groups that deep.
    Returns (values, taxids, taxid -> species table, reads)."""
    rng = np.random.default_rng(11)
    shared = bytes(rng.choice(ACGT, 120))
    genomes = []
    for g in range(n_genomes):
        pre = bytes(rng.choice(ACGT, 400))
        post = bytes(rng.choice(ACGT, 400))
        genomes.append((pre + shared + post, 3 + g))
    all_v, all_t = [], []
    for seq, t in genomes:
        v, ok = _metamers([seq])
        all_v.append(v[ok])
        all_t.append(np.full(int(ok.sum()), t, np.uint32))
    values = np.concatenate(all_v)
    taxids = np.concatenate(all_t)
    order = np.lexsort((taxids, values))
    values, taxids = values[order], taxids[order]
    ng = np.ones(len(values), bool)
    ng[1:] = (values[1:] != values[:-1]) | (taxids[1:] != taxids[:-1])
    values, taxids = values[ng], taxids[ng].astype(np.int32)
    reads = []
    for i in range(48):
        g, _ = genomes[i % len(genomes)]
        st = int(rng.integers(0, len(g) - 150))
        reads.append(g[st: st + 150])
    reads += [genomes[i][0][350:500] for i in range(8)]
    t2s = np.arange(max(64, n_genomes + 3), dtype=np.int32)
    return values, taxids, t2s, reads


@pytest.fixture(scope="module")
def skew_world():
    return skew_data(40)


@pytest.fixture(scope="module")
def deep_world():
    """tests/test_deep_tier.py's world: 30 wobble-diverged copies of one
    genome, AA groups up to ~30 deep (aligned deep tier)."""
    rng = np.random.default_rng(11)
    core = rng.choice(ACGT, 3000)
    seqs = []
    for _ in range(30):
        c = core.copy()
        w = np.arange(2, 3000, 3)
        m = w[rng.random(len(w)) < 0.15]
        c[m] = ACGT[(np.searchsorted(ACGT, c[m]) + rng.integers(1, 4, len(m))) % 4]
        seqs.append(bytes(c))
    all_v, all_t = [], []
    for si, s in enumerate(seqs):
        v, ok = _metamers([s])
        v = np.unique(v[ok])
        all_v.append(v)
        all_t.append(np.full(len(v), si + 2, np.int32))
    values = np.concatenate(all_v)
    taxids = np.concatenate(all_t)
    o = np.argsort(values, kind="stable")
    reads = [seqs[i % 30][j * 200: j * 200 + 150] for i in range(16)
             for j in (1, 5)]
    return values[o], taxids[o], np.arange(64, dtype=np.int32), reads


def test_match_direct_probe_flow(direct_world):
    values, taxids, t2s, reads = direct_world
    index = jax_index(values, taxids)
    assert index.direct_bits and index.direct2_bits
    want = _jax(index, t2s, reads, 112, cap=2, hit_budget=1 << 16,
                sovf_budget=8192, resid_budget=4096)
    assert want["n_sovf2"] > 0  # every resolution path ran
    m, counts = _port(values, taxids, t2s, reads, 112, cap=1 << 20)
    _assert_same(m, counts, want)
    assert counts["total_kmers"] == want["total_kmers"]


def test_match_two_tier_flow(skew_world):
    values, taxids, t2s, reads = skew_world
    index = jax_index(values, taxids)
    max_group = 40
    want = _jax(index, t2s, reads, 160, cap=4, cap2=max_group,
                ov_budget=4096)
    assert want["n_ov"] > 0 and want["n_over_cap"] == 0
    m, counts = _port(values, taxids, t2s, reads, 160, cap=4096)
    _assert_same(m, counts, want)
    assert counts["n_over_cap"] == 0


def test_match_deep_tier_flow(deep_world):
    values, taxids, t2s, reads = deep_world
    index = jax_index(values, taxids)
    assert index.deep_w > 0
    want = _jax(index, t2s, reads, 152, cap=1, cap2=64, hit_budget=16384,
                sovf_budget=8192, resid_budget=4096, ov_budget=8192,
                ovd_budget=8192)
    assert want["n_ovd"] > 0
    m, counts = _port(values, taxids, t2s, reads, 152, cap=4096)
    _assert_same(m, counts, want)


def test_match_groups_deeper_than_a_warp():
    """72 genomes share the block: windows of 72 rows, deeper than a warp
    of 32 lanes, against the JAX single-tier flow at the full depth."""
    values, taxids, t2s, reads = skew_data(72)
    index = jax_index(values, taxids)
    m, counts = _port(values, taxids, t2s, reads, 160, cap=4096)
    want = _jax(index, t2s, reads, 160, max_matches=1 << 20, cap=72)
    assert want["n_over_cap"] == 0 and counts["n_over_cap"] == 0
    aa = values >> np.uint64(24)
    starts = np.flatnonzero(np.r_[True, aa[1:] != aa[:-1]])
    assert np.diff(np.r_[starts, len(aa)]).max() >= 64
    _assert_same(m, counts, want)


def test_match_max_cap_truncates_group(skew_world):
    """A cap below the deepest group cuts each window to its first `cap`
    rows (the Hamming cutoff then sees only those), as the JAX
    single-tier flow does."""
    values, taxids, t2s, reads = skew_world
    index = jax_index(values, taxids)
    want = _jax(index, t2s, reads, 160, cap=3)
    m, counts = _port(values, taxids, t2s, reads, 160, cap=3)
    assert want["n_over_cap"] > 0
    assert counts["n_over_cap"] == want["n_over_cap"]
    _assert_same(m, counts, want)
