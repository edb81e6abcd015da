"""Port parity: the taxonomer stages (chain K3, combine K4 by their plain
versions, quotient LCA, taxcnt runs) against the JAX package, on the
worlds of tests/test_device_chain.py, test_device_combine.py and
test_device_redundancy.py. Tolerance is zero: integers equal, float32
scores bitwise equal. Where the JAX chain grid overflows (and the JAX
classifier falls back to the host), the port must equal the Python
Taxonomer."""

import numpy as np
import pytest
import torch

from metabuli_tpu.classify import device_chain as jchain
from metabuli_tpu.classify import device_combine as jcomb
from metabuli_tpu.classify import device_redundancy as jred
from metabuli_tpu.classify.device_taxonomer import taxonomer_tail as jtail
from metabuli_tpu.classify.taxonomer import Taxonomer, TaxonomerParams
from metabuli_tpu_torch.classify import device_redundancy as tred
from metabuli_tpu_torch.classify.device_chain import chain_matches_plain
from metabuli_tpu_torch.classify.device_combine import (combine_paths,
                                                        sort_paths)
from metabuli_tpu_torch.classify.device_compact import (FlatPaths,
                                                        compact_groups,
                                                        compact_paths)
from metabuli_tpu_torch.classify.device_taxonomer import (DeviceTaxonomer,
                                                          taxonomer_tail)
from metabuli_tpu_torch.classify.pipeline import MatchColumns
from test_device_chain import _synthetic_matches
from test_device_chain import _taxonomy as chain_taxonomy
from test_device_redundancy import _taxonomy as red_taxonomy
from test_torch_synthetic import synthetic_paths

T = lambda a: torch.as_tensor(np.ascontiguousarray(a))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed,max_shift", [(0, 1), (1, 1), (2, 3), (3, 3)])
def test_chain_paths_equal_jax(seed, max_shift):
    m = _synthetic_matches(np.random.default_rng(seed), max_shift=max_shift)
    n = len(m["qid"])
    min_depth = np.full(16, 4, np.int32)
    res = jchain.chain_matches(
        m["qid"], m["species"], m["frame"], m["pos"], m["hamming"],
        m["dna"], m["h16"], np.ones(n, bool), min_depth,
        n_blocks=512, w=64, k=4, max_shift=max_shift)
    assert not np.asarray(res.fallback).any()
    em = np.asarray(res.emit_mask)
    b_read, b_sp = np.asarray(res.block_read), np.asarray(res.block_species)
    want = sorted(
        (int(b_read[b]), int(b_sp[b]), int(np.asarray(res.start)[w, s, b]),
         int(np.asarray(res.end)[w, s, b]),
         int(_bits(np.asarray(res.score)[w, s, b])),
         int(np.asarray(res.hamming)[w, s, b]),
         int(np.asarray(res.start_h16)[w, s, b]),
         int(np.asarray(res.end_h16)[w, s, b]))
        for w, s, b in zip(*np.nonzero(em)))
    c = {k: T(v) for k, v in m.items()}
    chain = chain_matches_plain(
        c["qid"], c["species"], c["frame"], c["pos"], c["hamming"], c["dna"],
        c["h16"], T(min_depth), max_shift=max_shift)
    p = compact_paths(chain, c["qid"], c["species"], c["pos"], c["h16"])
    got = sorted(zip(p.read.tolist(), p.species.tolist(), p.start.tolist(),
                     p.end.tolist(), _bits(p.score.numpy()).tolist(),
                     p.ham.tolist(), p.sh16.tolist(), p.eh16.tolist()))
    assert got == want and len(got) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine_scores_equal_jax(seed):
    """Random path sets (tests/test_device_combine.py's generator shape)."""
    rng = np.random.default_rng(seed)
    rows = []
    read_lens = np.zeros(64, np.int32)
    for read in range(32):
        rl = int(rng.integers(100, 300))
        read_lens[read] = rl
        for sp in sorted(rng.choice(range(2, 10), rng.integers(1, 3),
                                    replace=False)):
            for _ in range(int(rng.integers(1, 7))):
                start = int(rng.integers(0, rl - 24))
                length = 24 + 3 * int(rng.integers(0, (rl - start - 24) // 3 + 1))
                depth = 1 + (length - 24) // 3
                score = np.float32(3.0 * depth + 8 + rng.integers(0, 40) * 0.5)
                rows.append((read, int(sp), start, start + length - 1,
                             float(score), int(rng.integers(0, 12)),
                             int(rng.integers(0, 1 << 16)),
                             int(rng.integers(0, 1 << 16))))
    rng.shuffle(rows)
    a = np.array([(r[0], r[1], r[2], r[3], r[5], r[6], r[7]) for r in rows],
                 np.int32)
    score = np.array([r[4] for r in rows], np.float32)
    res = jcomb.combine_paths(
        a[:, 0], a[:, 1], a[:, 2], a[:, 3], score, a[:, 4], a[:, 5], a[:, 6],
        np.ones(len(rows), bool), read_lens, n_groups=256, p_max=8)
    assert not np.asarray(res.fallback).any()
    ok = np.asarray(res.group_valid)
    want = (np.asarray(res.group_read)[ok], np.asarray(res.group_species)[ok],
            _bits(np.asarray(res.score)[ok]))
    paths = FlatPaths(T(a[:, 0]), T(a[:, 1]), T(a[:, 2]), T(a[:, 3]),
                      T(score), T(a[:, 4]), T(a[:, 5]), T(a[:, 6]))
    sp, gstart = sort_paths(paths)
    g = compact_groups(sp, gstart, combine_paths(sp, gstart, T(read_lens)))
    assert np.array_equal(g.read.numpy(), want[0])
    assert np.array_equal(g.species.numpy(), want[1])
    assert np.array_equal(_bits(g.score.numpy()), want[2])


def _redundancy_rows(tax, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for read in range(20):
        for sp in sorted(rng.choice(range(4, 16, 4), rng.integers(1, 3),
                                    replace=False)):
            for _ in range(int(rng.integers(1, 30))):
                rows.append((read, int(sp), int(rng.integers(0, 150)),
                             int(rng.integers(0, 5)),
                             int(rng.integers(1, tax.n_nodes() + 1))))
    rows.sort()
    return np.array(rows, np.int32)


@pytest.mark.parametrize("seed,dna_shift", [(0, 3), (1, 9)])
def test_quotient_rows_and_lca_equal_jax(tmp_path, seed, dna_shift):
    tax = red_taxonomy(tmp_path)
    arr = _redundancy_rows(tax, seed)
    jd = jred.device_taxonomy(tax)
    res = jred.quotient_best(jd, *(arr[:, i] for i in range(5)),
                             np.ones(len(arr), bool), dna_shift=dna_shift,
                             max_rows=4096)
    n = int(res.n_rows)
    td = tred.device_taxonomy(tax)
    got = tred.quotient_best(td, *(T(arr[:, i]) for i in range(5)),
                             dna_shift=dna_shift)
    for g, w in zip(got, (res.row_read, res.row_species, res.row_taxid)):
        assert np.array_equal(g.numpy(), np.asarray(w)[:n])
    rng = np.random.default_rng(seed)
    a = rng.integers(0, tax.n_nodes() + 1, 300).astype(np.int32)
    b = rng.integers(0, tax.n_nodes() + 1, 300).astype(np.int32)
    assert np.array_equal(tred.lca_pairs(td, T(a), T(b)).numpy(),
                          np.asarray(jred.lca_pairs(jd, a, b)))
    flag = rng.random(300) < 0.2
    flag[0] = True
    val = rng.random(300) < 0.1
    assert np.array_equal(
        tred.seg_broadcast(T(flag), T(a)).numpy(),
        np.asarray(jred.seg_broadcast(flag, a)))
    assert np.array_equal(
        tred.seg_suffix_or(T(flag), T(val)).numpy(),
        np.asarray(jred.seg_suffix_or(flag, val)))


def _columns(m):
    packed = m["frame"] | (m["hamming"] << 3) | (m["h16"] << 11)
    return MatchColumns(T(m["qid"]), T(m["species"]), T(m["pos"]),
                        T(m["dna"]), T(m["taxid"]), T(packed.astype(np.int32)))


def _chain_world(seed):
    m = _synthetic_matches(np.random.default_rng(seed), max_shift=1)
    m["taxid"] = m["species"].copy()  # species 3..8 are taxonomy nodes
    return m


def _redundancy_world(tax, seed):
    """Quotient rows dressed as sorted matches (frame 0, random codons)."""
    arr = _redundancy_rows(tax, seed)
    rng = np.random.default_rng(seed + 100)
    dna = rng.integers(0, 1 << 24, len(arr)).astype(np.int32)
    o = np.lexsort((dna, arr[:, 3], arr[:, 2], arr[:, 1], arr[:, 0]))
    arr, dna = arr[o], dna[o]
    z = np.zeros(len(arr), np.int32)
    return {"qid": arr[:, 0], "species": arr[:, 1], "frame": z,
            "pos": arr[:, 2], "hamming": arr[:, 3], "dna": dna,
            "taxid": arr[:, 4], "h16": z.copy()}


def _jax_tail(tax, m, read_lens, k=4):
    tp = TaxonomerParams()
    packed = m["frame"] | (m["hamming"] << 3) | (m["h16"] << 11)
    G, Tb = 1024, 4096
    out, _, counts = jtail(
        m["qid"], m["species"], m["pos"], m["dna"], m["taxid"],
        packed.astype(np.int32), np.zeros(8, np.int32),
        jred.device_taxonomy(tax),
        np.full(tax.n_nodes() + 1, tp.min_cons_cnt, np.int32), read_lens,
        path_budget=4096, g_budget=G, max_rows=4096, taxcnt_budget=Tb,
        dna_shift=tp.dna_shift, p_max=64, n_blocks=1024, w=64, k=k,
        max_shift=tp.max_codon_shift, ov_budget=1024, kmer_format=2)
    out, counts = np.asarray(out), np.asarray(counts)
    ng, nt = int(counts[0]), int(counts[1])
    groups = (out[:ng], out[G:G + ng], out[2 * G:2 * G + ng])
    base = 3 * G
    taxcnt = tuple(out[base + i * Tb: base + i * Tb + nt] for i in range(4))
    return groups, taxcnt, int(counts[2])


def _port_tail(tax, m, read_lens):
    tp = TaxonomerParams()
    dtax = DeviceTaxonomer(tp, tax)
    return taxonomer_tail(_columns(m), dtax.dt, dtax.min_depth,
                          T(read_lens), dna_shift=tp.dna_shift,
                          max_shift=tp.max_codon_shift)


@pytest.mark.parametrize("world,seed", [("chain", 0), ("chain", 1),
                                        ("redundancy", 2)])
def test_tail_groups_and_taxcnt_equal_jax(tmp_path, world, seed):
    if world == "chain":
        tax = chain_taxonomy(tmp_path)
        m = _chain_world(seed)
    else:
        tax = red_taxonomy(tmp_path)
        m = _redundancy_world(tax, seed)
    read_lens = np.full(32, 147, np.int32)
    (wg, wt, overflow) = _jax_tail(tax, m, read_lens)
    assert overflow == 0
    groups, taxcnt = _port_tail(tax, m, read_lens)
    assert np.array_equal(groups.read.numpy(), wg[0])
    assert np.array_equal(groups.species.numpy(), wg[1])
    assert np.array_equal(_bits(groups.score.numpy()), wg[2])
    for g, w in zip(taxcnt, wt):
        assert np.array_equal(g.numpy(), w)
    assert len(wt[0]) > 0 and (len(wg[0]) > 0 or world == "redundancy")


def test_tail_where_jax_grid_overflows_equals_python(tmp_path):
    """With one chain slot per cell, the JAX grid cannot hold the tied
    matches (the JAX classifier then re-runs the batch on the host); the
    port has no grid limit and must equal the Python Taxonomer."""
    tax = chain_taxonomy(tmp_path)
    m = _chain_world(4)
    n_reads = int(m["qid"].max()) + 1
    read_lens = np.full(n_reads, 147, np.int32)
    _, _, overflow = _jax_tail(tax, m, read_lens, k=1)
    assert overflow & 1, "world must overflow the JAX chain grid"
    tp = TaxonomerParams()
    dtax = DeviceTaxonomer(tp, tax)
    groups, taxcnt = _port_tail(tax, m, read_lens)
    got = dtax.drain(dtax.start_drain((groups, taxcnt)), read_lens, n_reads)
    py = Taxonomer(tp, tax)
    fields = ("qid", "species", "frame", "pos", "hamming", "dna", "taxid",
              "h16")
    n_cls = 0
    for r in range(n_reads):
        sel = m["qid"] == r
        want = py.choose_best_taxon({f: m[f][sel] for f in fields}, 147)
        assert (got[r].is_classified, got[r].taxid) == \
            (want.is_classified, want.taxid), r
        assert np.float32(got[r].score) == np.float32(want.score), r
        n_cls += want.is_classified
    assert n_cls > 0


def test_combine_large_groups_equal_jax():
    """Groups of 1-70 paths that nest and chain (one path trimmed by
    several accepted ones in turn) and one with 40 accepted paths, with
    JAX's ``p_max`` at the largest group so that JAX combines every group
    on the device."""
    paths, rl = synthetic_paths(np.random.default_rng(23),
                                [1, 31, 32, 33, 70, 40], disjoint=(5,))
    a = [x.numpy() for x in paths]
    p_max = 72
    assert np.bincount(a[0] * 8 + a[1]).max() <= p_max
    res = jcomb.combine_paths(*a, np.ones(len(a[0]), bool), rl.numpy(),
                              n_groups=8, p_max=p_max)
    assert not np.asarray(res.fallback).any()
    ok = np.asarray(res.group_valid)
    sp, gstart = sort_paths(paths)
    got = combine_paths(sp, gstart, rl)
    assert np.array_equal(sp.read[gstart[:-1].long()].numpy(),
                          np.asarray(res.group_read)[ok])
    assert np.array_equal(_bits(got.numpy()), _bits(np.asarray(res.score)[ok]))
    assert ok.sum() == 6
