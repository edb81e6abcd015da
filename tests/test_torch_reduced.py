"""Port parity for the reduced 16-letter alphabet (``--reduced-aa 1``):
K11's plain version, K1's reduced extraction, the reduced index and match
core, and ``build`` and ``classify`` through both CLIs, against the JAX
package on the CPU. Tolerance is zero: integers, match columns and output
files are equal."""

import dataclasses
import os
import pathlib

import numpy as np
import pytest
import torch

from helpers import jax_native
from metabuli_tpu.classify.pipeline import (build_dev_index as jax_index,
                                            classify_batch_indexed,
                                            matches_to_host)
from metabuli_tpu.cli import main as jax_main
from metabuli_tpu.ops import encode as jenc
from metabuli_tpu.ops import hamming as jham
from metabuli_tpu.ops.genetic_code import encode_seqs_padded
from metabuli_tpu_torch.classify import pipeline
from metabuli_tpu_torch.classify.pipeline import (_search_prefix,
                                                  _search_records,
                                                  build_dev_index,
                                                  classify_core,
                                                  search_scan_plain)
from metabuli_tpu_torch.cli import main as port_main
from metabuli_tpu_torch.ops import encode as tenc
from metabuli_tpu_torch.ops import hamming as tham
from test_golden import _world
from test_torch_slice7 import assert_same, outputs

import ref_impl

ACGT = np.frombuffer(b"ACGT", np.uint8)
DATE = "2026-01-01"
DB_FILES = ("diffIdx", "info", "split", "taxID_list", "taxonomyDB.npz",
            "acc2taxid.map", "db.parameters")


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX side on its native path, wherever this module runs."""
    jax_native.loaded()


# ------------------------------------------------------------------ K11
def test_hamming_all_reduced_equals_jax():
    """Random 32-bit pairs, plus pairs whose codons all sit at a distance
    of 4 (codon numbers 9 and 10 against 4..8), so every lane spills into
    the next."""
    rng = np.random.default_rng(7)
    n = 20_000
    q = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    t = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    # codon numbers 0..10 (the ones the alphabet has) in every field
    fields = lambda: sum(rng.integers(0, 11, n).astype(np.uint64)
                         << np.uint64(4 * i) for i in range(8))
    spill_q = sum(rng.integers(9, 11, n).astype(np.uint64)
                  << np.uint64(4 * i) for i in range(8))
    spill_t = sum(rng.integers(4, 9, n).astype(np.uint64)
                  << np.uint64(4 * i) for i in range(8))
    q = np.concatenate([q, fields(), spill_q]).astype(np.uint32)
    t = np.concatenate([t, fields(), spill_t]).astype(np.uint32)
    want = jham.hamming_all_reduced(q.view(np.int32), t.view(np.int32))
    got = tham.hamming_all_reduced_plain(
        torch.from_numpy(q.astype(np.int64)),
        torch.from_numpy(t.astype(np.int64)))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # distance 4 everywhere: each 4 lands on the low bit of the next
    # codon's lane (lane 0 stays clear, the top one falls off the word)
    s = slice(2 * n, 3 * n)
    assert (got[0].numpy()[s] == 32).all()
    assert (got[1].numpy()[s] == 0x5554).all()
    assert (got[2].numpy()[s] == 0x5554).all()


# ------------------------------------------------------------------- K1
def _compare_extract(seqs, max_len=None, **kw):
    codes, lens = encode_seqs_padded(list(seqs), max_len=max_len)
    want = jenc.extract_metamers(codes, lens, reduced=True, **kw)
    got = tenc.extract_metamers(torch.from_numpy(codes),
                                torch.from_numpy(lens), reduced=True, **kw)
    valid = np.asarray(want.valid)
    assert got.dna48 is None
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
    assert np.array_equal(got.value.numpy()[valid],
                          np.asarray(want.value).view(np.int64)[valid])
    # codon numbers above 7 occur: 4-bit fields, none cut to 3 bits
    nums = got.value.numpy()[valid] & 0xFFFFFFFF
    assert any(((nums >> (4 * i)) & 15).max() > 7 for i in range(8))
    return int(valid.sum())


@pytest.mark.parametrize("syncmer", [0, 1])
@pytest.mark.parametrize("length", [24, 26, 151, 302, 1001])
def test_reduced_extract_equals_jax(length, syncmer):
    rng = np.random.default_rng(length + 11 * syncmer)
    seqs = [ref_impl.random_dna(rng, length, n_prob=0.03) for _ in range(6)]
    if length < 26:
        seqs.append(ref_impl.random_dna(rng, 60, n_prob=0.0))
    assert _compare_extract(seqs, syncmer=bool(syncmer)) > 0


@pytest.mark.parametrize("smer_len", [3, 6])
def test_reduced_extract_syncmer_lengths(smer_len):
    rng = np.random.default_rng(300 + smer_len)
    seqs = [ref_impl.random_dna(rng, 160, n_prob=0.1) for _ in range(6)]
    assert _compare_extract(seqs, syncmer=True, smer_len=smer_len) > 0


# ------------------------------------------------- reduced index and core
def _reduced_world(syncmer):
    """24 genomes share a wobble-diverged 1.2 kb block (groups ~24 deep,
    their rows at varied reduced distances) beside 600 bp of their own;
    values unique per (value, genome), sorted."""
    rng = np.random.default_rng(23 + syncmer)
    core = rng.choice(ACGT, 1200)
    genomes = []
    for _ in range(24):
        c = core.copy()
        w = np.arange(2, len(c), 3)
        m = w[rng.random(len(w)) < 0.2]
        c[m] = ACGT[(np.searchsorted(ACGT, c[m])
                     + rng.integers(1, 4, len(m))) % 4]
        genomes.append(bytes(c) + bytes(rng.choice(ACGT, 600)))
    vs, ts = [], []
    for g, seq in enumerate(genomes):
        codes, lens = encode_seqs_padded([seq])
        mm = jenc.extract_metamers(codes, lens, reduced=True,
                                   syncmer=bool(syncmer))
        v = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])
        vs.append(v)
        ts.append(np.full(len(v), g + 3, np.int32))
    values, taxids = np.concatenate(vs), np.concatenate(ts)
    o = np.lexsort((taxids, values))
    reads = []
    for i in range(40):
        g = genomes[i % 24]
        st = int(rng.integers(0, len(g) - 150))
        reads.append(g[st:st + 150])
    t2s = (np.arange(64, dtype=np.int32) % 9) + 1
    return values[o], taxids[o], t2s, reads


def _cols(m):
    return {"qid": m.qid, "species": m.species, "pos": m.pos, "dna": m.dna,
            "taxid": m.taxid, "frame": m.packed & 7,
            "hamming": (m.packed >> 3) & 0xFF,
            "h16": (m.packed >> 11) & 0xFFFF}


def _assert_equal_host(got: dict, want: dict, n: int):
    assert n > 0 and want["n_matches"] == n
    for k in ("qid", "species", "frame", "pos", "hamming", "dna", "taxid",
              "h16"):
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        assert np.array_equal(g, want[k][:n]), k


@pytest.mark.parametrize("syncmer", [0, 1])
@pytest.mark.parametrize("deep", [True, False])
def test_reduced_core_equals_jax(syncmer, deep):
    """One reduced index: search_scan_plain's kept rows, fetched and
    lexsorted, and classify_core's sorted columns equal the JAX package's
    host match dict, at the full depth and at a cap that cuts groups."""
    values, taxids, t2s, reads = _reduced_world(syncmer)
    aa = values >> np.uint64(32)
    depth = np.diff(np.flatnonzero(np.r_[True, aa[1:] != aa[:-1], True]))
    cap = int(depth.max()) if deep else 3
    assert depth.max() > 3
    codes, lens = encode_seqs_padded(reads)
    n = len(reads)
    want = matches_to_host(classify_batch_indexed(
        jax_index(values, taxids, reduced=True), t2s, codes, lens,
        np.zeros(n, np.int32), np.arange(n, dtype=np.int32), cap=cap,
        max_matches=1 << 18, reduced=True, syncmer=bool(syncmer)), t2s)
    index = build_dev_index(values, taxids, reduced=True)
    assert index.reduced and index.d48 is None
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)
    m, counts = classify_core(
        index, torch.from_numpy(t2s), tc, tl,
        torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), cap=cap, syncmer=bool(syncmer))
    assert counts["n_over_cap"] == want["n_over_cap"]
    assert (want["n_over_cap"] > 0) == (not deep)
    _assert_equal_host(_cols(m), want, counts["n_matches"])
    # K11's plain version alone: its kept rows, fetched and lexsorted
    mm = tenc.extract_metamers_plain(tc, tl, reduced=True,
                                     syncmer=bool(syncmer))
    W = mm.value.shape[2]
    cand = search_scan_plain(index, mm.value.reshape(-1),
                             mm.valid.reshape(-1), None, W, cap)
    slot = cand.slot.numpy().astype(np.int64)
    tw = index.taxdna.numpy()[cand.row.numpy()]
    pay = cand.pay.numpy()
    host = {"qid": slot // (6 * W), "frame": pay & 7,
            "pos": mm.pos.reshape(-1).numpy()[slot],
            "hamming": (pay >> 3) & 7, "h16": pay >> 6,
            "dna": (tw >> 32).astype(np.uint32).view(np.int32),
            "taxid": (tw & 0xFFFFFFFF).astype(np.int32)}
    host["species"] = t2s[host["taxid"]]
    o = np.lexsort((host["dna"].view(np.uint32), host["hamming"],
                    host["pos"], host["frame"], host["species"],
                    host["qid"]))
    _assert_equal_host({k: v[o] for k, v in host.items()}, want, len(o))


def _record_queries(values, reads, rng):
    """Query slots against a reduced table: the reads' metamers, every
    table row's value (hits) and random values (mostly misses), a tenth
    of them invalid."""
    codes, lens = encode_seqs_padded(reads)
    mm = tenc.extract_metamers_plain(torch.from_numpy(codes),
                                     torch.from_numpy(lens), reduced=True)
    rand = rng.integers(0, 1 << 63, 4000, dtype=np.int64)
    q_value = torch.cat([mm.value.reshape(-1),
                         torch.from_numpy(values.view(np.int64)),
                         torch.from_numpy(rand)])
    q_valid = torch.from_numpy(rng.random(q_value.numel()) < 0.9)
    return q_value, q_valid


def _prefix_layout(index):
    """The same reduced index searched over ``prefix`` (the standard
    layout's lower bound)."""
    return dataclasses.replace(index, prefix=index.bucket_prefix(),
                               brec=None)


@pytest.fixture(scope="module")
def jax_world_matches():
    """``_reduced_world(0)`` and the JAX package's host matches of its
    reads at a cap of 4,096."""
    values, taxids, t2s, reads = _reduced_world(0)
    codes, lens = encode_seqs_padded(reads)
    n = len(reads)
    want = matches_to_host(classify_batch_indexed(
        jax_index(values, taxids, reduced=True), t2s, codes, lens,
        np.zeros(n, np.int32), np.arange(n, dtype=np.int32), cap=4096,
        max_matches=1 << 18, reduced=True), t2s)
    return (values, taxids, t2s, reads), want


@pytest.mark.parametrize("bits", [None, 1, 2, 5, 9],
                         ids=["picked", "b1", "b2", "b5", "b9"])
def test_bucket_records_search_equals_prefix_search(bits, monkeypatch,
                                                    jax_world_matches):
    """The reduced index's bucket records and codon column: the plain
    search over the records gives the lower bound over ``prefix``'s
    (gstart, gend, hit), search_scan_plain the same candidates over both
    layouts, and classify_core the JAX package's matches. At the picked
    width buckets hold 0, 1 and several groups; forced to 1-9 prefix bits
    they hold hundreds, with group counts at the record's cap (the end
    read from the next record)."""
    if bits is not None:
        monkeypatch.setattr(pipeline, "pick_prefix_bits", lambda n: bits)
    (values, taxids, t2s, reads), want = jax_world_matches
    index = build_dev_index(values, taxids, reduced=True)
    pb = index.prefix_bits
    assert index.prefix is None and index.brec.shape == ((1 << pb) + 1, 4)
    assert index.brec.dtype == index.tword.dtype == torch.int32
    assert np.array_equal(index.tword.numpy().view(np.uint32),
                          (values & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    prefix = index.bucket_prefix()
    counts = (prefix[1:] - prefix[:-1]).numpy()
    field = (index.brec[:-1, 0].numpy().view(np.uint32)
             >> np.uint32(32 - pb)).astype(np.int64)
    assert np.array_equal(field, np.minimum(counts, (1 << pb) - 1))
    if bits is None:
        assert pb >= 12 and {0, 1} <= set(counts) and counts.max() > 1
    elif bits < 9:
        assert pb == bits and counts.max() >= (1 << pb) - 1
    else:
        assert pb == bits and 1 < counts.min() <= counts.max() < (1 << pb) - 1
    rng = np.random.default_rng(40 + pb)
    q_value, q_valid = _record_queries(values, reads, rng)
    gs, ge, hit = _search_records(index, q_value, q_valid)
    ws, we, whit = _search_prefix(_prefix_layout(index), q_value, q_valid)
    assert torch.equal(hit, whit) and int(hit.sum()) > len(values) // 2
    assert torch.equal(gs[hit], ws[hit]) and torch.equal(ge[hit], we[hit])
    assert int((ge - gs)[~hit].abs().sum()) == 0
    W = 7
    for cap in (3, 4096):
        got = search_scan_plain(index, q_value, q_valid, None, W, cap)
        over_prefix = search_scan_plain(_prefix_layout(index), q_value,
                                        q_valid, None, W, cap)
        for g, w in zip(got, over_prefix):
            assert (torch.equal(g, w) if torch.is_tensor(g) else g == w)
        assert got.row.numel() > 0
    # the whole core against the JAX package's index (its own width)
    codes, lens = encode_seqs_padded(reads)
    n = len(reads)
    m, c = classify_core(index, torch.from_numpy(t2s),
                         torch.from_numpy(codes), torch.from_numpy(lens),
                         torch.zeros(n, dtype=torch.int32),
                         torch.arange(n, dtype=torch.int32), cap=4096)
    _assert_equal_host(_cols(m), want, c["n_matches"])


def test_bucket_records_of_an_empty_table():
    """An empty reduced table: every record empty, its sentinel at group
    0, and no query finds a group."""
    index = build_dev_index(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                            reduced=True)
    assert index.n == 0 and index.tword.numel() == 0
    assert int(index.brec.abs().sum()) == 0
    rng = np.random.default_rng(2)
    q_value = torch.from_numpy(rng.integers(0, 1 << 63, 500,
                                            dtype=np.int64))
    q_valid = torch.ones(500, dtype=torch.bool)
    assert not bool(_search_records(index, q_value, q_valid)[2].any())
    got = search_scan_plain(index, q_value, q_valid, None, 5, 8)
    assert got.row.numel() == 0 and got.n_over_cap == 0


# ------------------------------------------------------ build and classify
def _build_both(root, lib, acc, taxdir, flags):
    dbs = {}
    for side, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        dbs[side] = os.path.join(root, f"{side}_db")
        assert main(["build", dbs[side], lib, acc, "--taxonomy-path",
                     taxdir, "--reduced-aa", "1", "--db-date", DATE,
                     *flags, *extra]) == 0
    for name in DB_FILES:
        assert (pathlib.Path(dbs["port"], name).read_bytes()
                == pathlib.Path(dbs["jax"], name).read_bytes()), name
    assert "Reduced_alphabet\t1" in pathlib.Path(
        dbs["port"], "db.parameters").read_text()
    return dbs


@pytest.fixture(scope="module", params=[0, 1], ids=["s0", "s1"])
def reduced_golden(request, tmp_path_factory):
    """The golden world built reduced through both CLIs (gene prediction
    off, syncmer off and on); the DBs are byte-equal."""
    syncmer = request.param
    root, q = _world(tmp_path_factory.mktemp(f"reduced_s{syncmer}"))
    dbs = _build_both(root, os.path.join(root, "library.txt"),
                      os.path.join(root, "acc2taxid.map"),
                      os.path.join(root, "taxonomy"),
                      ["--gene-prediction", "0", "--syncmer", str(syncmer)])
    return root, q, dbs


def test_reduced_build_equals_jax(reduced_golden):
    _, _, dbs = reduced_golden
    assert os.path.getsize(os.path.join(dbs["port"], "diffIdx")) > 0


@pytest.mark.parametrize("mode", [["--device-tax", "1"],
                                  ["--device-tax", "0"],
                                  ["--print-log", "1", "--verbosity", "0"]],
                         ids=["device_tax1", "device_tax0", "print_log"])
def test_reduced_classify_equals_jax(reduced_golden, mode, capsys):
    """The classifications, report and Krona files of both CLIs on the
    reduced DB (and, with --print-log, what they print); --device-tax 1
    takes the host taxonomer on a reduced DB in both packages."""
    root, q, dbs = reduced_golden
    job = "r" + mode[0][2] + mode[1]
    capsys.readouterr()
    outs, logs = {}, {}
    for side, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out = os.path.join(root, f"{side}_{job}")
        assert main(["classify", q, dbs["jax"], out, job, "--seq-mode", "1",
                     "--batch-reads", "8", *mode, *extra]) == 0
        outs[side] = outputs(out)
        logs[side] = capsys.readouterr().out
    assert_same(outs["jax"], outs["port"])
    assert outs["port"][f"{job}_classifications.tsv"].count(b"\n1\t") >= 10
    if "--print-log" in mode:
        assert logs["port"] == logs["jax"]
        assert logs["port"].count("Current species: ") > 0


def test_reduced_gene_predicted_build_equals_jax(tmp_path):
    """Defaults (gene prediction and masking on), reduced: one 100 kb
    species of the skew world."""
    from metabuli_tpu_torch.tools import world

    tax, genomes, _ = world.make_world(str(tmp_path), "skew")
    lib, acc = world.write_library(str(tmp_path / "lib"), genomes[:1],
                                   world.genus_of(tax, genomes[:1]))
    _build_both(str(tmp_path), lib, acc, str(tmp_path / "skew_taxonomy"), [])
