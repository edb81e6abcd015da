"""Port parity for the chunked index (a DB streamed through the device in
AA-aligned chunks): ``chunk_bounds`` and a forced-chunked ``ChunkedIndex``
against the JAX package's ``chunked`` module, and the chunked classifier
against the JAX package's and against the port's single index. Tolerance
is zero: match columns and output files are equal."""

import os

import numpy as np
import pytest
import torch

from helpers import jax_native
from metabuli_tpu.classify import chunked as jchunked
from metabuli_tpu.classify.classifier import Classifier as JaxClassifier
from metabuli_tpu.ops import encode as jenc
from metabuli_tpu.ops.genetic_code import encode_seqs_padded
from metabuli_tpu.params import ClassifyParams as JaxParams
from metabuli_tpu_torch.classify import chunked
from metabuli_tpu_torch.classify.classifier import Classifier
from metabuli_tpu_torch.classify.pipeline import (FIELDS, build_dev_index,
                                                  classify_core,
                                                  matches_to_host)
from metabuli_tpu_torch.cli import main as port_main
from metabuli_tpu_torch.params import ClassifyParams
from test_torch_classify import _golden_db
from test_torch_slice7 import _build, assert_same, outputs

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX side on its native path, wherever this module runs."""
    jax_native.loaded()


def _world(reduced: bool, seed: int = 5):
    """16 wobble-diverged copies of a 1.5 kb genome beside 500 bp of their
    own: deep AA groups, so chunk bounds must move to group ends; values
    unique per (value, genome), sorted, and 32 reads."""
    rng = np.random.default_rng(seed)
    core = rng.choice(ACGT, 1500)
    genomes = []
    for _ in range(16):
        c = core.copy()
        w = np.arange(2, len(c), 3)
        m = w[rng.random(len(w)) < 0.15]
        c[m] = ACGT[(np.searchsorted(ACGT, c[m])
                     + rng.integers(1, 4, len(m))) % 4]
        genomes.append(bytes(c) + bytes(rng.choice(ACGT, 500)))
    vs, ts = [], []
    for g, seq in enumerate(genomes):
        codes, lens = encode_seqs_padded([seq])
        mm = jenc.extract_metamers(codes, lens, reduced=reduced)
        v = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])
        vs.append(v)
        ts.append(np.full(len(v), g + 2, np.int32))
    values, taxids = np.concatenate(vs), np.concatenate(ts)
    o = np.lexsort((taxids, values))
    reads = [genomes[i % 16][j * 90:j * 90 + 150] for i in range(16)
             for j in (1, 9)]
    t2s = (np.arange(32, dtype=np.int32) % 7) + 1
    return values[o], taxids[o], t2s, reads


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 3, 7, 64])
def test_chunk_bounds_equal_jax(reduced, n_chunks):
    values = _world(reduced)[0]
    want = jchunked.chunk_bounds(values, n_chunks, reduced)
    assert chunked.chunk_bounds(values, n_chunks, reduced) == want
    # each group in one chunk
    aa = values >> np.uint64(32 if reduced else 24)
    for a, b in want[1:]:
        assert a == len(values) or a == 0 or aa[a] != aa[a - 1]


@pytest.mark.parametrize("reduced", [False, True], ids=["std", "reduced"])
def test_chunked_matches_equal_single_and_jax(reduced):
    """A ChunkedIndex forced to >= 3 chunks (a budget of 6 B a row, as the
    JAX package's own test forces it): its match columns equal the port's
    single index and JAX's classify_batch_chunked, for every field."""
    values, taxids, t2s, reads = _world(reduced)
    v, t = values[:-1], taxids[:-1]
    budget = len(v) * 6
    ch = chunked.ChunkedIndex(v, t, budget, reduced=reduced, device="cpu")
    jch = jchunked.ChunkedIndex(v, t, hbm_budget_bytes=budget,
                                reduced=reduced)
    assert len(ch.bounds) >= 3 and jch.n_chunks >= 3
    codes, lens = encode_seqs_padded(reads)
    n = len(reads)
    offs, qids = np.zeros(n, np.int32), np.arange(n, dtype=np.int32)
    cap = 64
    want = jchunked.classify_batch_chunked(
        jch, t2s, t2s, codes, lens, offs, qids, cap=cap,
        max_matches=1 << 18, reduced=reduced)
    args = (torch.from_numpy(t2s), torch.from_numpy(codes),
            torch.from_numpy(lens), torch.from_numpy(offs),
            torch.from_numpy(qids))
    got = {}
    for name, index in (("chunked", ch),
                        ("single", build_dev_index(v, t, reduced=reduced))):
        m, _ = classify_core(index, *args, cap=cap)
        got[name] = matches_to_host(m)
    assert want["n_matches"] == got["chunked"]["n_matches"] > 0
    assert got["single"]["n_matches"] == want["n_matches"]
    for k in FIELDS:
        assert np.array_equal(got["chunked"][k], want[k]), k
        assert np.array_equal(got["single"][k], want[k]), k


def test_chunked_index_drops_empty_chunks():
    """A budget of one byte asks for 28 chunks a row: what is left is one
    chunk per AA group, every row in exactly one."""
    values, taxids, _, _ = _world(False)
    ch = chunked.ChunkedIndex(values, taxids, 1, device="cpu")
    aa = values >> np.uint64(24)
    n_groups = int(np.count_nonzero(np.r_[True, aa[1:] != aa[:-1]]))
    assert ch.n_chunks == len(values) * chunked.BYTES_PER_ROW
    assert len(ch.bounds) == len(ch.chunks) == n_groups
    assert all(b > a for a, b in ch.bounds)
    assert ch.bounds[0][0] == 0 and ch.bounds[-1][1] == len(values)
    assert sum(ix.n for ix in ch.on_device()) == len(values)


@pytest.mark.parametrize("device_tax", [1, 0])
def test_chunked_classifier_equals_jax(tmp_path, device_tax):
    """Both classifiers forced to >= 3 chunks: classifications, report and
    Krona byte-equal to JAX's chunked classifier and to the port's single
    index, the device taxonomer on merged chunk matches included."""
    root, q, db = _golden_db(tmp_path, 0)
    outs = {}
    jax = JaxClassifier(db, JaxParams(seq_mode=1, batch_reads=8,
                                      device_tax=device_tax))
    v = jax.index.values[:-1]
    t = jax.index.taxids[:-1].astype(np.int32)
    jax.chunked_index = jchunked.ChunkedIndex(
        v, t, hbm_budget_bytes=len(v) * 6)
    jax.dev_index = None
    assert jax.chunked_index.n_chunks >= 3
    jax.classify_file(q, None, os.path.join(root, "jax"), "ch")
    outs["jax"] = outputs(os.path.join(root, "jax"))
    for name in ("chunked", "single"):
        clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=8,
                                            device_tax=device_tax),
                         device="cpu")
        assert clf.mode == ("device" if device_tax else "host")
        if name == "chunked":
            clf.dev_index = chunked.ChunkedIndex(v, t, len(v) * 6)
            assert len(clf.dev_index.bounds) >= 3
        s = clf.classify_file(q, None, os.path.join(root, name), "ch")
        if name == "chunked":
            assert s["stage_ms"]["chunk_copy"] >= 0
        outs[name] = outputs(os.path.join(root, name))
    assert_same(outs["jax"], outs["chunked"])
    assert_same(outs["single"], outs["chunked"])
    assert outs["chunked"]["ch_classifications.tsv"].count(b"\n1\t") >= 15


@pytest.mark.parametrize("device_tax", [1, 0])
def test_max_ram_zero_equals_unchunked(tmp_path, device_tax):
    """--max-ram 0 streams the DB one AA group a chunk (every other chunk
    empty and dropped): the same bytes as the run on one index."""
    rng = np.random.default_rng(41)
    g = bytes(rng.choice(ACGT, 700))
    db = _build(tmp_path, {"MR_A.1": (g, 4)},
                [(1, 1, "no rank"), (2, 1, "genus"), (4, 2, "species")])
    q = tmp_path / "r.fna"
    q.write_text("".join(f">r{i}\n{g[i * 50:i * 50 + 150].decode()}\n"
                         for i in range(10)))
    outs = {}
    for name, extra in (("one", []), ("zero", ["--max-ram", "0"])):
        out = str(tmp_path / name)
        assert port_main(["classify", str(q), db, out, "mr", "--seq-mode",
                          "1", "--device-tax", str(device_tax), "--device",
                          "cpu", *extra]) == 0
        outs[name] = outputs(out)
    assert_same(outs["one"], outs["zero"])
    assert outs["zero"]["mr_classifications.tsv"].count(b"\n1\t") == 10
    clf = Classifier(db, ClassifyParams(seq_mode=1, max_ram=0),
                     device="cpu")
    assert isinstance(clf.dev_index, chunked.ChunkedIndex)
    assert len(clf.dev_index.bounds) > 100


def test_build_chunks_follow_free_memory():
    """The chunks a card's free memory asks for: enough that one chunk's
    index build (BUILD_BYTES_PER_ROW a row) fits in what is free less a
    GiB, at least one."""
    gib = 1 << 30
    rows = 1 << 28
    assert chunked.build_chunks(rows, 80 * gib) == 1
    assert chunked.build_chunks(rows, 10 * gib) == -(
        -rows * chunked.BUILD_BYTES_PER_ROW // (9 * gib))
    assert chunked.build_chunks(rows, 1 << 10) == -(
        -rows * chunked.BUILD_BYTES_PER_ROW // (1 << 28))
