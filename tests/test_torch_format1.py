"""Port parity for old-format (``kmer_format`` 1) databases: K1's format-1
packing (plain version), ``expand_db_dna48``, the match core with K2's
format flag, and ``build``, ``classify`` and ``updateDB`` through both
CLIs, against the JAX package on the CPU. Tolerance is zero: integers,
match columns and output files are equal."""

import os
import pathlib

import numpy as np
import pytest
import torch

from helpers import jax_native
from metabuli_tpu.classify.pipeline import (build_dev_index as jax_index,
                                            classify_batch_indexed,
                                            matches_to_host)
from metabuli_tpu.classify.pipeline import expand_db_dna48 as jax_expand
from metabuli_tpu.cli import main as jax_main
from metabuli_tpu.ops import encode as jenc
from metabuli_tpu.ops.genetic_code import encode_seqs_padded
from metabuli_tpu_torch.classify.pipeline import (build_dev_index,
                                                  classify_core,
                                                  expand_db_dna48)
from metabuli_tpu_torch.cli import main as port_main
from metabuli_tpu_torch.ops import encode as tenc
from test_golden import _world
from test_torch_reduced import DB_FILES, _assert_equal_host, _cols
from test_torch_slice7 import assert_same, outputs

import ref_impl

ACGT = np.frombuffer(b"ACGT", np.uint8)
DATE = "2026-01-01"
SIDES = (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"]))


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX side on its native path, wherever this module runs."""
    jax_native.loaded()


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("reduced", [0, 1])
@pytest.mark.parametrize("syncmer", [0, 1])
def test_format1_extract_equals_jax(syncmer, reduced):
    """Lengths below, at and past one metamer, N runs, a padded batch."""
    rng = np.random.default_rng(40 + 2 * syncmer + reduced)
    seqs = [ref_impl.random_dna(rng, n, n_prob=0.03)
            for n in (24, 26, 27, 151, 302, 1001)]
    seqs.append(ref_impl.random_dna(rng, 400, n_prob=0.0)[:200] + b"N" * 30
                + ref_impl.random_dna(rng, 170, n_prob=0.0))
    codes, lens = encode_seqs_padded(seqs, max_len=1024)
    kw = dict(syncmer=bool(syncmer), reduced=bool(reduced), kmer_format=1)
    want = jenc.extract_metamers(codes, lens, **kw)
    got = tenc.extract_metamers(torch.from_numpy(codes),
                                torch.from_numpy(lens), **kw)
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
    assert np.array_equal(got.value.numpy()[valid],
                          np.asarray(want.value).view(np.int64)[valid])
    if reduced:
        assert got.dna48 is None
    else:
        assert np.array_equal(got.dna48.numpy()[valid],
                              np.asarray(want.dna48).view(np.int64)[valid])
    # the format differs from format 2 wherever a window is not a palindrome
    two = tenc.extract_metamers(torch.from_numpy(codes),
                                torch.from_numpy(lens), syncmer=bool(syncmer),
                                reduced=bool(reduced))
    assert not torch.equal(two.value, got.value)


def test_format1_expand_db_dna48_equals_jax():
    rng = np.random.default_rng(5)
    seqs = [ref_impl.random_dna(rng, 900, n_prob=0.0) for _ in range(4)]
    codes, lens = encode_seqs_padded(seqs)
    mm = jenc.extract_metamers(codes, lens, kmer_format=1)
    values = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])
    want = jax_expand(values, kmer_format=1)
    got = expand_db_dna48(torch.from_numpy(values.view(np.int64)),
                          kmer_format=1)
    assert np.array_equal(got.numpy(), want.view(np.int64))
    # each row's d48 is its metamer's own bases (mm.dna48), codon i at 6i
    d48 = np.asarray(mm.dna48)[np.asarray(mm.valid)]
    v = np.asarray(mm.value)[np.asarray(mm.valid)]
    assert np.array_equal(want[np.searchsorted(values, v)], d48)


# ----------------------------------------------------- index and core
def _format1_world(syncmer):
    """24 genomes share a wobble-diverged 1.2 kb block beside 600 bp of
    their own (groups ~24 deep, rows at varied distances), as format-1
    values unique per (value, genome), sorted; reads cut from them with
    three bases substituted, half reverse-complemented."""
    rng = np.random.default_rng(61 + syncmer)
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
        mm = jenc.extract_metamers(codes, lens, syncmer=bool(syncmer),
                                   kmer_format=1)
        v = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])
        vs.append(v)
        ts.append(np.full(len(v), g + 3, np.int32))
    values, taxids = np.concatenate(vs), np.concatenate(ts)
    o = np.lexsort((taxids, values))
    reads = []
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for i in range(40):
        g = genomes[i % 24]
        st = int(rng.integers(0, len(g) - 150))
        r = np.frombuffer(g[st:st + 150], np.uint8).copy()
        m = rng.choice(150, 3, replace=False)
        r[m] = ACGT[(np.searchsorted(ACGT, r[m]) + 1) % 4]
        r = r.tobytes()
        reads.append(r.translate(comp)[::-1] if i % 2 else r)
    t2s = (np.arange(64, dtype=np.int32) % 9) + 1
    return values[o], taxids[o], t2s, reads


@pytest.mark.parametrize("syncmer", [0, 1])
def test_format1_core_equals_jax(syncmer):
    """A format-1 index: classify_core's sorted columns (h16 included,
    which the format flag orients) equal the JAX package's host match
    dict."""
    values, taxids, t2s, reads = _format1_world(syncmer)
    codes, lens = encode_seqs_padded(reads)
    n = len(reads)
    index = build_dev_index(values, taxids, kmer_format=1)
    cap = index.max_group
    want = matches_to_host(classify_batch_indexed(
        jax_index(values, taxids, kmer_format=1), t2s, codes, lens,
        np.zeros(n, np.int32), np.arange(n, dtype=np.int32), cap=cap,
        max_matches=1 << 18, kmer_format=1, syncmer=bool(syncmer)), t2s)
    m, counts = classify_core(
        index, torch.from_numpy(t2s), torch.from_numpy(codes),
        torch.from_numpy(lens), torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), cap=cap, syncmer=bool(syncmer))
    assert index.kmer_format == 1 and counts["n_over_cap"] == 0
    _assert_equal_host(_cols(m), want, counts["n_matches"])
    # both orientations occur, and h16 words that are not mirror images
    h16 = want["h16"][:counts["n_matches"]]
    assert (h16 != 0).any() and (want["frame"] >= 3).any()


# ------------------------------------------------------ build and classify
def _build_both(root, lib, acc, taxdir, flags):
    dbs = {}
    for side, main, extra in SIDES:
        dbs[side] = os.path.join(root, f"{side}_db")
        assert main(["build", dbs[side], lib, acc, "--taxonomy-path",
                     taxdir, "--kmer-format", "1", "--db-date", DATE,
                     *flags, *extra]) == 0
    for name in DB_FILES:
        assert (pathlib.Path(dbs["port"], name).read_bytes()
                == pathlib.Path(dbs["jax"], name).read_bytes()), name
    assert "Kmer_format\t1" in pathlib.Path(
        dbs["port"], "db.parameters").read_text()
    return dbs


@pytest.fixture(scope="module", params=[
    [], ["--syncmer", "1"], ["--reduced-aa", "1"]],
    ids=["s0", "s1", "reduced"])
def format1_golden(request, tmp_path_factory):
    """The golden world built with --kmer-format 1 through both CLIs (gene
    prediction off); the DBs are byte-equal."""
    root, q = _world(tmp_path_factory.mktemp("format1"))
    dbs = _build_both(root, os.path.join(root, "library.txt"),
                      os.path.join(root, "acc2taxid.map"),
                      os.path.join(root, "taxonomy"),
                      ["--gene-prediction", "0", *request.param])
    return root, q, dbs


def test_format1_build_equals_jax(format1_golden):
    _, _, dbs = format1_golden
    assert os.path.getsize(os.path.join(dbs["port"], "diffIdx")) > 0


def _classify_both(root, q, db, job, mode, capsys, jax_mode=None):
    """Both CLIs on ``db``: their output files and what they printed."""
    capsys.readouterr()
    outs, logs = {}, {}
    for side, main, extra in SIDES:
        out = os.path.join(root, f"{side}_{job}")
        flags = jax_mode if side == "jax" and jax_mode is not None else mode
        assert main(["classify", q, db, out, job, "--seq-mode", "1",
                     *flags, *extra]) == 0
        outs[side] = outputs(out)
        logs[side] = capsys.readouterr().out
    assert_same(outs["jax"], outs["port"])
    assert outs["port"][f"{job}_classifications.tsv"].count(b"\n1\t") >= 10
    return logs


@pytest.mark.parametrize("mode", [
    ["--device-tax", "1"], ["--device-tax", "0"],
    ["--print-log", "1", "--verbosity", "0"]],
    ids=["device_tax1", "device_tax0", "print_log"])
def test_format1_classify_equals_jax(format1_golden, mode, capsys):
    """The classifications, report and Krona files of both CLIs on the
    format-1 DB (and, with --print-log, what they print)."""
    root, q, dbs = format1_golden
    logs = _classify_both(root, q, dbs["jax"], "f" + mode[0][2:4] + mode[1],
                          ["--batch-reads", "8", *mode], capsys)
    if "--print-log" in mode:
        assert logs["port"] == logs["jax"]


@pytest.mark.parametrize("format1_golden", [[]], indirect=True, ids=["s0"])
def test_format1_chunked_classify_equals_jax(format1_golden, capsys):
    """The port's --max-ram 0 (one AA group a chunk, each chunk's index
    built with the DB's format) gives the JAX package's bytes on its
    single index: the JAX chunked classifier fails on one-row chunks."""
    root, q, dbs = format1_golden
    mode = ["--batch-reads", "64"]
    _classify_both(root, q, dbs["jax"], "fch", [*mode, "--max-ram", "0"],
                   capsys, jax_mode=mode)


def test_format1_update_equals_jax(tmp_path):
    """updateDB on a format-1 DB inherits the format: a new genus of two
    species added through both CLIs gives equal DBs, still format 1."""
    from metabuli_tpu_torch.tools import world

    tax, genomes, _ = world.make_world(str(tmp_path), "uniform")
    genomes = [(g[:20_000], sp) for g, sp in genomes[:2]]
    lib, acc = world.write_library(str(tmp_path / "lib"), genomes,
                                   world.genus_of(tax, genomes))
    dbs = _build_both(str(tmp_path), lib, acc,
                      str(tmp_path / "uniform_taxonomy"),
                      ["--gene-prediction", "0"])
    new_lib, new_acc, new_taxa, _ = world.new_genus(
        str(tmp_path / "new"), tax, n_species=2, length=20_000)
    for side, main, extra in SIDES:
        assert main(["updateDB", os.path.join(tmp_path, f"{side}_up"),
                     new_lib, new_acc, "--old-db", dbs[side], "--new-taxa",
                     new_taxa, "--gene-prediction", "0", "--db-date", DATE,
                     *extra]) == 0
    for name in DB_FILES:
        assert ((tmp_path / "port_up" / name).read_bytes()
                == (tmp_path / "jax_up" / name).read_bytes()), name
    assert "Kmer_format\t1" in (tmp_path / "port_up"
                                / "db.parameters").read_text()
