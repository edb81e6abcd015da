"""Port parity for read grouping (``readgroup/group.py``): the groups of
``build_read_groups`` (K1's metamers, vectorised pair counting and
connected components) and ``grouping`` through both CLIs, against the JAX
package on the CPU. Tolerance is zero: labels, files and stdout are
equal."""

import contextlib
import io
import pathlib

import numpy as np
import pytest

from helpers import jax_native
from metabuli_tpu.cli import main as jax_main
from metabuli_tpu.readgroup import group as jgroup
from metabuli_tpu_torch.cli import main as port_main
from metabuli_tpu_torch.readgroup import group as tgroup

ACGT = np.frombuffer(b"ACGT", np.uint8)
DATE = "2026-01-01"


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native.loaded()


def _reads(seed, n_genomes=6, n_reads=240, length=150, shared=0):
    """Overlapping reads of a few random genomes (some with a shared
    ``shared``-base block, so k-mer groups span genomes), a few random
    ones, half reverse-complemented, some with a substitution."""
    rng = np.random.default_rng(seed)
    block = rng.choice(ACGT, shared)
    genomes = [np.concatenate([rng.choice(ACGT, 1500), block,
                               rng.choice(ACGT, 1500)])
               for _ in range(n_genomes)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(n_reads):
        if i % 12 == 11:
            reads.append(bytes(rng.choice(ACGT, length)))
            continue
        g = genomes[i % n_genomes]
        st = int(rng.integers(0, len(g) - length))
        r = g[st:st + length].copy()
        if i % 3 == 0:
            p = int(rng.integers(0, length))
            r[p] = ACGT[(np.searchsorted(ACGT, r[p]) + 1) % 4]
        r = r.tobytes()
        reads.append(r.translate(comp)[::-1] if i % 2 else r)
    return reads


@pytest.mark.parametrize("min_shared", [1, 2, 5])
def test_build_read_groups_equals_jax(min_shared):
    reads = _reads(3)
    want = jgroup.build_read_groups(reads, min_shared)
    got = tgroup.build_read_groups(reads, min_shared, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert 1 < len(np.unique(got)) < len(reads)


def test_build_read_groups_past_max_degree_equal_jax():
    """A block shared by 80 reads of 40 genomes: its k-mers hit more
    reads than max_kmer_degree (64, and 8 here) and are skipped."""
    reads = _reads(5, n_genomes=40, n_reads=400, shared=600)
    for degree in (64, 8):
        want = jgroup.build_read_groups(reads, 2, max_kmer_degree=degree)
        got = tgroup.build_read_groups(reads, 2, max_kmer_degree=degree,
                                       device="cpu")
        assert np.array_equal(got, want)
    assert not np.array_equal(
        got, tgroup.build_read_groups(reads, 2, max_kmer_degree=1000,
                                      device="cpu"))


@pytest.mark.parametrize("neighbor", [0, 12, 60])
def test_build_read_groups_with_common_kmers_equal_jax(neighbor):
    """Common-k-mer suppression: a third of the reads' metamer values
    stand for the common DB, with suppression windows of 0-60 bases."""
    from metabuli_tpu.ops import encode as jenc
    from metabuli_tpu.ops.genetic_code import encode_seqs_padded

    reads = _reads(7)
    codes, lens = encode_seqs_padded(reads[::3])
    mm = jenc.extract_metamers(codes, lens)
    common = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])[::2]
    kw = dict(neighbor_kmers=neighbor, common_values=common)
    want = jgroup.build_read_groups(reads, 2, **kw)
    got = tgroup.build_read_groups(reads, 2, device="cpu", **kw)
    assert np.array_equal(got, want)
    if neighbor:  # the windows around matches cut edges
        plain = tgroup.build_read_groups(reads, 2, device="cpu")
        assert not np.array_equal(got, plain)


def test_component_labels_equal_disjoint_set():
    """Random graphs, unions in random order: each node's least connected
    id is the DisjointSet's root."""
    rng = np.random.default_rng(11)
    for n, m in ((1, 0), (50, 20), (400, 380), (1000, 3000)):
        x = rng.integers(0, n, m)
        y = rng.integers(0, n, m)
        ds = tgroup.DisjointSet(n)
        for a, b in zip(x, y):
            ds.union(int(a), int(b))
        assert np.array_equal(tgroup.component_labels(n, x, y),
                              ds.labels())


# ------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def grouping_world(tmp_path_factory):
    """A DB of six genomes, their reads classified by the JAX CLI with a
    tenth of the classifications blanked (so groups rescue them), and a
    common-k-mer list of the DB."""
    from metabuli_tpu_torch.tools import world

    root = tmp_path_factory.mktemp("grouping")
    tax, genomes, _ = world.make_world(str(root), "uniform")
    genomes = [(g[:12_000], sp) for g, sp in genomes[:6]]
    lib, acc = world.write_library(str(root / "lib"), genomes,
                                   world.genus_of(tax, genomes))
    db = str(root / "db")
    assert jax_main(["build", db, lib, acc, "--taxonomy-path",
                     str(root / "uniform_taxonomy"), "--gene-prediction",
                     "0", "--db-date", DATE]) == 0
    rng = np.random.default_rng(2)
    reads = world.sample_reads(genomes, rng, 300, 150, max_mut=3)
    q = root / "reads.fna"
    q.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in
                         enumerate(reads)))
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(["classify", str(q), db, str(root / "cls"), "g",
                         "--seq-mode", "1"]) == 0
    lines = (root / "cls" / "g_classifications.tsv").read_text().splitlines(
        keepends=True)
    for i in range(0, len(lines), 10):
        cols = lines[i].split("\t")
        lines[i] = "\t".join(["0", cols[1], "0", *cols[3:]])
    (root / "cls.tsv").write_text("".join(lines))
    common = str(root / "common")
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(["create-common-kmer-list", db, common]) == 0
    return {"root": root, "q": str(q), "db": db, "cls": str(root / "cls.tsv"),
            "common": common}


@pytest.mark.parametrize("flags", [
    [], ["--weight-mode", "1"], ["--weight-mode", "2", "--min-vote-score",
                                 "0.5"], ["--dbdir", "{db}"],
    ["--dbdir", "{db}", "--weight-mode", "1", "--majority-thr", "0.7"],
    ["--common-kmer-db", "{common}", "--neighbor-kmers", "12",
     "--dbdir", "{db}"], ["--min-edge", "4"]],
    ids=["uniform", "score", "score2", "dbdir", "dbdir_score", "common",
         "min_edge"])
def test_grouping_cli_equals_jax(grouping_world, flags, request):
    w = grouping_world
    flags = [f.format(db=w["db"], common=w["common"]) for f in flags]
    printed, files = {}, {}
    for side, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out = w["root"] / f"{side}_{request.node.callspec.id}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["grouping", w["q"], w["cls"], str(out), *flags,
                         *extra]) == 0
        printed[side] = buf.getvalue().replace(str(out), "<out>")
        files[side] = (out / "read_groups.tsv").read_bytes()
    assert printed["port"] == printed["jax"]
    assert files["port"] == files["jax"]
    assert '"rescued": 0' not in printed["port"]


def test_grouping_needs_cuda_unless_cpu_is_asked(grouping_world, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = grouping_world
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["grouping", w["q"], w["cls"],
                   str(w["root"] / "no_card")])
    assert not pathlib.Path(w["root"] / "no_card" / "read_groups.tsv").exists()
