"""The host taxonomer (``--device-tax 0``, ``--print-log``) and long reads
(``--seq-mode 3``) through the port on the CPU, byte-equal to the JAX
package on the same inputs and DB, with zero tolerance."""

import os
import pathlib

import numpy as np
import pytest

from helpers import jax_native
from metabuli_tpu.cli import main as jax_main
from metabuli_tpu.db.build import build_database
from metabuli_tpu.params import BuildParams
from metabuli_tpu_torch.classify import classifier as port_classifier
from metabuli_tpu_torch.cli import main as port_main
from test_torch_classify import _golden_db


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX side on its native path, wherever this module runs."""
    jax_native.loaded()


ACGT = np.array(list(b"ACGT"), np.uint8)


def outputs(d) -> dict:
    """Every file a classify run wrote, by name."""
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())}


def run_both(root, files, job, flags, capsys=None):
    """The JAX and the port CLI on the same files and flags; returns
    (jax outputs, port outputs) and, with ``capsys``, their stdouts."""
    outs, stdout = [], []
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        out = os.path.join(root, f"{name}_{job}")
        assert main(["classify", *files[:-1], out, job, *flags, *extra]) == 0
        outs.append(outputs(out))
        if capsys is not None:
            stdout.append(capsys.readouterr().out)
    return (*outs, *stdout)


def assert_same(jax_out, port_out):
    assert list(port_out) == list(jax_out)
    for name in jax_out:
        assert port_out[name] == jax_out[name], name


# ------------------------------------------------------- host taxonomer
@pytest.mark.parametrize("syncmer", [0, 1])
def test_host_taxonomer_equals_jax(tmp_path, syncmer):
    """--device-tax 0: the match core on the device, the sorted matches
    on the host, the native ``taxonomer_assign``; equal to JAX's host
    path and to the port's default (device taxonomer) path."""
    root, q, db = _golden_db(tmp_path, syncmer)
    flags = ["--seq-mode", "1", "--batch-reads", "8", "--device-tax", "0"]
    jax_out, port_out = run_both(root, [q, db, None], "ht", flags)
    assert_same(jax_out, port_out)
    assert port_out["ht_classifications.tsv"].count(b"\n1\t") >= 15
    dflt = os.path.join(root, "port_default")
    assert port_main(["classify", q, db, dflt, "ht", *flags[:4],
                      "--device", "cpu"]) == 0
    assert outputs(dflt) == port_out


def test_print_log_equals_jax(tmp_path, capsys):
    """--print-log: the Python taxonomer prints each species' match paths;
    stdout and every output file equal JAX's."""
    root, q, db = _golden_db(tmp_path, 0)
    flags = ["--seq-mode", "1", "--batch-reads", "8", "--print-log", "1",
             "--verbosity", "0"]
    capsys.readouterr()
    jax_out, port_out, jax_log, port_log = run_both(
        root, [q, db, None], "pl", flags, capsys)
    assert_same(jax_out, port_out)
    assert port_log == jax_log
    assert port_log.count("Current species: ") >= 18


# ------------------------------------------------------------ long reads
def _taxonomy(d, nodes):
    d.mkdir()
    (d / "nodes.dmp").write_text(
        "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    (d / "names.dmp").write_text("".join(
        f"{t}\t|\tN{t}\t|\t\t|\tscientific name\t|\n" for t, _, _ in nodes))
    (d / "merged.dmp").write_text("")


def _build(tmp_path, genomes, nodes, **kw):
    _taxonomy(tmp_path / "taxonomy", nodes)
    paths = []
    for acc, (seq, _) in genomes.items():
        p = tmp_path / f"{acc}.fna"
        p.write_text(f">{acc}\n{seq.decode()}\n")
        paths.append(str(p))
    (tmp_path / "lib.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "map.tsv").write_text(
        "accession\taccession.version\ttaxid\tgi\n" + "".join(
            f"{a.split('.')[0]}\t{a}\t{t}\t0\n" for a, (_, t) in genomes.items()))
    db = str(tmp_path / "db")
    build_database(db, str(tmp_path / "lib.txt"), str(tmp_path / "map.tsv"),
                   str(tmp_path / "taxonomy"),
                   BuildParams(gene_prediction=0, **kw))
    return db


def fragments_world(tmp_path):
    """tests/test_end_to_end.py's tiny world (two 4 kb genomes from seed
    1234, its 10-node taxonomy) with its 2 kb long-read fragments (seed
    404), plus one 7,000-base contig, genome A then the first 3 kb of B:
    a read past the 2,048 columns (6,144 bases) of the JAX package's
    chain grid."""
    rng = np.random.default_rng(1234)
    genomes = {"ACC_A.1": (bytes(rng.choice(ACGT, 4000)), 4),
               "ACC_B.1": (bytes(rng.choice(ACGT, 4000)), 8)}
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom"), (3, 2, "genus"),
             (4, 3, "species"), (5, 3, "species"), (6, 4, "subspecies"),
             (7, 2, "genus"), (8, 7, "species"), (9, 1, "superkingdom"),
             (10, 9, "species")]
    db = _build(tmp_path, genomes, nodes, batch_bases=100_000)
    rng = np.random.default_rng(404)
    reads = []
    for genome, _ in genomes.values():
        st = int(rng.integers(0, len(genome) - 2000))
        reads.append(genome[st:st + 2000])
    reads.append(genomes["ACC_A.1"][0] + genomes["ACC_B.1"][0][:3000])
    return db, reads


def scattered_world(tmp_path):
    """tests/test_device_taxonomer.py's path-overflow world (two 6 kb
    genomes from seed 61): 600 bp reads with a substitution every 80
    bases, so many short disjoint paths per (read, species)."""
    rng = np.random.default_rng(61)
    genomes = {"OV_A.1": (bytes(rng.choice(ACGT, 6000)), 4),
               "OV_B.1": (bytes(rng.choice(ACGT, 6000)), 8)}
    nodes = [(1, 1, "no rank"), (2, 1, "genus"), (4, 2, "species"),
             (8, 2, "species")]
    db = _build(tmp_path, genomes, nodes, mask_mode=0)
    reads = []
    for g, _ in genomes.values():
        for i in range(6):
            r = bytearray(g[i * 900:i * 900 + 600])
            for p in range(40, 600, 80):
                r[p] = ord("A") if r[p] != ord("A") else ord("T")
            reads.append(bytes(r))
    return db, reads


WORLDS = {"fragments": fragments_world, "scattered": scattered_world}


def _reads_file(tmp_path, reads):
    q = tmp_path / "long.fna"
    q.write_text("".join(f">L{i}\n{r.decode()}\n" for i, r in enumerate(reads)))
    return str(q)


@pytest.mark.parametrize("device_tax", [1, 0])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_long_reads_equal_jax(tmp_path, world, device_tax):
    db, reads = WORLDS[world](tmp_path)
    q = _reads_file(tmp_path, reads)
    flags = ["--seq-mode", "3", "--batch-reads", "4", "--device-tax",
             str(device_tax)]
    jax_out, port_out = run_both(str(tmp_path), [q, db, None], "lr", flags)
    assert_same(jax_out, port_out)
    rows = port_out["lr_classifications.tsv"].decode().splitlines()[1:]
    assert sum(r.startswith("1\t") for r in rows) == len(reads)
    if world == "fragments":  # the contig: 7,000 bases, 6,996 used
        assert rows[-1].split("\t")[3] == "6996"


def test_long_read_batches_cut_by_bases(tmp_path, monkeypatch):
    """--batch-reads 0 cuts a batch by bases too: with a budget of ~5,000
    bases a batch, the long reads go in several batches, and the output
    bytes equal one batch's and JAX's."""
    db, reads = fragments_world(tmp_path)
    q = _reads_file(tmp_path, reads * 2)
    flags = ["--seq-mode", "3"]
    ref = os.path.join(tmp_path, "one")
    assert port_main(["classify", q, db, ref, "lr", *flags, "--batch-reads",
                      "64", "--device", "cpu"]) == 0
    monkeypatch.setattr(port_classifier, "BATCH_BYTES_PER_READ",
                        150 * 300_000)
    sizes = []
    dispatch = port_classifier.Classifier._dispatch
    monkeypatch.setattr(port_classifier.Classifier, "_dispatch",
                        lambda self, metas, rows, **kw: (
                            sizes.append(sum(len(r[0]) for r in rows)),
                            dispatch(self, metas, rows, **kw))[1])
    jax_out, port_out = run_both(str(tmp_path), [q, db, None], "lr",
                                 [*flags, "--batch-reads", "0"])
    assert len(sizes) >= 4 and max(sizes) <= 7000
    assert sizes.count(2000) + sizes.count(7000) >= 2  # cut between reads
    assert outputs(ref) == port_out
    assert_same(jax_out, port_out)
