"""Port parity for the UniRef modules (``uniref/classifier.py``, kernel
K12's plain versions on the CPU): ``create-uniref-db`` and
``assign_uniref`` through both CLIs, against the JAX package. Tolerance
is zero: the DB files (the tree by its arrays: its .npz holds zip
timestamps), the classifications and stdout are equal."""

import contextlib
import io
import os

import numpy as np
import pytest

from metabuli_tpu.cli import main as jax_main
from metabuli_tpu_torch.cli import main as port_main
from metabuli_tpu_torch.tools import world
from metabuli_tpu_torch.uniref import classifier as tuniref

SPEC = dict(entries=96, length=120, u90=24, u50=6, sub90=0.05, sub50=0.3)
SIDES = (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"]))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def uniref_dbs(tmp_path_factory):
    """A small UniRef XML dump built into a DB by each CLI, and a query
    file of
    protein fragments, back-translated DNA reads (both strands, 2 % base
    errors) and odd records: empty, shorter than a k-mer, lowercase,
    N runs, ambiguous residues, random."""
    root = tmp_path_factory.mktemp("uniref")
    xml, seqs = world.uniref_world(str(root), spec=SPEC)
    rng = np.random.default_rng(4)
    dna = world.uniref_queries(seqs, rng, 60, 150, dna=True)
    prot = world.uniref_queries(seqs, rng, 40, 60, dna=False)
    odd = [b"", b"MKV", b"ACGT", seqs[0][:40].lower(), dna[0][:70] + b"N" * 5
           + dna[1][:80], b"BZX" + seqs[1][:50] + b"*", dna[2][:31],
           dna[3][:38]]
    mixed = [r for pair in zip(dna, prot) for r in pair] + odd + dna[40:]
    q = root / "mixed.fasta"
    q.write_text("".join(f">q{i} c\n{s.decode()}\n"
                         for i, s in enumerate(mixed)))
    printed, dbs = {}, {}
    for side, main, extra in SIDES:
        dbs[side] = str(root / f"{side}_db")
        printed[side] = _run(main, ["create-uniref-db", xml, dbs[side],
                                    *extra])
    return {"root": root, "xml": xml, "q": str(q), "dbs": dbs,
            "printed": printed}


def test_create_uniref_db_equals_jax(uniref_dbs):
    dbs = uniref_dbs["dbs"]
    assert uniref_dbs["printed"]["port"] == uniref_dbs["printed"]["jax"]
    for name in ("diffIdx", "info"):
        with open(os.path.join(dbs["jax"], name), "rb") as a, \
                open(os.path.join(dbs["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    assert (world.uniref_tree_sha256(os.path.join(dbs["port"], "unirefTree"))
            == world.uniref_tree_sha256(os.path.join(dbs["jax"],
                                                     "unirefTree")))
    # flushes of a few sequences each give the same DB as one flush
    small = str(uniref_dbs["root"] / "small_flush")
    tuniref.create_uniref_db(uniref_dbs["xml"], small, batch_aa=500,
                             device="cpu")
    for name in ("diffIdx", "info"):
        with open(os.path.join(small, name), "rb") as a, \
                open(os.path.join(dbs["jax"], name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("protein", ["-1", "1", "0"])
def test_assign_uniref_equals_jax(uniref_dbs, protein, monkeypatch):
    """Every record of the mixed file as auto-detected, as protein and as
    DNA, in batches of 16 records (a batch mixes both kinds)."""
    monkeypatch.setattr(tuniref, "QUERY_BATCH", 16)
    root = uniref_dbs["root"]
    printed, rows = {}, {}
    for side, main, extra in SIDES:
        out = root / f"{side}_assign_{protein}"
        printed[side] = _run(main, [
            "assign_uniref", uniref_dbs["q"], uniref_dbs["dbs"][side],
            str(out), "--protein", protein, *extra]).replace(str(out), "")
        rows[side] = (out / "uniref_classifications.tsv").read_bytes()
    assert printed["port"] == printed["jax"]
    assert rows["port"] == rows["jax"]
    lines = rows["port"].decode().splitlines()[1:]
    named = sum(not ln.split("\t")[2] == "unclassified" for ln in lines)
    assert len(lines) == 108 and named > 30


def test_uniref_commands_need_cuda_unless_cpu_is_asked(uniref_dbs,
                                                       monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = uniref_dbs["root"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["create-uniref-db", uniref_dbs["xml"],
                   str(root / "no_card_db")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["assign_uniref", uniref_dbs["q"],
                   uniref_dbs["dbs"]["port"], str(root / "no_card")])
