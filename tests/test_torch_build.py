"""The port's ``build`` and ``updateDB`` on the CPU (plain K1) write the
same database files, byte for byte, as the JAX package's on the same
inputs: the golden world (then classified through the port's CLI to the
golden outputs), a gene-predicted world (single-mode Prodigal and the
meta-mode stand-in), the in-memory path with --cds-info and with
--accession-level 1, and both branches of updateDB."""

import contextlib
import hashlib
import io
import json
import os
import pathlib

import numpy as np
import pytest

from metabuli_tpu.db.build import build_database
from metabuli_tpu.db.update import update_database
from metabuli_tpu.params import BuildParams
from metabuli_tpu_torch.cli import main
from metabuli_tpu_torch.tools import world
from test_golden import GOLDEN_DIR, _world

DATE = "2026-01-01"
DB_FILES = ("diffIdx", "info", "split", "taxID_list", "taxonomyDB.npz",
            "acc2taxid.map", "db.parameters")


def port_cli(argv) -> dict:
    """Run the port's CLI; its JSON line (the stats of build/updateDB)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def flags(par: BuildParams) -> list[str]:
    """The CLI flags that give ``par`` (fields that differ from the
    defaults)."""
    out = []
    for k, v in vars(par).items():
        if v != getattr(BuildParams(), k):
            out += ["--" + k.replace("_", "-"), str(v)]
    return out


def assert_same_db(jax_db, port_db):
    for name in DB_FILES:
        a = pathlib.Path(jax_db, name).read_bytes()
        b = pathlib.Path(port_db, name).read_bytes()
        assert a == b, name


def assert_same_stats(jax_stats, port_stats):
    assert {k: port_stats[k] for k in jax_stats} == jax_stats
    assert port_stats["stage_s"]["extract"] > 0


def build_both(tmp, lib, acc, taxdir, par, cli_extra=()):
    jax_db, port_db = os.path.join(tmp, "jax_db"), os.path.join(tmp, "port_db")
    want = build_database(jax_db, lib, acc, taxdir, BuildParams(**vars(par)))
    got = port_cli(["build", port_db, lib, acc, "--taxonomy-path", taxdir,
                    *flags(par), *cli_extra, "--device", "cpu"])
    assert_same_stats(want, got)
    assert_same_db(jax_db, port_db)
    return jax_db, port_db, got


@pytest.mark.parametrize("syncmer", [0, 1])
def test_port_build_gives_golden_db_and_classifications(tmp_path, syncmer):
    root, q = _world(tmp_path)
    par = BuildParams(gene_prediction=0, syncmer=syncmer, mask_mode=1,
                      db_date=DATE)
    _, db, stats = build_both(root, os.path.join(root, "library.txt"),
                              os.path.join(root, "acc2taxid.map"),
                              os.path.join(root, "taxonomy"), par)
    tag = f"s{syncmer}"
    assert (f"total={stats['total_kmers']} unique={stats['unique_kmers']}\n"
            == (GOLDEN_DIR / f"build_stats_{tag}.txt").read_text())
    digest = hashlib.sha256()
    for name in ("diffIdx", "info", "taxID_list"):
        digest.update(pathlib.Path(db, name).read_bytes())
    assert (digest.hexdigest() + "\n"
            == (GOLDEN_DIR / f"db_digest_{tag}.txt").read_text())
    out = os.path.join(root, "out")
    assert main(["classify", q, db, out, "gold", "--seq-mode", "1",
                 "--batch-reads", "8", "--device", "cpu"]) == 0
    for kind in ("classifications", "report"):
        got = pathlib.Path(out, f"gold_{kind}.tsv").read_text()
        assert got == (GOLDEN_DIR / f"{kind}_{tag}.tsv").read_text(), kind


def _skew_library(tmp, n_species, extra=()):
    """The first ``n_species`` of the skew world (100 kb each), plus
    ``extra`` [(genome, species taxid of the world)], as a library."""
    tax, genomes, _ = world.make_world(str(tmp), "skew")
    genomes = genomes[:n_species] + list(extra)
    lib, acc = world.write_library(os.path.join(tmp, "lib"), genomes,
                                   world.genus_of(tax, genomes))
    return tax, genomes, lib, acc, os.path.join(tmp, "skew_taxonomy")


def test_port_gene_predicted_build_equals_jax(tmp_path):
    """Defaults (gene prediction and masking on): four 100 kb species take
    the single-mode Prodigal port, a 60 kb one the meta-mode stand-in."""
    rng = np.random.default_rng(11)
    short = (bytes(rng.choice(world.ACGT, 60_000)), 200)  # species S1_3
    _, _, lib, acc, taxdir = _skew_library(tmp_path, 4, [short])
    _, _, stats = build_both(str(tmp_path), lib, acc, taxdir,
                             BuildParams(db_date=DATE))
    assert stats["sequences"] == 5 and stats["blocks"] > 5
    assert stats["stage_s"]["gene_prediction"] > 0
    assert stats["stage_s"]["masking"] > 0


def test_port_cds_info_build_equals_jax(tmp_path):
    """--cds-info: CDS blocks (one forward, one on the minus strand, one
    joined) and the non-CDS remainders, in the in-memory path."""
    _, genomes, lib, acc, taxdir = _skew_library(tmp_path, 2)
    sp = genomes[0][1]
    cds = tmp_path / "cds.fna"
    # NCBI headers lead with [locus_tag=...] (the parser skips the
    # comment's first characters, as the reference does)
    cds.write_text("".join(
        f">lcl|SKW_{sp}.1_cds_P{i}_{i} [locus_tag=LT{i}] [protein_id=P{i}.1] "
        f"[location={loc}]\nATG\n" for i, loc in enumerate(
            ["301..1500", "complement(2001..3200)",
             "join(5001..5600,5701..6300)"], 1)))
    cds_list = tmp_path / "cds_list.txt"
    cds_list.write_text(f"{cds}\n")
    build_both(str(tmp_path), lib, acc, taxdir,
               BuildParams(gene_prediction=0, cds_info=str(cds_list),
                           db_date=DATE))


def test_port_accession_level_build_equals_jax(tmp_path):
    """--accession-level 1: a taxon per accession, in-memory path."""
    _, _, lib, acc, taxdir = _skew_library(tmp_path, 2)
    build_both(str(tmp_path), lib, acc, taxdir,
               BuildParams(gene_prediction=0, accession_level=1,
                           db_date=DATE))


@pytest.mark.parametrize("branch", ["streaming", "full_load"])
def test_port_update_db_equals_jax(tmp_path, branch):
    """updateDB with a new genus through --new-taxa: the streaming branch
    (a new output directory) and the full-load one (in place)."""
    tax, _, lib, acc, taxdir = _skew_library(tmp_path, 2)
    jax_db, port_db, _ = build_both(
        str(tmp_path), lib, acc, taxdir,
        BuildParams(gene_prediction=0, db_date=DATE))
    new_lib, new_acc, new_taxa, _ = world.new_genus(
        str(tmp_path / "new"), tax, n_species=2, length=20_000)
    par = BuildParams(gene_prediction=0, db_date=DATE)
    if branch == "streaming":
        jax_out = str(tmp_path / "jax_updated")
        port_out = str(tmp_path / "port_updated")
    else:
        jax_out, port_out = jax_db, port_db
    want = update_database(jax_out, jax_db, new_lib, new_acc,
                           BuildParams(**vars(par)), new_taxa=new_taxa)
    got = port_cli(["updateDB", port_out, new_lib, new_acc, "--old-db",
                    port_db, "--new-taxa", new_taxa, *flags(par),
                    "--device", "cpu"])
    assert_same_stats(want, got)
    assert_same_db(jax_out, port_out)


@pytest.mark.parametrize("flag,item", [("--reduced-aa", "item 9"),
                                       ("--kmer-format", "item 14")])
def test_port_build_without_k1_variant_raises(tmp_path, flag, item):
    _, _, lib, acc, taxdir = _skew_library(tmp_path, 1)
    with pytest.raises(NotImplementedError, match=item):
        main(["build", str(tmp_path / "db"), lib, acc, "--taxonomy-path",
              taxdir, flag, "1", "--device", "cpu"])


def test_port_build_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, lib, acc, taxdir = _skew_library(tmp_path, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["build", str(tmp_path / "db"), lib, acc, "--taxonomy-path",
              taxdir])


def test_port_extraction_splits_a_batch_on_device_oom(monkeypatch):
    """A batch that runs out of device memory is split in halves and
    retried (on the same device) until it fits; the metamers equal an
    unsplit run's."""
    import torch

    from metabuli_tpu_torch.db.build import IndexBuilder, SeqTask
    from metabuli_tpu_torch.params import BuildParams as PortParams

    rng = np.random.default_rng(8)
    tasks = [SeqTask(bytes(rng.choice(world.ACGT, 500)), i, i)
             for i in range(8)]
    want = IndexBuilder(PortParams(), None, device="cpu")
    want.add_sequences(tasks)
    once = IndexBuilder._extract_batch_once
    sizes = []

    def small_batches_only(self, batch):
        sizes.append(len(batch))
        if len(batch) > 2:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return once(self, batch)

    monkeypatch.setattr(IndexBuilder, "_extract_batch_once",
                        small_batches_only)
    got = IndexBuilder(PortParams(), None, device="cpu")
    got.add_sequences(tasks)
    assert sizes == [8, 4, 2, 2, 4, 2, 2]
    for a, b in ((got._values, want._values), (got._taxids, want._taxids)):
        assert np.array_equal(np.concatenate(a), np.concatenate(b))
