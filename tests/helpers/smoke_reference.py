"""Reference digests of chip_smoke.py's dbbuild, longread and reduced
phases, from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py \
        [dbbuild] [longread] [reduced] [format1] [grouping] [uniref] [--port]

(dbbuild and longread when none is named). dbbuild: builds the skew world of ``metabuli_tpu_torch.tools.world`` (seed 0, 384
species of 100 kb, one FASTA file per genus) with ``metabuli_tpu``'s
``build_database`` at the defaults (gene prediction and masking on),
adds the 16-genome genus of ``world.new_genus`` with ``update_database``
and ``--new-taxa``, and classifies the smoke run's 65,536 reads against
the updated DB, 8,192 a batch. Prints one JSON line: the sha256 of
diffIdx + info + taxID_list of both DBs, the digest of the blocks each
handed to extraction (in the port's ``IndexBuilder`` order and layout),
the classified count and the sha256 of the classifications file. These
are the constants of ``chip_smoke.py``. longread: the uniform world of
``world.make_world`` (seed 0, 8 x 200 kb), the genome-derived rows of
chip_smoke.py's long-read DB (``world.build_db`` with 1,024 of its
never-matching decoys in place of the card's 60 M, so the last row is a
decoy there too) and its 8,192 reads of 3,000 bases (max_mut 30),
classified with ``--seq-mode 3``, 1,024 a batch: the classified count and
the classifications' sha256. reduced: dbbuild's library built with
``--reduced-aa 1`` at the defaults, and dbbuild's 65,536 reads classified
against it, 8,192 a batch: the DB and gene-block digests, the classified
count and the classifications' sha256. format1: dbbuild's library built
with ``--kmer-format 1`` at the defaults and dbbuild's reads classified
against it, as reduced. grouping: dbbuild's run, then ``grouping`` of its
reads with its classifications of them and ``--dbdir`` its updated DB,
once plain and once with ``--common-kmer-db`` (``create-common-kmer-list``
of its first DB) and ``--neighbor-kmers 12``: each ``read_groups.tsv``'s
sha256, groups and rescued reads. uniref: ``world.uniref_inputs``,
``create-uniref-db`` of its XML (the sha256 of diffIdx and info, and
``world.uniref_tree_sha256`` of unirefTree), ``assign_uniref`` of its DNA
reads and of its protein fragments (auto-detected): each
``uniref_classifications.tsv``'s sha256. ``--port`` runs the same steps
through ``metabuli_tpu_torch`` on the CPU as well and prints its line.
"""

import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

DB_DATE = "2026-01-01"


def db_sha256(db: str) -> str:
    h = hashlib.sha256()
    for name in ("diffIdx", "info", "taxID_list"):
        with open(os.path.join(db, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def file_sha256(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")


def jax_run(tmp, lib, acc, taxdir, new, fq, phase="dbbuild") -> dict:
    """dbbuild's build, updateDB and classify through the JAX package; for
    the reduced and format1 phases, their build and classify."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from metabuli_tpu.classify.classifier import Classifier
    from metabuli_tpu.db import build
    from metabuli_tpu.db.update import update_database
    from metabuli_tpu.params import BuildParams, ClassifyParams

    blocks = {}
    add = build.IndexBuilder.add_sequences

    def hashed_add(self, tasks):
        # the port's IndexBuilder.blocks_sha256, from the same tasks
        h = blocks.setdefault(id(self), [0, hashlib.sha256()])
        h[0] += len(tasks)
        for t in tasks:
            h[1].update(np.array([t.taxid, t.species, t.single_frame,
                                  len(t.seq)], np.int64).tobytes() + t.seq)
        return add(self, tasks)

    build.IndexBuilder.add_sequences = hashed_add
    out = {}
    t0 = time.perf_counter()
    variant = phase != "dbbuild"
    db = os.path.join(tmp, f"jax_{phase}_db" if variant else "jax_db")
    st = build.build_database(db, lib, acc, taxdir, BuildParams(
        db_date=DB_DATE, reduced_aa=int(phase == "reduced"),
        kmer_format=1 if phase == "format1" else 2))
    (n, h), = blocks.values()
    out["build"] = {"total_kmers": st["total_kmers"],
                    "unique_kmers": st["unique_kmers"], "blocks": n,
                    "blocks_sha256": h.hexdigest(), "db_sha256": db_sha256(db),
                    "s": time.perf_counter() - t0}
    blocks.clear()
    if variant:
        t0 = time.perf_counter()
        clf = Classifier(db, ClassifyParams(seq_mode=1, batch_reads=8192))
        s = clf.classify_file(fq, None, os.path.join(tmp, f"jax_{phase}_out"),
                              phase)
        out["classify"] = {"classified": s["classified"], "sha256": (
            file_sha256(os.path.join(tmp, f"jax_{phase}_out",
                                     f"{phase}_classifications.tsv"))),
            "s": time.perf_counter() - t0}
        return out
    t0 = time.perf_counter()
    db2 = os.path.join(tmp, "jax_db_updated")
    st = update_database(db2, db, new[0], new[1],
                         BuildParams(db_date=DB_DATE), new_taxa=new[2])
    (n, h), = blocks.values()
    out["update"] = {"total_kmers": st["total_kmers"],
                     "unique_kmers": st["unique_kmers"], "blocks": n,
                     "blocks_sha256": h.hexdigest(),
                     "db_sha256": db_sha256(db2),
                     "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    clf = Classifier(db2, ClassifyParams(seq_mode=1, batch_reads=8192))
    s = clf.classify_file(fq, None, os.path.join(tmp, "jax_out"), "smoke")
    out["classify"] = {
        "classified": s["classified"],
        "sha256": file_sha256(os.path.join(tmp, "jax_out",
                                           "smoke_classifications.tsv")),
        "s": time.perf_counter() - t0}
    return out


def cli_json(package: str, argv) -> dict:
    """One command through ``metabuli_tpu`` or ``metabuli_tpu_torch``'s
    CLI; its last printed line as JSON."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(f"{package}.cli").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def port_run(tmp, lib, acc, taxdir, new, fq, phase="dbbuild") -> dict:
    cli = lambda argv: cli_json("metabuli_tpu_torch", argv)
    out = {}
    variant = phase != "dbbuild"
    db = os.path.join(tmp, f"port_{phase}_db" if variant else "port_db")
    db2 = os.path.join(tmp, "port_db_updated")
    st = cli(["build", db, lib, acc, "--taxonomy-path", taxdir,
              "--db-date", DB_DATE,
              "--reduced-aa", str(int(phase == "reduced")),
              "--kmer-format", "1" if phase == "format1" else "2",
              "--device", "cpu"])
    out["build"] = {k: st[k] for k in ("total_kmers", "unique_kmers",
                                       "blocks", "blocks_sha256")}
    out["build"]["db_sha256"] = db_sha256(db)
    if variant:
        s = cli(["classify", fq, db, os.path.join(tmp, f"port_{phase}_out"),
                 phase, "--seq-mode", "1", "--batch-reads", "8192",
                 "--device", "cpu"])
        out["classify"] = {"classified": s["classified"],
                           "sha256": file_sha256(os.path.join(
                               tmp, f"port_{phase}_out",
                               f"{phase}_classifications.tsv"))}
        return out
    st = cli(["updateDB", db2, new[0], new[1], "--old-db", db,
              "--new-taxa", new[2], "--db-date", DB_DATE, "--device", "cpu"])
    out["update"] = {k: st[k] for k in ("total_kmers", "unique_kmers",
                                        "blocks", "blocks_sha256")}
    out["update"]["db_sha256"] = db_sha256(db2)
    s = cli(["classify", fq, db2, os.path.join(tmp, "port_out"), "smoke",
             "--seq-mode", "1", "--batch-reads", "8192", "--device", "cpu"])
    out["classify"] = {"classified": s["classified"], "sha256": file_sha256(
        os.path.join(tmp, "port_out", "smoke_classifications.tsv"))}
    return out


LONGREAD = dict(reads=8192, read_len=3000, max_mut=30, batch=1024)


def longread_inputs(tmp):
    """(DB dir, FASTQ) of the longread phase, the DB on the CPU."""
    import torch

    from metabuli_tpu_torch.tools import world

    tax, genomes, rng = world.make_world(tmp, "uniform")
    cpu = torch.device("cpu")
    n = world.build_db(os.path.join(tmp, "lr_genome_db"), tax, genomes,
                       cpu)["genome_rows"]
    db = os.path.join(tmp, "lr_db")
    world.build_db(db, tax, genomes, cpu, rows=n + 1024, never_match=True)
    reads = world.sample_reads(genomes, rng, LONGREAD["reads"],
                               LONGREAD["read_len"], LONGREAD["max_mut"])
    fq = os.path.join(tmp, "long.fq")
    write_fastq(fq, reads)
    return db, fq


def longread_run(tmp, db, fq, port: bool) -> dict:
    t0 = time.perf_counter()
    out = os.path.join(tmp, "port_lr" if port else "jax_lr")
    if port:
        import contextlib
        import io

        from metabuli_tpu_torch.cli import main as cli

        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert cli(["classify", fq, db, out, "long", "--seq-mode", "3",
                        "--batch-reads", str(LONGREAD["batch"]),
                        "--device", "cpu"]) == 0
        s = json.loads(buf.getvalue().strip().splitlines()[-1])
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from metabuli_tpu.classify.classifier import Classifier
        from metabuli_tpu.params import ClassifyParams

        s = Classifier(db, ClassifyParams(
            seq_mode=3, batch_reads=LONGREAD["batch"])).classify_file(
                fq, None, out, "long")
    return {"classified": s["classified"],
            "sha256": file_sha256(os.path.join(out,
                                               "long_classifications.tsv")),
            "s": time.perf_counter() - t0}


def grouping_run(tmp, fq, package: str) -> dict:
    """The grouping phase through one package's CLI, on dbbuild's JAX
    outputs (its DBs and classifications, byte-equal to the port's)."""
    side = "port" if package.endswith("torch") else "jax"
    dev = ["--device", "cpu"] if side == "port" else []
    cls = os.path.join(tmp, "jax_out", "smoke_classifications.tsv")
    common = os.path.join(tmp, f"{side}_common")
    cli_json(package, ["create-common-kmer-list", os.path.join(tmp, "jax_db"),
                       common])
    out = {}
    for name, extra in (("plain", []), ("common", [
            "--common-kmer-db", common, "--neighbor-kmers", "12"])):
        t0 = time.perf_counter()
        d = os.path.join(tmp, f"{side}_grouping_{name}")
        s = cli_json(package, ["grouping", fq, cls, d, "--dbdir",
                               os.path.join(tmp, "jax_db_updated"),
                               *extra, *dev])
        out[name] = {"groups": s["groups"], "rescued": s["rescued"],
                     "sha256": file_sha256(os.path.join(d,
                                                        "read_groups.tsv")),
                     "s": time.perf_counter() - t0}
    return out


def uniref_run(tmp, package: str) -> dict:
    """The uniref phase through one package's CLI."""
    from metabuli_tpu_torch.tools import world

    side = "port" if package.endswith("torch") else "jax"
    dev = ["--device", "cpu"] if side == "port" else []
    xml, dna, prot, _ = world.uniref_inputs(os.path.join(tmp, "uniref_in"))
    db = os.path.join(tmp, f"{side}_uniref_db")
    t0 = time.perf_counter()
    s = cli_json(package, ["create-uniref-db", xml, db, *dev])
    out = {"db": {**s, "diffidx_sha256": file_sha256(
                      os.path.join(db, "diffIdx")),
                  "info_sha256": file_sha256(os.path.join(db, "info")),
                  "tree_sha256": world.uniref_tree_sha256(
                      os.path.join(db, "unirefTree")),
                  "s": time.perf_counter() - t0}}
    for name, q in (("dna", dna), ("protein", prot)):
        t0 = time.perf_counter()
        d = os.path.join(tmp, f"{side}_uniref_{name}")
        s = cli_json(package, ["assign_uniref", q, db, d, *dev])
        out[name] = {"queries": s["queries"], "classified": s["classified"],
                     "sha256": file_sha256(os.path.join(
                         d, "uniref_classifications.tsv")),
                     "s": time.perf_counter() - t0}
    return out


def main() -> int:
    from metabuli_tpu_torch.tools import world

    args = sys.argv[1:]
    phases = [a for a in args if not a.startswith("-")] or ["dbbuild",
                                                            "longread"]
    port = "--port" in args
    if "longread" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            db, fq = longread_inputs(tmp)
            print(json.dumps({"jax": {"longread": longread_run(
                tmp, db, fq, False)}}), flush=True)
            if port:
                print(json.dumps({"port": {"longread": longread_run(
                    tmp, db, fq, True)}}), flush=True)
    if "uniref" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps({"jax": {"uniref": uniref_run(
                tmp, "metabuli_tpu")}}), flush=True)
            if port:
                print(json.dumps({"port": {"uniref": uniref_run(
                    tmp, "metabuli_tpu_torch")}}), flush=True)
    if not {"dbbuild", "reduced", "format1", "grouping"} & set(phases):
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        tax, genomes, rng = world.make_world(tmp, "skew")
        lib, acc = world.write_library(os.path.join(tmp, "lib"), genomes,
                                       world.genus_of(tax, genomes))
        new = world.new_genus(os.path.join(tmp, "new"), tax)
        reads = world.sample_reads(genomes, rng, 65_536, 150, max_mut=2)
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, reads)
        taxdir = os.path.join(tmp, "skew_taxonomy")
        if "grouping" in phases and "dbbuild" not in phases:
            phases.append("dbbuild")  # grouping reads its outputs
        for phase in ("dbbuild", "reduced", "format1"):
            if phase not in phases:
                continue
            print(json.dumps({"jax": {phase: jax_run(
                tmp, lib, acc, taxdir, new, fq, phase)}}), flush=True)
            if port:
                print(json.dumps({"port": {phase: port_run(
                    tmp, lib, acc, taxdir, new, fq, phase)}}), flush=True)
        if "grouping" in phases:
            print(json.dumps({"jax": {"grouping": grouping_run(
                tmp, fq, "metabuli_tpu")}}), flush=True)
            if port:
                print(json.dumps({"port": {"grouping": grouping_run(
                    tmp, fq, "metabuli_tpu_torch")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
