"""Reference digests of chip_smoke.py's build phase, from the JAX package
on the CPU.

    JAX_PLATFORMS=cpu python tests/helpers/smoke_reference.py [--port]

Builds the skew world of ``metabuli_tpu_torch.tools.world`` (seed 0, 384
species of 100 kb, one FASTA file per genus) with ``metabuli_tpu``'s
``build_database`` at the defaults (gene prediction and masking on),
adds the 16-genome genus of ``world.new_genus`` with ``update_database``
and ``--new-taxa``, and classifies the smoke run's 65,536 reads against
the updated DB, 8,192 a batch. Prints one JSON line: the sha256 of
diffIdx + info + taxID_list of both DBs, the digest of the blocks each
handed to extraction (in the port's ``IndexBuilder`` order and layout),
the classified count and the sha256 of the classifications file. These
are the constants of ``chip_smoke.py``. ``--port`` runs the same steps
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


def jax_run(tmp, lib, acc, taxdir, new, fq) -> dict:
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
    db = os.path.join(tmp, "jax_db")
    st = build.build_database(db, lib, acc, taxdir,
                              BuildParams(db_date=DB_DATE))
    (n, h), = blocks.values()
    out["build"] = {"total_kmers": st["total_kmers"],
                    "unique_kmers": st["unique_kmers"], "blocks": n,
                    "blocks_sha256": h.hexdigest(), "db_sha256": db_sha256(db),
                    "s": time.perf_counter() - t0}
    blocks.clear()
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


def port_run(tmp, lib, acc, taxdir, new, fq) -> dict:
    import contextlib
    import io

    from metabuli_tpu_torch.cli import main

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    out = {}
    db = os.path.join(tmp, "port_db")
    db2 = os.path.join(tmp, "port_db_updated")
    st = cli(["build", db, lib, acc, "--taxonomy-path", taxdir,
              "--db-date", DB_DATE, "--device", "cpu"])
    out["build"] = {k: st[k] for k in ("total_kmers", "unique_kmers",
                                       "blocks", "blocks_sha256")}
    out["build"]["db_sha256"] = db_sha256(db)
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


def main() -> int:
    from metabuli_tpu_torch.tools import world

    with tempfile.TemporaryDirectory() as tmp:
        tax, genomes, rng = world.skew_world(tmp)
        lib, acc = world.write_library(os.path.join(tmp, "lib"), genomes,
                                       world.genus_of(tax, genomes))
        new = world.new_genus(os.path.join(tmp, "new"), tax)
        reads = world.sample_reads(genomes, rng, 65_536, 150, max_mut=2)
        fq = os.path.join(tmp, "reads.fq")
        write_fastq(fq, reads)
        taxdir = os.path.join(tmp, "skew_taxonomy")
        print(json.dumps({"jax": jax_run(tmp, lib, acc, taxdir, new, fq)}),
              flush=True)
        if "--port" in sys.argv[1:]:
            print(json.dumps({"port": port_run(tmp, lib, acc, taxdir, new,
                                               fq)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
