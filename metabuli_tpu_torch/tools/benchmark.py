"""Benchmark query-set generation.

Capability port of the reference's benchmark tooling
(`/root/reference/src/benchmark/makeBenchmarkSet.cpp`,
`makeInclusionQuerySet.cpp`, `makeVirusBenchmarkSet.cpp`): sample reads from
assemblies with known taxids to produce a query FASTA/FASTQ plus an answer
sheet for `grade`. Supports single/paired reads, substitution errors, and
inclusion/exclusion splits (exclusion assemblies are listed for removal
from the DB build).
"""

from __future__ import annotations

import os

import numpy as np

from ..db.build import read_acc2taxid
from ..io import fasta

_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _mutate(read: bytearray, rng, error_rate: float):
    if error_rate <= 0:
        return read
    n_err = rng.binomial(len(read), error_rate)
    for _ in range(n_err):
        p = int(rng.integers(0, len(read)))
        read[p] = b"ACGT"[int(rng.integers(0, 4))]
    return read


def make_test_set(
    assembly_list: str,
    acc2taxid_path: str,
    out_prefix: str,
    reads_per_assembly: int = 100,
    read_len: int = 150,
    error_rate: float = 0.0,
    paired: bool = False,
    insert_len: int = 400,
    exclusion_fraction: float = 0.0,
    seed: int = 42,
    restrict_taxids: list[int] | None = None,
    taxonomy_dir: str = "",
) -> dict:
    """Write <prefix>.fna (or _1/_2.fna when paired), <prefix>_answers.tsv
    and, with exclusion_fraction > 0, <prefix>_excluded_assemblies.txt.

    ``restrict_taxids`` keeps only assemblies whose taxon sits under one of
    the given (external) taxids — the reference's --virus-taxid /
    --bacteria-taxid / --archaea-taxid domain selectors
    (`makeVirusBenchmarkSet.cpp`, `makeBenchmarkSet.cpp`); needs
    ``taxonomy_dir`` (names/nodes/merged.dmp) for the ancestry test."""
    rng = np.random.default_rng(seed)
    acc2taxid = read_acc2taxid(acc2taxid_path)
    with open(assembly_list) as fh:
        files = [line.strip() for line in fh if line.strip()]

    if restrict_taxids:
        from ..db.taxonomy import Taxonomy

        tax = Taxonomy.from_dmp(
            os.path.join(taxonomy_dir, "names.dmp"),
            os.path.join(taxonomy_dir, "nodes.dmp"),
            os.path.join(taxonomy_dir, "merged.dmp"),
        )
        anchors = [tax.to_internal(t) for t in restrict_taxids]

        def _under(path: str) -> bool:
            for rec in fasta.read_records(path):
                org = acc2taxid.get(rec.name.split()[0])
                if org:
                    t = tax.to_internal(org)
                    return t > 0 and any(
                        a > 0 and tax.is_ancestor(a, t) for a in anchors
                    )
            return False

        files = [f for f in files if _under(f)]

    n_excl = int(len(files) * exclusion_fraction)
    perm = rng.permutation(len(files))
    excluded = {files[i] for i in perm[:n_excl]}

    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    answers = open(out_prefix + "_answers.tsv", "w")
    if paired:
        out1 = open(out_prefix + "_1.fna", "w")
        out2 = open(out_prefix + "_2.fna", "w")
    else:
        out1 = open(out_prefix + ".fna", "w")
        out2 = None

    n_reads = 0
    skipped = 0
    for path in files:
        for rec in fasta.read_records(path):
            acc = rec.name.split()[0]
            taxid = acc2taxid.get(acc) or acc2taxid.get(acc.split(".")[0])
            if not taxid:
                skipped += 1
                continue
            seq = rec.seq
            need = insert_len if paired else read_len
            if len(seq) < need:
                continue
            for _ in range(reads_per_assembly):
                start = int(rng.integers(0, len(seq) - need + 1))
                name = f"q{n_reads}_{acc}"
                if paired:
                    frag = seq[start : start + insert_len]
                    r1 = _mutate(bytearray(frag[:read_len]), rng, error_rate)
                    mate = frag[-read_len:]
                    r2 = _mutate(
                        bytearray(mate.translate(_RC)[::-1]), rng, error_rate
                    )
                    out1.write(f">{name}\n{bytes(r1).decode()}\n")
                    out2.write(f">{name}\n{bytes(r2).decode()}\n")
                else:
                    read = bytearray(seq[start : start + read_len])
                    if rng.integers(0, 2):
                        read = bytearray(bytes(read).translate(_RC)[::-1])
                    read = _mutate(read, rng, error_rate)
                    out1.write(f">{name}\n{bytes(read).decode()}\n")
                answers.write(f"{name}\t{taxid}\n")
                n_reads += 1
            break  # one record per assembly file (representative sequence)
    out1.close()
    if out2:
        out2.close()
    answers.close()
    if n_excl:
        with open(out_prefix + "_excluded_assemblies.txt", "w") as fh:
            fh.write("\n".join(sorted(excluded)) + "\n")
    return {
        "reads": n_reads,
        "assemblies": len(files),
        "excluded_assemblies": n_excl,
        "skipped_records": skipped,
    }
