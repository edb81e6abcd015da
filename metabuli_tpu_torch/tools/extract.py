"""`extract` command: pull reads classified under a clade out of the input.

Mirrors `/root/reference/src/workflow/extract.cpp:45-131` +
`Reporter::getReadsClassifiedToClade` / ``printSpecifiedReads``
(`/root/reference/src/commons/Reporter.cpp:236-365`): scan the
classifications TSV, select rows whose taxid lies under --tax-id (or
unclassified rows for --tax-id -1), and emit those reads to
``<query-base>_<taxid>.fna`` / ``.fq``.
"""

from __future__ import annotations

import os

from ..db.index import load_db_taxonomy
from ..io import fasta


def classified_read_indices(classifications: str, target_internal: int, tax) -> list[int]:
    idxs = []
    with open(classifications) as fh:
        idx = 0
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if target_internal == -1:
                if cols[0] == "0":
                    idxs.append(idx)
            else:
                taxid = tax.to_internal(int(cols[2]))
                if taxid > 0 and tax.is_ancestor(target_internal, taxid):
                    idxs.append(idx)
            idx += 1
    return idxs


def extract_reads(
    query: str,
    classifications: str,
    db_dir: str,
    external_taxid: int,
    extract_mode: int = 1,
    out_dir: str = "",
) -> str:
    tax = load_db_taxonomy(db_dir)
    if external_taxid == -1:
        target = -1
    else:
        target = tax.to_internal(external_taxid)
        if target < 0:
            raise ValueError(f"taxon ID {external_taxid} not in the taxonomy")
    idxs = set(classified_read_indices(classifications, target, tax))

    base = fasta.query_base_name(query)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    out_base = os.path.join(out_dir or os.path.dirname(query) or ".",
                            f"{base}_{external_taxid}")
    selected = [
        rec for i, rec in enumerate(fasta.read_records(query)) if i in idxs
    ]
    is_fq = bool(selected and selected[0].qual is not None)
    if is_fq and extract_mode != 1:
        out = out_base + ".fq"
        fasta.write_fastq(out, selected)
    else:
        out = out_base + ".fna"
        fasta.write_fasta(out, selected)
    return out
