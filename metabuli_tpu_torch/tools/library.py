"""Library management: `add-to-library` and report regeneration.

add-to-library (`/root/reference/src/workflow/add_to_library.cpp`): split
input FASTAs into per-species files under ``<dbdir>/library/`` using an
accession2taxid mapping; unmapped accessions are reported and skipped.

make-report: regenerate a Kraken2-style report from a classifications TSV
(`/root/reference/src/MetabuliBase.cpp` make-report command).
"""

from __future__ import annotations

import os

from ..db.build import read_acc2taxid
from ..db.index import load_db_taxonomy
from ..io import fasta
from ..io.report import Reporter


def add_to_library(
    file_list: str,
    mapping_file: str,
    db_dir: str,
    library_path: str = "",
) -> dict:
    library_path = library_path or os.path.join(db_dir, "library")
    os.makedirs(library_path, exist_ok=True)
    tax = load_db_taxonomy(db_dir)
    acc2taxid = read_acc2taxid(mapping_file)

    with open(file_list) as fh:
        files = [line.strip() for line in fh if line.strip()]

    unmapped = []
    added = 0
    handles: dict[int, object] = {}
    try:
        for path in files:
            for rec in fasta.read_records(path):
                acc = rec.name.split(".")[0]
                org = acc2taxid.get(rec.name.split()[0]) or acc2taxid.get(acc)
                if not org:
                    unmapped.append(rec.name)
                    continue
                internal = tax.to_internal(org)
                if internal < 0:
                    unmapped.append(rec.name)
                    continue
                species = int(tax.species_of[internal])
                sp_org = tax.to_original(species) if species else org
                if sp_org not in handles:
                    handles[sp_org] = open(
                        os.path.join(library_path, f"{sp_org}.fna"), "a"
                    )
                header = rec.name if not rec.comment else f"{rec.name} {rec.comment}"
                handles[sp_org].write(f">{header}\n{rec.seq.decode()}\n")
                added += 1
    finally:
        for h in handles.values():
            h.close()
    if unmapped:
        with open(os.path.join(library_path, "unmapped.txt"), "w") as fh:
            fh.write("\n".join(unmapped) + "\n")
    return {"added": added, "unmapped": len(unmapped), "species_files": len(handles)}


def make_report(classifications: str, db_dir: str, out_path: str = "") -> str:
    tax = load_db_taxonomy(db_dir)
    out_path = out_path or os.path.splitext(classifications)[0] + "_report.tsv"
    tax_counts: dict[int, int] = {}
    total = 0
    with open(classifications) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3:
                continue
            total += 1
            taxid = tax.to_internal(int(cols[2])) if cols[0] == "1" else 0
            taxid = max(taxid, 0)
            tax_counts[taxid] = tax_counts.get(taxid, 0) + 1
    with open(out_path, "w") as fh:
        Reporter(tax).write_report(fh, tax_counts, total)
    return out_path
