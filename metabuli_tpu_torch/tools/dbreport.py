"""`database-report`: per-taxon k-mer content summary of a database.

Analogue of `/root/reference/src/util/databaseReport.cpp`: counts info-file
entries per taxon, aggregates to species/genus, and writes a TSV.
"""

from __future__ import annotations

import numpy as np

from ..db.index import MetamerIndex


def database_report(db_dir: str, out_path: str) -> None:
    index = MetamerIndex.load(db_dir)
    tax = index.taxonomy
    taxids = index.taxids.astype(np.int64)
    counts = np.bincount(taxids, minlength=tax.n_nodes() + 1)
    species = tax.species_of
    sp_counts: dict[int, int] = {}
    for t in np.nonzero(counts)[0]:
        sp = int(species[t]) if t < len(species) else 0
        sp_counts[sp] = sp_counts.get(sp, 0) + int(counts[t])
    with open(out_path, "w") as fh:
        fh.write("#taxID\trank\tname\tkmer_count\tspecies_kmer_count\n")
        for t in np.nonzero(counts)[0]:
            t = int(t)
            if t == 0:
                continue
            sp = int(species[t]) if t < len(species) else 0
            fh.write(
                f"{tax.to_original(t)}\t{tax.rank_of(t)}\t{tax.name_of(t)}\t"
                f"{int(counts[t])}\t{sp_counts.get(sp, 0)}\n"
            )
