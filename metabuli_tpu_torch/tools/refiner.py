"""`classifiedRefiner`: filter/reshape a classifications TSV.

Mirrors `/root/reference/src/util/classifiedRefiner.cpp`: score threshold,
remove-unclassified, include/exclude taxid subtrees, column selection,
re-rank rows to a fixed rank, and optional regenerated report.
"""

from __future__ import annotations

import os

from ..db.index import load_db_taxonomy
from ..db.taxonomy import rank_index
from ..io.report import Reporter


def refine(
    classified_file: str,
    db_dir: str,
    out_file: str = "",
    min_score: float = 0.0,
    remove_unclassified: bool = False,
    select_taxids: str = "",
    exclude_taxids: str = "",
    select_columns: str = "",
    rank: str = "",
    report: bool = False,
    rank_file_type: int = 0,
) -> str:
    """``rank_file_type`` mirrors --rank-file-type (`classifiedRefiner.cpp:177`,
    higherRankFile): what to do with reads classified *above* --rank —
    0: exclude, 1: keep in the main output, 2: write to a separate
    ``*_higherRanks.tsv`` file."""
    tax = load_db_taxonomy(db_dir)
    targets = [tax.to_internal(int(t)) for t in select_taxids.split(",") if t]
    contams = [tax.to_internal(int(t)) for t in exclude_taxids.split(",") if t]
    columns = [int(c) for c in select_columns.split(",") if c]
    out_file = out_file or (
        os.path.splitext(classified_file)[0] + "_refined.tsv"
    )
    higher_path = os.path.splitext(out_file)[0] + "_higherRanks.tsv"
    higher_fh = open(higher_path, "w") if rank_file_type == 2 else None

    tax_counts: dict[int, int] = {}
    total = 0
    with open(classified_file) as fh, open(out_file, "w") as out:
        for line in fh:
            if line.startswith("#"):
                out.write(line)
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 5:
                continue
            total += 1
            is_classified = cols[0] == "1"
            taxid = tax.to_internal(int(cols[2])) if int(cols[2]) else 0
            score = float(cols[4])
            if remove_unclassified and not is_classified:
                continue
            if is_classified and score < min_score:
                continue
            if targets and not any(
                t > 0 and taxid > 0 and tax.is_ancestor(t, taxid) for t in targets
            ):
                continue
            if contams and any(
                t > 0 and taxid > 0 and tax.is_ancestor(t, taxid) for t in contams
            ):
                continue
            if rank and taxid > 0:
                at = tax.at_rank(taxid, rank)
                if rank_index(tax.rank_of(at)) > rank_index(rank):
                    # classified above the requested rank
                    if rank_file_type == 2 and higher_fh is not None:
                        higher_fh.write("\t".join(cols) + "\n")
                    if rank_file_type != 1:
                        continue
                else:
                    taxid = at
                    cols[2] = str(tax.to_original(taxid))
                    cols[5] = tax.rank_of(taxid)
            if columns:
                cols = [cols[c] for c in columns if c < len(cols)]
            out.write("\t".join(cols) + "\n")
            tax_counts[taxid if is_classified else 0] = (
                tax_counts.get(taxid if is_classified else 0, 0) + 1
            )
    if higher_fh is not None:
        higher_fh.close()

    if report:
        rep_path = os.path.splitext(out_file)[0] + "_report.tsv"
        with open(rep_path, "w") as fh:
            Reporter(tax).write_report(fh, tax_counts, total)
    return out_file
