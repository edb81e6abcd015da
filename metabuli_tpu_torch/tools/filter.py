"""`filter` command: remove reads matching contaminant databases.

Mirrors `Metabuli src/commons/QueryFilter.cpp:118-206`: classify the
input against each database named in --contam-list (comma-separated
subdirectories of the DB dir); reads that classify to any contaminant are
"removed", the rest are "filtered" (kept). Outputs ``<base>_filtered.fna``
(and ``_removed.fna`` with --print-mode 2), always FASTA.

Round-1 note: the reference pools matches from all contam DBs before the
taxonomy stage; we classify per-DB and OR the classified flags (equivalent
unless scores across DBs interact; tracked in PARITY.md).
"""

from __future__ import annotations

import os

from ..io import fasta
from ..params import ClassifyParams


def filter_reads(
    q1: str,
    q2: str | None,
    db_dir: str,
    out_dir: str,
    job_id: str,
    contam_list: str,
    par: ClassifyParams,
    print_mode: int = 1,
    device="cuda",
) -> dict:
    from ..classify.classifier import Classifier

    contams = [c for c in contam_list.split(",") if c]
    os.makedirs(out_dir, exist_ok=True)
    removed: set[int] = set()
    for contam in contams:
        # a contam entry may name a sub-DB under db_dir, or be a DB path
        # (absolute or cwd-relative) in its own right
        sub_db = os.path.join(db_dir, contam) if not os.path.isabs(contam) else contam
        if not os.path.isdir(sub_db) and os.path.isdir(contam):
            sub_db = contam
        clf = Classifier(sub_db, par, device=device)
        tmp_dir = os.path.join(out_dir, f".filter_{contam.replace('/', '_')}")
        clf.classify_file(q1, q2, tmp_dir, job_id)
        cls_path = os.path.join(tmp_dir, f"{job_id}_classifications.tsv")
        with open(cls_path) as fh:
            idx = 0
            for line in fh:
                if line.startswith("#"):
                    continue
                if line.split("\t", 1)[0] == "1":
                    removed.add(idx)
                idx += 1

    def _emit(path: str):
        base = fasta.query_base_name(path)
        kept_path = os.path.join(out_dir, f"{base}_filtered.fna")
        removed_path = os.path.join(out_dir, f"{base}_removed.fna")
        kept = rm = 0
        with open(kept_path, "w") as kfh, open(removed_path, "w") as rfh:
            for i, rec in enumerate(fasta.read_records(path)):
                header = rec.name if not rec.comment else f"{rec.name} {rec.comment}"
                line = f">{header}\n{rec.seq.decode()}\n"
                if i in removed:
                    rm += 1
                    if print_mode == 2:
                        rfh.write(line)
                else:
                    kept += 1
                    kfh.write(line)
        if print_mode != 2:
            os.unlink(removed_path)
        return kept, rm

    kept1, rm1 = _emit(q1)
    result = {"kept": kept1, "removed": rm1}
    if q2:
        _emit(q2)
    return result
