"""`grade`: accuracy benchmark vs answer sheets.

CAMI-style per-rank precision/sensitivity/F1, following
``compareTaxonAtRank_CAMI`` (`/root/reference/src/util/grade.cpp:42-120`):

  * target mapped to the rank; if the target's node at that rank is *above*
    the rank, the read is not counted ('-');
  * unclassified or root shots are false negatives;
  * shots whose node at the rank is above the rank are false negatives;
  * otherwise TP iff shot-at-rank == target-at-rank.
"""

from __future__ import annotations

from ..db.index import load_db_taxonomy
from ..db.taxonomy import rank_index

DEFAULT_RANKS = ["class", "order", "family", "genus", "species"]


def read_answer_sheet(path: str, read_col: int = 0, taxid_col: int = 1) -> dict[str, int]:
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= max(read_col, taxid_col):
                continue
            try:
                out[cols[read_col]] = int(cols[taxid_col])
            except ValueError:
                continue
    return out


_ACC_RE = None


def _mangle_read_id(read_id: str, test_type: str) -> str:
    """Read-id -> answer-sheet key per --test-type (`grade.cpp:231-248`)."""
    global _ACC_RE
    if test_type in ("gtdb", "over"):
        import re

        if _ACC_RE is None:
            _ACC_RE = re.compile(r"(GC[AF]_[0-9]+\.?[0-9]*)")
        m = _ACC_RE.search(read_id)
        rid = m.group(0) if m else read_id
        if test_type == "gtdb":
            rid = rid.split(".")[0]
        return rid
    if test_type in ("hiv", "hiv-ex"):
        return read_id.split("_")[0]
    if test_type in ("cami", "cami-long", "cami-euk"):
        return read_id.split("/")[0]
    return read_id


def read_classifications(
    path: str, test_type: str = "", skip_secondary: bool = False
) -> dict[str, int]:
    """``skip_secondary`` keeps only the first classified observation per
    read (id before '/'), GTDB paired-read convention (`grade.cpp:252-272`)."""
    out = {}
    observed: dict[str, int] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3 or not cols[2][:1].isdigit():
                continue
            full_id = cols[1]
            taxid = int(cols[2])
            if skip_secondary:
                key = full_id.split("/")[0]
                if key not in observed:
                    observed[key] = 1 if taxid != 0 else 0
                    if taxid == 0:
                        continue
                elif observed[key] == 1:
                    continue
            rid = _mangle_read_id(full_id, test_type) if test_type else full_id
            # mangled ids can collide (paired mates); keep the classified one
            if taxid != 0 or rid not in out:
                out[rid] = taxid
    return out


def grade(
    classifications: str,
    answer_sheet: str,
    db_dir: str,
    ranks: str | list[str] = "",
    readid_col: int = 0,
    taxid_col: int = 1,
    test_type: str = "",
    skip_secondary: bool = False,
) -> dict:
    tax = load_db_taxonomy(db_dir)
    if isinstance(ranks, str):
        ranks = [r for r in ranks.split(",") if r] or DEFAULT_RANKS
    answers = read_answer_sheet(answer_sheet, readid_col, taxid_col)
    shots = read_classifications(classifications, test_type, skip_secondary)

    result = {}
    for rank in ranks:
        tp = fp = fn = total = 0
        r_idx = rank_index(rank)
        for read, target_org in answers.items():
            target = tax.to_internal(target_org)
            if target < 0:
                continue
            target_at = tax.at_rank(target, rank)
            if rank_index(tax.rank_of(target_at)) > r_idx:
                continue  # target above this rank: not counted
            shot_org = shots.get(read, 0)
            shot = tax.to_internal(shot_org) if shot_org > 0 else 0
            if shot <= 1:
                fn += 1
                total += 1
                continue
            shot_at = tax.at_rank(shot, rank)
            if rank_index(tax.rank_of(shot_at)) > r_idx:
                fn += 1
                total += 1
                continue
            total += 1
            if shot_at == target_at:
                tp += 1
            else:
                fp += 1
        precision = tp / (tp + fp) if tp + fp else 0.0
        sensitivity = tp / total if total else 0.0
        f1 = (
            2 * precision * sensitivity / (precision + sensitivity)
            if precision + sensitivity
            else 0.0
        )
        result[rank] = {
            "total": total, "TP": tp, "FP": fp, "FN": fn,
            "precision": precision, "sensitivity": sensitivity, "f1": f1,
        }
    return result
