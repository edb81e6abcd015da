"""Small expert utilities: editNames, createnewtaxalist, printDeltaIdx,
gradeByCladeSize, query2reference.

Each mirrors the same-named reference command (`/root/reference/src/util/`).
"""

from __future__ import annotations

import os

import numpy as np

from ..db.formats import delta_decode
from ..db.index import load_db_taxonomy
from .grade import read_answer_sheet, read_classifications


def edit_names(names_dmp: str, taxid_map: str) -> int:
    """Fix taxonkit-generated names.dmp for GTDB: replace bare assembly
    *numbers* with the full assembly accession
    (`/root/reference/src/util/editNames.cpp`). Rewrites in place."""
    number2assacc: dict[str, str] = {}
    with open(taxid_map) as fh:
        for line in fh:
            assacc, _, _ = line.rstrip("\n").partition("\t")
            if "_" in assacc:
                number = assacc.split("_", 1)[1].split(".")[0]
                number2assacc[number] = assacc
    out_lines = []
    changed = 0
    with open(names_dmp) as fh:
        for line in fh:
            parts = line.split("\t")
            if len(parts) >= 3:
                name = parts[2]
                key = name.split(".")[0]
                if key in number2assacc:
                    parts[2] = number2assacc[key]
                    changed += 1
            out_lines.append("\t".join(parts))
    with open(names_dmp, "w") as fh:
        fh.writelines(out_lines)
    return changed


def create_new_taxa_list(old_db_dir: str, fasta_list: str,
                         new_taxonomy_dir: str, acc2taxid_path: str,
                         out_dir: str) -> dict:
    """`createnewtaxalist` (`/root/reference/src/util/createnewtaxalist.cpp`):
    graft the lineages of new accessions (under a NEW taxonomy dump) onto
    an existing DB's taxonomy.

    For every accession observed in the FASTA list, walk up its new-taxonomy
    lineage until a node whose NAME already exists in the old taxonomy (the
    graft point); nodes below it are emitted as --new-taxa rows. New-taxonomy
    taxids that collide with taxids already used by the old DB are
    reallocated to the smallest unused external id — re-allocated on every
    visit, last assignment winning, exactly like the reference loop
    (`createnewtaxalist.cpp:300-346`). Outputs newtaxa.tsv,
    newtaxa.accession2taxid and unmapped_accessions.txt (all sorted for
    reproducibility, matching the reference's std::map / SORT_PARALLEL)."""
    from ..db.taxonomy import Taxonomy
    from ..io import fasta

    os.makedirs(out_dir, exist_ok=True)
    old = load_db_taxonomy(old_db_dir)
    new = Taxonomy.from_dmp(
        os.path.join(new_taxonomy_dir, "names.dmp"),
        os.path.join(new_taxonomy_dir, "nodes.dmp"),
        os.path.join(new_taxonomy_dir, "merged.dmp"),
    )
    # merged.dmp of the NEW taxonomy (getMergedNodeMap): old -> new alias
    merged: dict[int, int] = {}
    mpath = os.path.join(new_taxonomy_dir, "merged.dmp")
    if os.path.exists(mpath):
        with open(mpath) as fh:
            for line in fh:
                cols = [c.strip() for c in line.split("|")]
                if len(cols) >= 2 and cols[0] and cols[1]:
                    merged[int(cols[0])] = int(cols[1])

    # observed accessions (version-stripped first header token), mapped
    # through acc2taxid (columns 1 and 3, header skipped)
    observed: dict[str, int] = {}
    with open(fasta_list) as fh:
        files = [line.strip() for line in fh if line.strip()]
    for path in files:
        for rec in fasta.read_records(path):
            observed[rec.name.split()[0].split(".")[0]] = 0
    with open(acc2taxid_path) as fh:
        first = True
        for line in fh:
            if first:
                first = False
                continue
            toks = line.split()
            if len(toks) < 3:
                continue
            acc = toks[0].split(".")[0]
            if acc in observed:
                try:
                    tid = int(toks[2])
                except ValueError:
                    continue
                observed[acc] = merged.get(tid, tid)

    used_external = set(
        int(t) for t in old.internal2org[: old.n_nodes() + 1]
    )
    # name -> external taxid of the OLD taxonomy (getName2taxid; later
    # nodes overwrite earlier ones on duplicate names, like the map insert)
    old_name2ext: dict[str, int] = {}
    for i in range(old.n_nodes() + 1):
        old_name2ext[old.name_of(i)] = int(old.internal2org[i])

    new_taxa_map: dict[int, tuple[int, str, str]] = {}  # taxid -> (parent, rank, name)
    changed: dict[int, int] = {}

    def smallest_unused() -> int:
        r = 1
        while r in used_external:
            r += 1
        used_external.add(r)
        return r

    unmapped: list[str] = []
    for acc in sorted(observed):  # std::map iteration order
        ext = observed[acc]
        if ext == 0:
            unmapped.append(acc)
            continue
        node = new.to_internal(ext)
        count = 0
        while True:
            node_ext = int(new.internal2org[node]) if node > 0 else ext
            name = new.name_of(node) if node > 0 else ""
            if name in old_name2ext:
                changed[node_ext] = old_name2ext[name]
                break
            if node_ext == 1:
                break
            if count > 100:
                raise ValueError(
                    f"{acc} (taxid {ext}) has a lineage of more than 100 "
                    f"nodes; the taxonomy or taxid is likely invalid"
                )
            if node_ext not in new_taxa_map:
                parent_ext = int(new.internal2org[new.parent[node]])
                new_taxa_map[node_ext] = (
                    parent_ext, new.rank_of(node), name)
            if node_ext in used_external:
                # reference reallocates on EVERY visit (not guarded by the
                # map check); last assignment wins
                changed[node_ext] = smallest_unused()
            node = int(new.parent[node])
            count += 1

    rows = []
    for taxid in sorted(new_taxa_map):  # std::map order
        parent, rank, name = new_taxa_map[taxid]
        rows.append((changed.get(taxid, taxid),
                     changed.get(parent, parent), rank, name))
    rows.sort(key=lambda r: r[0])
    with open(os.path.join(out_dir, "newtaxa.tsv"), "w") as fh:
        for t, p, r, n in rows:
            fh.write(f"{t}\t{p}\t{r}\t{n}\n")
    with open(os.path.join(out_dir, "newtaxa.accession2taxid"), "w") as fh:
        fh.write("accession\taccession.version\ttaxid\tgi\n")
        for acc in sorted(observed):
            tid = observed[acc]
            tid = changed.get(tid, tid)
            if tid == 0:
                continue
            fh.write(f"{acc}\t{acc}\t{tid}\t0\n")
    with open(os.path.join(out_dir, "unmapped_accessions.txt"), "w") as fh:
        for acc in sorted(unmapped):
            fh.write(acc + "\n")
    return {"new_taxa": len(rows), "accessions": len(observed),
            "unmapped": len(unmapped)}


def print_delta_idx(
    diff_idx_path: str, n: int = 20, begin: int = 0, end: int = 0
) -> list[int]:
    """--kmer-begin/--kmer-end select a value range (`printDeltaIdx` flags)."""
    stream = np.fromfile(diff_idx_path, dtype=np.uint16)
    values = delta_decode(stream)
    if begin or end:
        return [int(v) for v in values[begin : end or len(values)]]
    return [int(v) for v in values[:n]]


def query2reference(classifications: str, acc2taxid_path: str, out_path: str) -> int:
    """Map classified reads back to reference accessions sharing their taxid
    (`/root/reference/src/util/query2reference.cpp` capability)."""
    from ..db.build import read_acc2taxid

    acc2taxid = read_acc2taxid(acc2taxid_path)
    taxid2accs: dict[int, list[str]] = {}
    for acc, taxid in acc2taxid.items():
        taxid2accs.setdefault(taxid, []).append(acc)
    n = 0
    with open(classifications) as fh, open(out_path, "w") as out:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3 or cols[0] != "1":
                continue
            accs = taxid2accs.get(int(cols[2]), [])
            out.write(f"{cols[1]}\t{cols[2]}\t{','.join(sorted(set(accs))[:5])}\n")
            n += 1
    return n


def grade_by_clade_size(
    classifications: str,
    answer_sheet: str,
    db_dir: str,
    rank: str = "species",
    bins=(1, 2, 5, 10, 100),
    clade_rank: str = "",
) -> dict:
    """Accuracy stratified by how many answer-sheet reads each true clade
    has (`/root/reference/src/util/gradeByCladeSize.cpp` capability).
    ``clade_rank`` (--clade-rank) sets the rank whose clade sizes bucket
    the reads; defaults to the test rank."""
    from ..db.taxonomy import rank_index

    tax = load_db_taxonomy(db_dir)
    answers = read_answer_sheet(answer_sheet)
    shots = read_classifications(classifications)

    bucket_rank = clade_rank or rank
    clade_sizes: dict[int, int] = {}
    target_at: dict[str, int] = {}
    bucket_of: dict[str, int] = {}
    for read, target_org in answers.items():
        t = tax.to_internal(target_org)
        if t < 0:
            continue
        at = tax.at_rank(t, rank)
        target_at[read] = at
        b = at if bucket_rank == rank else tax.at_rank(t, bucket_rank)
        bucket_of[read] = b
        clade_sizes[b] = clade_sizes.get(b, 0) + 1

    r_idx = rank_index(rank)
    result = {}
    edges = list(bins) + [float("inf")]
    for lo, hi in zip(edges[:-1], edges[1:]):
        tp = fp = fn = total = 0
        for read, at in target_at.items():
            size = clade_sizes.get(bucket_of.get(read, at), 0)
            if not (lo <= size < hi):
                continue
            if rank_index(tax.rank_of(at)) > r_idx:
                continue
            shot_org = shots.get(read, 0)
            shot = tax.to_internal(shot_org) if shot_org > 0 else 0
            if shot <= 1:
                fn += 1
                total += 1
                continue
            shot_at = tax.at_rank(shot, rank)
            total += 1
            if shot_at == at:
                tp += 1
            else:
                fp += 1
        label = f"[{lo},{'inf' if hi == float('inf') else hi})"
        precision = tp / (tp + fp) if tp + fp else 0.0
        sensitivity = tp / total if total else 0.0
        result[label] = {
            "total": total, "TP": tp, "FP": fp, "FN": fn,
            "precision": precision, "sensitivity": sensitivity,
        }
    return result


def make_aa_offset(diff_idx_path: str) -> dict:
    """`makeAAoffset` (`/root/reference/src/util/makeAAoffset.cpp`):
    decompose a diffIdx stream into per-amino-acid-group files:
    <f>.aa (u64 AA parts), <f>.kmers (u64 values), <f>.deltaCnt,
    <f>.kmerCnt (u32 per-group counts)."""
    stream = np.fromfile(diff_idx_path, dtype=np.uint16)
    values = delta_decode(stream)
    aa = values >> np.uint64(24)
    new_group = np.ones(len(values), bool)
    if len(values):
        new_group[1:] = aa[1:] != aa[:-1]
    starts = np.nonzero(new_group)[0]
    counts = np.diff(np.append(starts, len(values))).astype(np.uint32)
    aa[starts].astype(np.uint64).tofile(diff_idx_path + ".aa")
    values.astype(np.uint64).tofile(diff_idx_path + ".kmers")
    counts.tofile(diff_idx_path + ".kmerCnt")
    # delta chunk count per group
    flags = (stream & 0x8000) != 0
    ends = np.nonzero(flags)[0]
    chunk_counts = np.diff(np.concatenate([[-1], ends])).astype(np.uint32)
    group_chunks = np.add.reduceat(chunk_counts, starts) if len(starts) else np.zeros(0, np.uint32)
    group_chunks.astype(np.uint32).tofile(diff_idx_path + ".deltaCnt")
    return {"kmers": len(values), "aa_groups": len(starts)}


def filter_by_genus(classifications: str, genus_list_path: str, db_dir: str,
                    out_path: str = "") -> str:
    """`filter_by_genus`: keep classification rows whose genus is listed."""
    tax = load_db_taxonomy(db_dir)
    with open(genus_list_path) as fh:
        wanted = {int(x) for x in fh.read().split() if x.strip()}
    out_path = out_path or classifications + ".genus_filtered"
    with open(classifications) as fh, open(out_path, "w") as out:
        for line in fh:
            if line.startswith("#"):
                out.write(line)
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 3 or cols[0] != "1":
                continue
            t = tax.to_internal(int(cols[2]))
            if t > 0 and tax.to_original(int(tax.genus_of[t])) in wanted:
                out.write(line)
    return out_path


ICTV_RANKS = [
    "realm", "subrealm", "kingdom", "subkingdom", "phylum", "subphylum",
    "class", "subclass", "order", "suborder", "family", "subfamily",
    "genus", "subgenus", "species",
]


def ictv_format(classifications: str, db_dir: str, out_path: str = "") -> str:
    """`ictv-format`: ICTV-challenge CSV — per-read lineage names + scores
    at each ICTV rank (`/root/reference/src/util/ictv-challenge-format.cpp`)."""
    tax = load_db_taxonomy(db_dir)
    out_path = out_path or classifications + ".ictv.csv"
    with open(classifications) as fh, open(out_path, "w") as out:
        header = ["SequenceID"]
        for r in ICTV_RANKS:
            header += [r.capitalize(), f"{r.capitalize()}_score"]
        out.write(",".join(header) + "\n")
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 5:
                continue
            row = [cols[1]]
            if cols[0] != "1":
                row += [""] * (2 * len(ICTV_RANKS))
                out.write(",".join(row) + "\n")
                continue
            t = tax.to_internal(int(cols[2]))
            score = cols[4]
            # collect lineage rank -> name
            lineage = {}
            node = t
            for _ in range(64):
                if node <= 0:
                    break
                lineage[tax.rank_of(node)] = tax.name_of(node)
                p = int(tax.parent[node])
                if p == node:
                    break
                node = p
            for r in ICTV_RANKS:
                name = lineage.get(r, "")
                row += [name, score if name else ""]
            out.write(",".join(row) + "\n")
    return out_path
