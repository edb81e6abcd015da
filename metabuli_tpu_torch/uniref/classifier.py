"""UniRef protein-cluster database and classifier.

The port's counterpart of ``metabuli_tpu.uniref.classifier`` (the
reference's Metabuli `src/uniref/` UnirefDbCreator and
UnirefClassifier, the create-uniref-db and assign_uniref workflows):

  * DB: AA 12-mers (5-bit packed) of UniRef100 representative sequences,
    sorted; duplicate k-mers collapse to the UniRef-tree LCA of their
    clusters (FilterMode::UNIREF_LCA, `IndexCreator.h:541-581`).
  * Classification (`UnirefClassifier.cpp` assignUniref): exact AA-level
    k-mer matches are counted per cluster; each cluster's score is the sum
    of counts of clusters that are its ancestors-or-self in the UniRef
    tree; best score wins, ties resolve to the tree LCA.

The k-mers come from kernel K12 on the card (``ops.encode``): one launch
per flush of ``batch_aa`` residues for the DB, as in the reference package;
for queries one launch per batch of records of each kind (protein, DNA),
where the reference package launches once per record. A record's k-mers
do not depend on the batch's padded length, so each record's line is the
one it gets alone; lines are written in input order. The rest is host
code.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..csrc import build
from ..db.formats import delta_decode, delta_encode
from ..io import fasta
from ..ops.encode import (AA_K, encode_aa_seqs_padded, extract_aa_kmers,
                          extract_aa_kmers_dna)
from ..ops.genetic_code import encode_seqs_padded
from .tree import UnirefTree, build_tree, iter_uniref_entries

# query records per K12 launch of each kind
QUERY_BATCH = 8192


def _valid_values(fn, codes, lens, dev):
    """K12 (``fn``) over padded rows on ``dev``: per row, its valid k-mer
    values as uint64 (row-major order of the [B, ..., W] output)."""
    v, _, ok = fn(torch.from_numpy(codes).to(dev),
                  torch.from_numpy(lens).to(dev), k=AA_K)
    B = codes.shape[0]
    ok = ok.reshape(B, -1)
    n = ok.sum(1).cpu().numpy()
    vals = v.reshape(B, -1)[ok].cpu().numpy().view(np.uint64)
    return np.split(vals, np.cumsum(n)[:-1]) if B else []


def create_uniref_db(xml_path: str, db_dir: str, batch_aa: int = 2_000_000,
                     device="cuda") -> dict:
    """Build tree + AA 12-mer index from a UniRef100 XML dump."""
    dev = build.device(device)
    os.makedirs(db_dir, exist_ok=True)
    tree = build_tree(xml_path)
    tree.save(os.path.join(db_dir, "unirefTree"))

    all_values = []
    all_ids = []
    batch_seqs: list[bytes] = []
    batch_ids: list[int] = []
    batch_bases = 0

    def flush():
        nonlocal batch_seqs, batch_ids, batch_bases
        if not batch_seqs:
            return
        max_len = max(len(s) for s in batch_seqs)
        bucket = 512
        while bucket < max_len:
            bucket *= 2
        codes, lens = encode_aa_seqs_padded(batch_seqs, bucket)
        per_row = _valid_values(extract_aa_kmers, codes, lens, dev)
        all_values.append(np.concatenate(per_row))
        all_ids.append(np.repeat(np.array(batch_ids, np.uint32),
                                 [len(r) for r in per_row]))
        batch_seqs, batch_ids, batch_bases = [], [], 0

    for u100, _, _, seq in iter_uniref_entries(xml_path):
        if not seq or u100 not in tree.name2id:
            continue
        batch_seqs.append(seq)
        batch_ids.append(tree.name2id[u100])
        batch_bases += len(seq)
        if batch_bases >= batch_aa:
            flush()
    flush()

    values = np.concatenate(all_values) if all_values else np.zeros(0, np.uint64)
    ids = np.concatenate(all_ids) if all_ids else np.zeros(0, np.uint32)
    order = np.lexsort((ids, values))
    values, ids = values[order], ids[order]
    # dedup by value; id := UniRef-tree LCA of members (UNIREF_LCA mode)
    if len(values):
        new_group = np.ones(len(values), bool)
        new_group[1:] = values[1:] != values[:-1]
        starts = np.nonzero(new_group)[0]
        ends = np.append(starts[1:], len(values))
        out_ids = np.empty(len(starts), np.uint32)
        for g, (a, b) in enumerate(zip(starts, ends)):
            if b - a == 1:
                out_ids[g] = ids[a]
            else:
                out_ids[g] = tree.lca(ids[a:b])
        values = values[starts]
        ids = out_ids
    delta_encode(values).tofile(os.path.join(db_dir, "diffIdx"))
    ids.astype(np.uint32).tofile(os.path.join(db_dir, "info"))
    return {"clusters": len(tree.names) - 1, "kmers": len(values)}


def is_protein(seq: bytes) -> bool:
    """The auto-detect of assign_uniref: any letter besides ACGTN."""
    return bool(set(seq.upper()) - set(b"ACGTNacgtn"))


class UnirefClassifier:
    def __init__(self, db_dir: str, device="cuda"):
        self.device = build.device(device)
        self.tree = UnirefTree.load(os.path.join(db_dir, "unirefTree"))
        stream = np.fromfile(os.path.join(db_dir, "diffIdx"), np.uint16)
        self.values = delta_decode(stream)
        self.ids = np.fromfile(os.path.join(db_dir, "info"), np.uint32)

    def _match_counts(self, q_values: np.ndarray) -> dict[int, int]:
        lo = np.searchsorted(self.values, q_values, side="left")
        hi = np.searchsorted(self.values, q_values, side="right")
        counts: dict[int, int] = {}
        for a, b in zip(lo, hi):
            for j in range(a, b):
                cid = int(self.ids[j])
                counts[cid] = counts.get(cid, 0) + 1
        return counts

    def _assign(self, counts: dict[int, int]) -> tuple[int, int]:
        """assignUniref scoring (`UnirefClassifier.cpp` assignUniref)."""
        best = 0
        best_count = 0
        for cid in counts:
            total = 0
            for other, cnt in counts.items():
                if self.tree.is_ancestor(other, cid):
                    total += cnt
            if total > best_count:
                best_count = total
                best = cid
            elif total == best_count and best:
                best = self.tree.lca2(best, cid)
        return best, best_count

    def _query_values(self, seqs: list[bytes], protein: list[bool]):
        """Each record's valid k-mer values: K12 once for the batch's
        protein records, once for its DNA records, each padded to its
        kind's longest record."""
        out: list = [None] * len(seqs)
        for kind, fn, encode in ((True, extract_aa_kmers,
                                  encode_aa_seqs_padded),
                                 (False, extract_aa_kmers_dna,
                                  encode_seqs_padded)):
            idx = [i for i, p in enumerate(protein) if p == kind]
            if not idx:
                continue
            codes, lens = encode([seqs[i] for i in idx])
            for i, v in zip(idx, _valid_values(fn, codes, lens,
                                               self.device)):
                out[i] = v
        return out

    def classify_file(self, query_path: str, out_dir: str,
                      protein: bool | None = None) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, "uniref_classifications.tsv")
        n = classified = 0
        with open(out_path, "w") as out:
            out.write("#name\tlength\tuniref\tkmer_matches\tkmer_count\n")
            recs = fasta.read_records(query_path)
            while True:
                batch = [r for _, r in zip(range(QUERY_BATCH), recs)]
                if not batch:
                    break
                seqs = [r.seq for r in batch]
                kinds = [is_protein(s) if protein is None else protein
                         for s in seqs]
                for rec, v in zip(batch, self._query_values(seqs, kinds)):
                    q = np.sort(v)
                    counts = self._match_counts(q)
                    best, score = self._assign(counts)
                    name = self.tree.names[best] if best else "unclassified"
                    out.write(f"{rec.name}\t{len(rec.seq)}\t{name}\t{score}"
                              f"\t{len(q)}\n")
                    n += 1
                    classified += best != 0
        return {"queries": n, "classified": classified, "out": out_path}
