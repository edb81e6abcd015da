"""Read grouping: overlap graph from shared metamers + label propagation.

The port's counterpart of ``metabuli_tpu.readgroup.group`` (the
reference's `grouping` workflow, Metabuli `src/read-group/
GroupGenerator.{h,cpp}`): reads sharing enough metamers join one group;
classification labels then propagate from classified members to
unclassified members of each group.

Metamer extraction is kernel K1 (``ops.encode.extract_metamers``) on the
card; suppression, pair counting, the groups and the propagation run on
the host. Pair counting is vectorised: each k-mer group of 2 to
``max_kmer_degree`` reads gives all its (i < j) read pairs at once, and the
groups are the connected components of the pairs that share enough
k-mers, each labelled with its least read id. ``DisjointSet.union`` always
makes the smaller root the parent, so that is the label the union-find
gives too, whatever the order of the unions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..csrc import build
from ..io import fasta
from ..ops import encode
from ..ops.genetic_code import encode_seqs_padded


class DisjointSet:
    """Union-find with path halving (`GroupGenerator.h:73-109`)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return int(x)

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)

    def labels(self) -> np.ndarray:
        return np.array([self.find(i) for i in range(len(self.parent))])


def suppress_common_kmers(
    kmers: np.ndarray,
    rids: np.ndarray,
    poss: np.ndarray,
    common_values: np.ndarray,
    neighbor_kmers: int,
) -> np.ndarray:
    """Keep-mask replicating ``GroupGenerator::filterCommonKmers2``
    (Metabuli `src/read-group/GroupGenerator.cpp:349-534`,
    oracle-gated by tests/test_readgroup.py): query k-mers whose VALUE
    occurs in the common-k-mer DB become matches at their (read, pos),
    and every query k-mer of the same read within ``neighbor_kmers``
    bases of a match position is dropped (including the match itself).
    The reference's merge walk over (id, pos)-sorted streams is exactly
    an interval union, so the vectorized form checks each k-mer's nearest
    match position."""
    if len(common_values) == 0 or len(kmers) == 0:
        return np.ones(len(kmers), bool)
    cv = np.asarray(common_values, np.uint64)
    idx = np.searchsorted(cv, kmers)
    matched = (idx < len(cv)) & (cv[np.minimum(idx, len(cv) - 1)] == kmers)
    if not matched.any():
        return np.ones(len(kmers), bool)
    BIG = np.int64(1) << 32
    mkey = np.sort(rids[matched] * BIG + poss[matched])
    lo = rids * BIG + (poss - neighbor_kmers)
    hi = rids * BIG + (poss + neighbor_kmers)
    # any match key in [lo, hi] (same read by construction: the window is
    # far smaller than the read-id stride)
    has = np.searchsorted(mkey, hi, "right") > np.searchsorted(mkey, lo,
                                                               "left")
    return ~has


def _pairs(rids: np.ndarray, starts: np.ndarray, sizes: np.ndarray,
           n_reads: int) -> np.ndarray:
    """Every (i < j) read pair of each k-mer group (``rids`` sorted by
    k-mer, then read id), as ``x * n_reads + y``: one block of pairs per
    group size."""
    keys = []
    for s in np.unique(sizes):
        a, b = np.triu_indices(int(s), 1)
        st = starts[sizes == s][:, None]
        keys.append((rids[st + a] * n_reads + rids[st + b]).reshape(-1))
    return np.concatenate(keys) if keys else np.zeros(0, np.int64)


def component_labels(n: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Each of ``n`` nodes' least connected node id over the edges
    (``x``, ``y``): the roots ``DisjointSet`` gives. Each round hooks the
    larger label of every edge whose ends differ onto the smaller, then
    jumps every node to its root."""
    lab = np.arange(n, dtype=np.int64)
    while len(x):
        lx, ly = lab[x], lab[y]
        differ = lx != ly
        if not differ.any():
            break
        np.minimum.at(lab, np.maximum(lx, ly)[differ],
                      np.minimum(lx, ly)[differ])
        while True:
            up = lab[lab]
            if np.array_equal(up, lab):
                break
            lab = up
    return lab


def build_read_groups(
    reads: list[bytes],
    min_shared_kmers: int = 2,
    max_kmer_degree: int = 64,
    batch: int = 2048,
    neighbor_kmers: int = 0,
    common_values: np.ndarray | None = None,
    device="cuda",
) -> np.ndarray:
    """Group labels per read: reads sharing >= min_shared_kmers metamers
    join one group (edge weights count distinct shared k-mer values per
    read PAIR, all pairs per k-mer, `GroupGenerator.cpp:585-594`).

    ``common_values``/``neighbor_kmers`` run the reference's common-k-mer
    suppression (`GroupGenerator.cpp:349-534`) before pair counting: query
    k-mers within the window of a common-DB match are dropped. K-mers
    hitting more than ``max_kmer_degree`` reads are treated as repeats and
    skipped (the reference package's guard against the pair blow-up).
    Metamers come from K1 on ``device``."""
    dev = build.device(device)
    pairs_k: list[np.ndarray] = []
    pairs_r: list[np.ndarray] = []
    pairs_p: list[np.ndarray] = []
    for i in range(0, len(reads), batch):
        chunk = reads[i : i + batch]
        max_len = max((len(r) for r in chunk), default=0)
        bucket = 64
        while bucket < max_len:
            bucket *= 2
        codes, lens = encode_seqs_padded(chunk, bucket)
        mm = encode.extract_metamers(torch.from_numpy(codes).to(dev),
                                     torch.from_numpy(lens).to(dev))
        b, f, w = torch.nonzero(mm.valid, as_tuple=True)
        # int64 bit patterns come back as uint64
        pairs_k.append(mm.value[b, f, w].cpu().numpy().view(np.uint64))
        pairs_p.append(mm.pos[b, f, w].cpu().numpy().astype(np.int64))
        pairs_r.append(b.cpu().numpy() + i)
    if not pairs_k:
        return np.zeros(0, np.int64)
    kmers = np.concatenate(pairs_k)
    rids = np.concatenate(pairs_r)
    poss = np.concatenate(pairs_p)
    if common_values is not None:
        keep = suppress_common_kmers(kmers, rids, poss, common_values,
                                   neighbor_kmers)
        kmers, rids, poss = kmers[keep], rids[keep], poss[keep]
    # dedup (kmer, read) then sort by kmer — matches the reference's
    # per-value sort+unique of query ids (`GroupGenerator.cpp:585-587`)
    order = np.lexsort((rids, kmers))
    kmers, rids = kmers[order], rids[order]
    uniq = np.ones(len(kmers), bool)
    uniq[1:] = (kmers[1:] != kmers[:-1]) | (rids[1:] != rids[:-1])
    kmers, rids = kmers[uniq], rids[uniq]

    # edge weight per read pair = number of distinct shared k-mer values,
    # ALL pairs (i < j in read-id order) per k-mer group
    # (`GroupGenerator.cpp:588-594`)
    new_group = np.ones(len(kmers), bool)
    new_group[1:] = kmers[1:] != kmers[:-1]
    starts = np.nonzero(new_group)[0]
    sizes = np.diff(np.append(starts, len(kmers)))
    take = (sizes >= 2) & (sizes <= max_kmer_degree)
    n = len(reads)
    keys, counts = np.unique(_pairs(rids, starts[take], sizes[take], n),
                             return_counts=True)
    edges = keys[counts >= min_shared_kmers]
    return component_labels(n, edges // n, edges % n)


def weighted_majority_lca(
    votes: list[tuple[int, float]], taxonomy, majority_thr: float = 0.5
) -> int:
    """Weighted-majority LCA over (internal taxid, weight) votes: weights
    accumulate along each vote's ancestor chain; the deepest node whose
    accumulated weight reaches ``majority_thr`` of the total wins
    (NcbiTaxonomy::weightedMajorityLCA semantics, used by
    `GroupGenerator.cpp:1012`)."""
    if not votes:
        return 0
    acc: dict[int, float] = {}
    depth_of: dict[int, int] = {}
    total = 0.0
    for tax, w in votes:
        total += w
        node, d = int(tax), 0
        chain = []
        while node > 0:
            chain.append(node)
            parent = int(taxonomy.parent[node])
            if parent == node:
                break
            node = parent
        for i, n in enumerate(chain):
            acc[n] = acc.get(n, 0.0) + w
            depth_of.setdefault(n, len(chain) - i)
    # strictly greater: an even split falls through to the common ancestor
    need = majority_thr * total
    best, best_key = 0, (-1, -1.0)
    for n, w in acc.items():
        if w > need:
            key = (depth_of[n], w)
            if key > best_key:
                best_key, best = key, n
    return best


def propagate_labels(
    group_labels: np.ndarray,
    classifications: list[int],
    scores: list[float] | None = None,
    weight_mode: int = 0,
    min_vote_score: float = 0.0,
    taxonomy=None,
    majority_thr: float = 0.5,
) -> list[int]:
    """Assign each unclassified read its group's representative label.

    weight_mode (`GroupGenerator.cpp:995-1010`): 0 = uniform votes,
    1 = score-weighted, 2 = score²-weighted; modes 1/2 drop votes whose
    score is below ``min_vote_score``. With a taxonomy the representative
    is the weighted-majority LCA; without one, a plain weighted argmax."""
    votes: dict[int, list[tuple[int, float]]] = {}
    for rid, g in enumerate(group_labels):
        t = classifications[rid]
        if t <= 0:
            continue
        if weight_mode == 0:
            w = 1.0
        else:
            s = scores[rid] if scores else 0.0
            if s < min_vote_score:
                continue
            w = s if weight_mode == 1 else s * s
        votes.setdefault(int(g), []).append((t, w))
    rep: dict[int, int] = {}
    for g, vs in votes.items():
        if taxonomy is not None:
            rep[g] = weighted_majority_lca(vs, taxonomy, majority_thr)
        else:
            agg: dict[int, float] = {}
            for t, w in vs:
                agg[t] = agg.get(t, 0.0) + w
            rep[g] = max(agg.items(), key=lambda kv: kv[1])[0]
    out = list(classifications)
    for rid, g in enumerate(group_labels):
        if out[rid] == 0:
            out[rid] = rep.get(int(g), 0)
    return out


def group_reads_file(
    query_path: str,
    classifications_path: str,
    out_dir: str,
    min_shared_kmers: int = 2,
    weight_mode: int = 0,
    min_vote_score: float = 0.0,
    score_col: int = 5,
    taxonomy=None,
    majority_thr: float = 0.5,
    neighbor_kmers: int = 0,
    common_kmer_db: str = "",
    device="cuda",
) -> dict:
    """`grouping` workflow: read groups + propagated classifications.
    ``min_shared_kmers`` is the reference's --min-edge (edge weight =
    shared-k-mer count); ``score_col`` is 1-based like --score-col;
    ``common_kmer_db`` is the reference's common-k-mer DB positional
    (diffIdx/info dir) enabling the pre-grouping suppression filter.
    K1 runs on ``device``."""
    os.makedirs(out_dir, exist_ok=True)
    reads = []
    names = []
    for rec in fasta.read_records(query_path):
        reads.append(rec.seq)
        names.append(rec.name)
    common_values = None
    if common_kmer_db:
        from ..db.formats import read_db_values

        common_values, _ = read_db_values(common_kmer_db)
    labels = build_read_groups(reads, min_shared_kmers,
                               neighbor_kmers=neighbor_kmers,
                               common_values=common_values, device=device)

    cls = [0] * len(reads)
    scores = [0.0] * len(reads)
    rows = []
    with open(classifications_path) as fh:
        idx = 0
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if idx < len(cls) and len(cols) >= 3:
                cls[idx] = int(cols[2]) if cols[0] == "1" else 0
                if len(cols) >= score_col:
                    try:
                        scores[idx] = float(cols[score_col - 1])
                    except ValueError:
                        pass
                rows.append(cols)
            idx += 1
    if taxonomy is not None:
        internal = [taxonomy.to_internal(t) if t > 0 else 0 for t in cls]
        prop_int = propagate_labels(
            labels, internal, scores, weight_mode, min_vote_score,
            taxonomy, majority_thr)
        propagated = [
            taxonomy.to_original(t) if t > 0 else 0 for t in prop_int
        ]
    else:
        propagated = propagate_labels(
            labels, cls, scores, weight_mode, min_vote_score)

    groups_path = os.path.join(out_dir, "read_groups.tsv")
    with open(groups_path, "w") as fh:
        fh.write("#read\tgroup\ttaxID\tpropagated_taxID\n")
        for i, name in enumerate(names):
            fh.write(f"{name}\t{int(labels[i])}\t{cls[i]}\t{propagated[i]}\n")
    rescued = sum(1 for a, b in zip(cls, propagated) if a == 0 and b != 0)
    return {
        "reads": len(reads),
        "groups": int(len(np.unique(labels))),
        "rescued": rescued,
        "out": groups_path,
    }
