"""The plain reference of ``classify``: the same reads against the same
table give the same classification lines and report.

Matching (Metabuli's ``KmerMatcher``, as the port's match core states
it): each valid query metamer meets every table row of its amino-acid
group; a row's Hamming sum is its codons' base mismatches (0-3 a codon);
the rows within ``min(2 * the group's least sum, 7)`` are kept. The
table's last row never becomes a candidate (a quirk of the reference
kept for identical output). Matches are sorted by (read, species, frame,
position, Hamming sum, codon numbers) and each read goes through the
frozen taxonomer; lines and the report are written as Metabuli's
``Reporter`` writes them.

Imports nothing of the program: it takes the benchmark's own table and
reads, and reads the program's files only to judge them."""

from __future__ import annotations

import numpy as np
import torch

from . import metamers
from .taxonomer import F32, Params, Result, Taxonomer

M40 = (1 << 40) - 1
# the bases, padding included, of the rows ``k2_bytes`` joins at once: a
# batch of 8,192 2x150 bp pairs is one block
BLOCK_CELLS = 1 << 22


def used_len(length):
    """Bases of a read (a mate) of ``length`` the classifier reports: its
    whole codons; elementwise on an array."""
    return np.maximum(0, 3 * ((np.asarray(length) - 2) // 3))


def cuts(bases: np.ndarray, batch_reads: int, batch_bases: int = 0):
    """``[a, b)`` of each batch of reads of ``bases`` bases each (a pair's
    mates together), as the program's batch reader cuts them: at
    ``batch_reads`` reads, or before the read that would pass
    ``batch_bases`` bases (if set; at least one read a batch)."""
    n = len(bases)
    total = np.concatenate([[0], np.cumsum(bases)])
    out, a = [], 0
    while a < n:
        b = min(a + batch_reads, n)
        if batch_bases > 0:
            fit = int(np.searchsorted(total, total[a] + batch_bases,
                                      side="right")) - 1
            b = min(b, max(fit, a + 1))
        out.append((a, b))
        a = b
    return out


def rows(mates) -> tuple[np.ndarray, np.ndarray]:
    """The program's rows of some reads, given a ``traffic.Mate`` a mate:
    base codes [rows, longest row], 7 past a row's end, and each row's
    length; a read's mates one after another."""
    k_mates, n = len(mates), len(mates[0].lens)
    lens = np.stack([m.lens for m in mates], 1).reshape(-1)
    codes = np.full((n * k_mates, int(lens.max(initial=0))), 7, np.uint8)
    for k, m in enumerate(mates):
        at = np.arange(m.bases.size) - np.repeat(m.starts(), m.lens)
        codes[np.repeat(np.arange(n) * k_mates + k, m.lens), at] = \
            metamers.to_codes(m.bases)
    return codes, lens


class Table:
    """The searchable table on ``device``: the amino-acid key, codon
    numbers, raw codons and taxid of every row but the last."""

    def __init__(self, values: np.ndarray, taxids: np.ndarray, taxonomy,
                 device):
        self.device = torch.device(device)
        self.ex = metamers.Extractor(self.device)
        n = max(0, len(values) - 1)
        v = torch.from_numpy(values[:n].view(np.int64)).to(self.device)
        self.aa = (v >> 24) & M40
        self.lo = (v & 0xFFFFFF).to(torch.int32)
        self.d48 = self.ex.row_dna48(v)
        del v
        self.taxid = torch.from_numpy(taxids[:n].astype(np.int32)).to(
            self.device)
        self.tax = taxonomy
        top = max(taxonomy.parent) + 1
        self.species = torch.tensor(
            [taxonomy.species_of(t) if t in taxonomy.parent else 0
             for t in range(top)], dtype=torch.int32, device=self.device)


class Join:
    """The kept (query metamer, table row) pairs of some rows (mates),
    and the sizes the join touched."""

    def __init__(self, table: Table, codes: np.ndarray, lens: np.ndarray):
        dev = table.device
        value, dna48, pos, valid = table.ex.extract(
            torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev))
        W = value.shape[2]
        slot = torch.nonzero(valid.reshape(-1)).squeeze(1)
        q_aa = (value.reshape(-1)[slot] >> 24) & M40
        lo = torch.searchsorted(table.aa, q_aa)
        hi = torch.searchsorted(table.aa, q_aa, right=True)
        cnt = hi - lo
        self.kmers = int(slot.numel())
        hit = cnt > 0
        # the first row of each group that some query met
        self.groups = torch.unique(lo[hit])
        e = torch.repeat_interleave(torch.arange(slot.numel(), device=dev),
                                    cnt)
        first = torch.cumsum(cnt, 0) - cnt
        row = lo[e] + torch.arange(e.numel(), device=dev) - first[e]
        x = dna48.reshape(-1)[slot][e] ^ table.d48[row]
        m = (x | (x >> 1)) & 0x555555555555
        frame = torch.div(slot, W, rounding_mode="floor") % 6
        fwd = (frame < 3)[e]
        hsum = torch.zeros_like(m)
        h16 = torch.zeros_like(m)
        for j in range(metamers.K):  # slot j, most significant first
            lane = (m >> (6 * (metamers.K - 1 - j))) & 0x15
            h = (lane & 1) + ((lane >> 2) & 1) + ((lane >> 4) & 1)
            hsum += h
            h16 |= torch.where(fwd, h << (2 * (metamers.K - 1 - j)),
                               h << (2 * j))
        least = torch.full((slot.numel(),), 255, dtype=torch.int64,
                           device=dev)
        least.scatter_reduce_(0, e, hsum, reduce="amin")
        keep = hsum <= torch.clamp(2 * least, max=7)[e]
        e, row = e[keep], row[keep]
        self.matches = int(e.numel())
        s = slot[e]
        self.mate = torch.div(s, 6 * W, rounding_mode="floor")
        self.frame = frame[e]
        self.pos = pos.reshape(-1)[s]
        self.ham = hsum[keep]
        self.h16 = h16[keep]
        self.row = row


def k2_bytes(table: Table, mates) -> dict:
    """The least bytes a search of one batch's reads (a ``traffic.Mate`` a
    mate) must move: each valid query metamer read once
    (8 B), each row of a group a query met read once (its 8 B value: K2
    reads no taxid, the fetch after it gathers them), each kept pair
    written once (two 4 B indices). Joined in blocks of reads by length,
    each at most ``BLOCK_CELLS`` padded bases; a group met in several
    blocks counts once."""
    longest = np.stack([m.lens for m in mates], 1).max(1)
    order = np.argsort(longest, kind="stable")
    span = len(mates) * longest[order]
    kmers = matches = 0
    groups = []
    a = 0
    while a < order.size:
        # reads a..b-1 of the order, each padded to the last one's span
        fit = np.arange(1, order.size - a + 1) * span[a:] <= BLOCK_CELLS
        b = a + max(1, int(np.count_nonzero(fit)))
        j = Join(table, *rows([m.take(order[a:b]) for m in mates]))
        kmers += j.kmers
        matches += j.matches
        groups.append(j.groups)
        a = b
    g_lo = torch.unique(torch.cat(groups))
    group_rows = int((torch.searchsorted(
        table.aa, table.aa[g_lo], right=True) - g_lo).sum())
    return {"kmers": kmers, "group_rows": group_rows, "matches": matches,
            "bytes": 8 * kmers + 8 * group_rows + 8 * matches}


def classify_reads(table: Table, mates, names: list[str], params: Params,
                   num=F32) -> list[str]:
    """Classification lines of some reads (a ``traffic.Mate`` a mate), in
    their order."""
    n, k_mates = len(names), len(mates)
    used = np.stack([used_len(m.lens) for m in mates], 1)
    # a row's positions start past the mates before it, 3 bases apart
    row_off = (np.cumsum(used + 3, 1) - (used + 3)).reshape(-1)
    read_len = used.sum(1)
    j = Join(table, *rows(mates))
    mate = j.mate.cpu().numpy()
    read = mate // k_mates
    taxid = table.taxid[j.row].cpu().numpy()
    cols = {
        "species": table.species.cpu().numpy()[taxid],
        "frame": j.frame.cpu().numpy(),
        "pos": j.pos.cpu().numpy() + row_off[mate],
        "hamming": j.ham.cpu().numpy(),
        "dna": table.lo[j.row].cpu().numpy(),
        "taxid": taxid,
        "h16": j.h16.cpu().numpy(),
    }
    order = np.lexsort((cols["dna"], cols["hamming"], cols["pos"],
                        cols["frame"], cols["species"], read))
    cols = {k: v[order] for k, v in cols.items()}
    read = read[order]
    bounds = np.searchsorted(read, np.arange(n + 1))
    tx = Taxonomer(params, table.tax, num)
    out = []
    for i in range(n):
        lo, hi = bounds[i], bounds[i + 1]
        rl = int(read_len[i])
        res = (tx.classify({k: v[lo:hi] for k, v in cols.items()}, rl)
               if hi > lo else Result())
        out.append(line(table.tax, names[i], res, rl))
    return out


def line(tax, name: str, r: Result, read_len: int) -> str:
    """One classification line (``Reporter.cpp:35-80``)."""
    if r.is_classified:
        return (f"1\t{name}\t{r.taxid}\t{read_len}\t{r.score:.6g}\t"
                f"{tax.rank[r.taxid]}\t"
                + "".join(f"{t}:{r.tax_counts[t]} "
                          for t in sorted(r.tax_counts)) + "\n")
    return f"0\t{name}\t0\t{read_len}\t{r.score:.6g}\t-\t-\t\n"


def report(tax, lines: list[str]) -> str:
    """The Kraken-style report (``Reporter.cpp:115-193``) of a file's
    classification lines: clade counts over the tree, children by
    descending clade count (ties in the order the taxa first appear)."""
    counts: dict[int, int] = {}
    for ln in lines:
        cols = ln.split("\t", 3)
        t = int(cols[2]) if cols[0] == "1" else 0
        counts[t] = counts.get(t, 0) + 1
    total = len(lines)
    clade: dict[int, dict] = {}
    for t, c in counts.items():
        if t <= 0:
            continue
        e = clade.setdefault(t, {"tax": 0, "clade": 0, "children": []})
        e["tax"] += c
        e["clade"] += c
        child, p = t, tax.parent[t]
        while p != child:
            pe = clade.setdefault(p, {"tax": 0, "clade": 0, "children": []})
            if child not in pe["children"]:
                pe["children"].append(child)
            pe["clade"] += c
            child, p = p, tax.parent[p]
    out = ["#clade_proportion\tclade_count\ttaxon_count\trank\ttaxID\tname\n"]
    un = counts.get(0, 0)
    if un:
        out.append(f"{100 * un / max(1, total):.4f}\t{un}\t{un}\tno rank\t0\t"
                   "unclassified\n")

    def node(t, depth):
        e = clade.get(t)
        if e is None or e["clade"] == 0:
            return
        out.append(f"{100 * e['clade'] / max(1, total):.4f}\t{e['clade']}\t"
                   f"{e['tax']}\t{tax.rank[t]}\t{t}\t"
                   f"{'  ' * depth}{tax.name[t]}\n")
        for ch in sorted(e["children"], key=lambda c: -clade[c]["clade"]):
            node(ch, depth + 1)

    node(1, 0)
    return "".join(out)
