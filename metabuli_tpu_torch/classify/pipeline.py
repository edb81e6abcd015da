"""Device index and match core: encoded reads -> sorted match columns.

The counterpart of ``metabuli_tpu.classify.pipeline``, in its plain table
layout:

  grest  i32 [G]   permuted amino-acid key bits below the bucket prefix
  gstart i32 [G]   first row of the group
  gend   i32 [G]   one past its last row
  taxdna i64 [N]   value_lo32 << 32 | taxid
  d48    i64 [N]   the row's 8 codons as raw bases, 6 bits each (standard
                   alphabet only)
  prefix i32 [2^prefix_bits + 1]   bucket -> first group

Groups (runs of one amino-acid word) are ordered by the permuted key
``pi = aa * AA_PERM_MULT mod 2^40``, whose top ``prefix_bits`` pick the
bucket. A query finds its group by a lower-bound search inside its
bucket, then scans the group's rows (at most ``cap``), keeps those whose
Hamming sum is within ``min(2 * min, 7)``, and the kept rows become
matches sorted in the reference order (qid, species, frame, pos,
hamming, dna) (`KmerMatcher.cpp:1149-1166`).

The reduced alphabet (``reduced=True``, ``--reduced-aa 1``) keys groups
by the 32-bit amino-acid part (``value >> 32``, permuted mod 2^32) and
scores a row on its 32-bit codon-number part, the high word of
``taxdna`` (the reference package's ``lo32``), through K11's table
(``ops.hamming``); it has no d48. Its search layout differs:

  brec   i32 [2^prefix_bits + 1, 4]   one 16-byte record per bucket, in
                   place of ``prefix``: (the bucket's group count, at most
                   2^prefix_bits - 1, above the first group's rest bits;
                   the first group's gstart; its gend; the bucket's first
                   group), the last record (0, 0, 0, groups)
  tword  i32 [N]   taxdna's high words, the rows' codon numbers, dense

so one record decides a query of an empty or one-group bucket, and a
window of n rows reads 4n contiguous bytes (K11, ``_search_records``).

An old-format DB (``kmer_format`` 1) has the same layout: its amino-acid
key is base-21 where format 2's is 5 bits a residue, which changes no
grouping or search, and its metamers pack their codons little-endian, so
its d48 does too (``expand_db_dna48``) and the per-codon h16 words take
the other frame orientation (``(frame < 3) != (kmer_format != 2)``, K2's
format flag).

``classify_blocks`` takes a ``DevIndex`` or a ``chunked.ChunkedIndex``,
whose chunks are copied in one at a time and scanned in turn, and a
batch as ``Block``s: a ragged batch's rows in blocks by length
(``length_blocks``), so that its padded bases follow its bases and not
its longest read; ``classify_core`` takes one padded matrix as one block.

Every stage is sized exactly from a count read back from the device, so
none of the reference package's caps, budgets or retry ladder exist here.

A batch's results go to the host through ``to_host_async`` (pinned
buffers and a CUDA event, waited on by the classifier's worker thread);
``matches_to_host`` turns sorted match columns there into the reference
package's host match dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..csrc import build
from ..ops import encode
from ..ops.encode import srl
from ..ops.hamming import hamming_all_reduced_plain, reduced_lut

PREFIX_BITS = 26  # cap; see pick_prefix_bits
AA_PERM_MULT = 0x9E3779B97F4A7C15
_M40 = (1 << 40) - 1
_MUL40 = AA_PERM_MULT & _M40


def pick_prefix_bits(n_groups: int) -> int:
    """Bucket-prefix width for ~2 buckets per distinct amino-acid group."""
    bits = 12
    while (1 << bits) < 2 * n_groups and bits < PREFIX_BITS:
        bits += 1
    return bits


def aa_permute(aa: torch.Tensor, reduced: bool = False) -> torch.Tensor:
    """``aa * AA_PERM_MULT mod 2^40`` for 40-bit keys in int64 (``mod
    2^32`` for the reduced alphabet's 32-bit keys), split into 20-bit (16-
    bit) halves so that no product overflows."""
    if reduced:
        m32 = AA_PERM_MULT & 0xFFFFFFFF
        lo_m, hi_m = m32 & 0xFFFF, m32 >> 16
        al, ah = aa & 0xFFFF, aa >> 16
        mid = (al * hi_m + ah * lo_m) & 0xFFFF
        return (al * lo_m + (mid << 16)) & 0xFFFFFFFF
    lo_m, hi_m = _MUL40 & 0xFFFFF, _MUL40 >> 20
    al = aa & 0xFFFFF
    ah = aa >> 20
    mid = (al * hi_m + ah * lo_m) & 0xFFFFF
    return (al * lo_m + (mid << 20)) & _M40


def aa_key(value: torch.Tensor, reduced: bool) -> torch.Tensor:
    """The amino-acid part of int64 metamers: 40 bits at 24, or 32 bits
    at 32 for the reduced alphabet."""
    return srl(value, 32 if reduced else 24)


def key_bits(reduced: bool) -> int:
    return 32 if reduced else 40


def _expansion_table() -> np.ndarray:
    """EXP[aa * 8 + codon_number] -> the codon's 6-bit raw bases."""
    from ..ops.genetic_code import codon_tables

    aa_tab, num_tab = codon_tables(False)
    exp = np.zeros(21 * 8, np.int64)
    for ci in range(64):
        exp[int(aa_tab[ci]) * 8 + int(num_tab[ci])] = ci
    return exp


def expand_db_dna48(values: torch.Tensor,
                    kmer_format: int = 2) -> torch.Tensor:
    """Per-row raw-base codons (the Hamming operand of the candidate scan):
    same-AA metamers differ only in their codons' bases, so the reference
    LUT distances reduce to base Hamming (see the reference package).
    Format 1 takes its amino acids as base-21 digits and its codons
    little-endian (codon i at bits 3i of the value and 6i of d48)."""
    exp = torch.as_tensor(_expansion_table(), device=values.device)
    d48 = torch.zeros_like(values)
    if kmer_format == 2:
        for i in range(8):
            aa_i = srl(values, 24 + 5 * (7 - i)) & 31
            num_i = srl(values, 3 * (7 - i)) & 7
            d48 |= exp[torch.clamp(aa_i, max=20) * 8 + num_i] << (6 * (7 - i))
        return d48
    aa = srl(values, 24)
    for i in range(8):
        aa_i = torch.div(aa, 21 ** i, rounding_mode="floor") % 21
        num_i = srl(values, 3 * i) & 7
        d48 |= exp[aa_i * 8 + num_i] << (6 * i)
    return d48


@dataclass
class DevIndex:
    """The sorted metamer table on the device, in the plain layout."""

    grest: torch.Tensor
    gstart: torch.Tensor
    gend: torch.Tensor
    taxdna: torch.Tensor
    d48: torch.Tensor | None  # None for the reduced alphabet
    prefix: torch.Tensor | None  # None for the reduced alphabet: brec
    n: int                 # table rows
    prefix_bits: int
    search_iters: int      # lower-bound steps that cover the fullest bucket
    max_group: int         # deepest group, rows
    rows_per_hit: float    # size-biased mean group: sum |g|^2 / sum |g|
    reduced: bool = False  # the reduced alphabet (K11 scores it)
    kmer_format: int = 2   # 1: old-format packing (K2's format flag)
    brec: torch.Tensor | None = None   # reduced: the bucket records
    tword: torch.Tensor | None = None  # reduced: the dense codon words

    @property
    def device(self) -> torch.device:
        return self.grest.device

    @property
    def nbytes(self) -> int:
        """Bytes of the index's tables."""
        return sum(t.numel() * t.element_size() for t in (
            self.grest, self.gstart, self.gend, self.taxdna, self.d48,
            self.prefix, self.brec, self.tword) if t is not None)

    def bucket_prefix(self) -> torch.Tensor:
        """bucket -> first group, as ``prefix`` (int32 [2^prefix_bits +
        1]); a reduced index reads it from its records."""
        return self.prefix if self.brec is None else self.brec[:, 3]

    @classmethod
    def from_numpy(cls, grest, gstart, gend, taxdna, d48, prefix,
                   device="cpu") -> "DevIndex":
        """Load tables made as numpy arrays (e.g. by the reference
        package's builder in its plain layout; standard alphabet)."""
        def t(a, dt):
            a = np.ascontiguousarray(a)
            if a.dtype == np.uint64:
                a = a.view(np.int64)
            return torch.from_numpy(np.array(a, dt)).to(device)

        prefix = t(prefix, np.int32)
        grest, gstart, gend = (t(grest, np.int32), t(gstart, np.int32),
                               t(gend, np.int32))
        return cls._finish(grest, gstart, gend, t(taxdna, np.int64),
                           t(d48, np.int64), prefix)

    @classmethod
    def _finish(cls, grest, gstart, gend, taxdna, d48, prefix,
                reduced: bool = False, kmer_format: int = 2) -> "DevIndex":
        pb = int(prefix.numel() - 1).bit_length() - 1
        max_bucket = int((prefix[1:] - prefix[:-1]).max()) if pb else 1
        iters = max(1, int(np.ceil(np.log2(max(2, max_bucket + 1)))))
        size = (gend - gstart).to(torch.int64)
        max_group = int(size.max()) if size.numel() else 1
        rows = int(size.sum())
        brec = tword = None
        if reduced:
            brec = bucket_records(grest, gstart, gend, prefix, pb)
            # taxdna's high word, exact in int32 (arithmetic shift)
            tword = (taxdna >> 32).to(torch.int32)
            prefix = None
        return cls(grest, gstart, gend, taxdna, d48, prefix,
                   n=int(taxdna.numel()), prefix_bits=pb,
                   search_iters=iters, max_group=max(max_group, 1),
                   rows_per_hit=int((size * size).sum()) / max(rows, 1),
                   reduced=reduced, kmer_format=kmer_format, brec=brec,
                   tword=tword)

    def tables(self):
        return (self.grest, self.gstart, self.gend, self.taxdna, self.d48,
                self.prefix)

    def on_device(self, mark=None):
        """The index as ``match_blocks`` scans it: itself (a
        ``ChunkedIndex`` yields its chunks, one copied in at a time)."""
        yield self


def bucket_records(grest, gstart, gend, prefix, prefix_bits: int,
                   step: int = 1 << 22):
    """The reduced index's bucket records (int32 [2^prefix_bits + 1, 4]),
    one a bucket: x = min(groups, 2^prefix_bits - 1) << rest_bits | the
    first group's rest (0 for an empty bucket), y and z the first group's
    gstart and gend, w the bucket's first group; then the sentinel
    (0, 0, 0, groups). A count at its cap reads its end from the next
    record's w. Filled ``step`` buckets at a time, so the temporaries stay
    small beside the records."""
    if prefix_bits < 1:
        raise ValueError("bucket records need prefix_bits >= 1")
    rb = 32 - prefix_bits
    nb = prefix.numel() - 1
    rec = torch.zeros((nb + 1, 4), dtype=torch.int32, device=prefix.device)
    rec[:, 3] = prefix
    g_max = grest.numel() - 1
    for a in range(0, nb, step):
        e = min(a + step, nb)
        first = prefix[a:e].to(torch.int64)
        n = prefix[a + 1:e + 1].to(torch.int64) - first
        has = n > 0
        g = torch.clamp(first, max=g_max)
        x = torch.where(has, (torch.clamp(n, max=(1 << prefix_bits) - 1)
                              << rb) | grest[g].to(torch.int64), 0)
        rec[a:e, 0] = x - ((x & 0x80000000) << 1)  # uint32 bits
        rec[a:e, 1] = torch.where(has, gstart[g], 0)
        rec[a:e, 2] = torch.where(has, gend[g], 0)
    return rec


def build_dev_index(values: np.ndarray, taxids: np.ndarray,
                    kmer_format: int = 2, device="cpu",
                    reduced: bool = False) -> DevIndex:
    """Group, permute and bucket a sorted u64 table on ``device``."""
    if kmer_format not in (1, 2):
        raise ValueError(f"unsupported kmer_format {kmer_format}")
    if len(values) >= 1 << 31:  # rows are int32 indices on the device
        raise ValueError(f"{len(values)} rows: the device index holds < 2^31")
    dev = torch.device(device)
    v = torch.from_numpy(
        np.ascontiguousarray(values, np.uint64).view(np.int64)).to(dev)
    tx = torch.from_numpy(np.ascontiguousarray(taxids, np.int32)).to(dev)
    n = v.numel()
    aa = aa_key(v, reduced)
    new_g = torch.ones(n, dtype=torch.bool, device=dev)
    if n:
        new_g[1:] = aa[1:] != aa[:-1]
    starts = torch.nonzero(new_g).squeeze(1)
    del new_g
    n_groups = starts.numel()
    pb = pick_prefix_bits(max(n_groups, 1))
    rb = key_bits(reduced) - pb
    if n_groups:
        ends = torch.cat([starts[1:], torch.tensor([n], device=dev)])
        pi, order = torch.sort(aa_permute(aa[starts], reduced), stable=True)
        grest = (pi & ((1 << rb) - 1)).to(torch.int32)
        gstart = starts[order].to(torch.int32)
        gend = ends[order].to(torch.int32)
        counts = torch.bincount(pi >> rb, minlength=1 << pb)
        del pi, order, ends
    else:  # degenerate empty table: one unreachable group
        grest = torch.full((1,), -1, dtype=torch.int32, device=dev)
        gstart = torch.zeros(1, dtype=torch.int32, device=dev)
        gend = torch.zeros(1, dtype=torch.int32, device=dev)
        counts = torch.zeros(1 << pb, dtype=torch.int64, device=dev)
    del aa, starts
    prefix = torch.zeros((1 << pb) + 1, dtype=torch.int32, device=dev)
    prefix[1:] = torch.cumsum(counts, 0)
    del counts  # before the reduced index's bucket records are made
    taxdna = ((v & 0xFFFFFFFF) << 32) | (tx.to(torch.int64) & 0xFFFFFFFF)
    d48 = None if reduced else expand_db_dna48(v, kmer_format)
    del v, tx
    return DevIndex._finish(grest, gstart, gend, taxdna, d48, prefix,
                            reduced, kmer_format)


# ------------------------------------------------------------------ K2
class Candidates(NamedTuple):
    """Kept candidate rows in (query slot, table row) order."""

    row: torch.Tensor    # [M] int32 table row
    slot: torch.Tensor   # [M] int32 query slot (read, frame, window)
    pay: torch.Tensor    # [M] int32 h16 << 6 | hamming << 3 | frame
    n_over_cap: int      # query slots whose group was cut at cap
    n_rewalk: int = 0    # K2 warps whose write launch walked again


def _hamming48(q: torch.Tensor, t: torch.Tensor):
    """(sum, fwd h16, rev h16) of the base mismatches of two dna48 words:
    2-bit per-codon sums, codon i at bits 2i (fwd) or 2(7-i) (rev)."""
    x = q ^ t
    m = (x | (x >> 1)) & 0x555555555555
    hsum = torch.zeros_like(m)
    fwd = torch.zeros_like(m)
    rev = torch.zeros_like(m)
    for i in range(8):
        lane = (m >> (6 * i)) & 0x15
        vi = (lane & 1) + ((lane >> 2) & 1) + ((lane >> 4) & 1)
        hsum += vi
        fwd |= vi << (2 * i)
        rev |= vi << (2 * (7 - i))
    return hsum, fwd, rev


def _search_groups(index: DevIndex, q_value: torch.Tensor,
                   q_valid: torch.Tensor):
    """Bucketed lower-bound search -> (group start row, group end, hit):
    over ``prefix`` (standard index) or the bucket records (reduced)."""
    if index.brec is not None:
        return _search_records(index, q_value, q_valid)
    return _search_prefix(index, q_value, q_valid)


def _search_prefix(index: DevIndex, q_value: torch.Tensor,
                   q_valid: torch.Tensor):
    """The lower bound of the query's key among its bucket's groups,
    ``prefix[bucket]`` to ``prefix[bucket + 1]``."""
    rb = key_bits(index.reduced) - index.prefix_bits
    pi = aa_permute(aa_key(q_value, index.reduced), index.reduced)
    rest = (pi & ((1 << rb) - 1)).to(torch.int32)
    bucket = pi >> rb
    lo = index.prefix[bucket].to(torch.int64)
    end = index.prefix[bucket + 1].to(torch.int64)
    hi = end.clone()
    g_max = index.grest.numel() - 1
    for _ in range(index.search_iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = index.grest[torch.clamp(mid, max=g_max)] < rest
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    g = torch.clamp(lo, max=g_max)
    hit = q_valid & (lo < end) & (index.grest[g] == rest)
    gs = index.gstart[g].to(torch.int64)
    ge = torch.where(hit, index.gend[g].to(torch.int64), gs)
    return gs, ge, hit


def _search_records(index: DevIndex, q_value: torch.Tensor,
                    q_valid: torch.Tensor):
    """K11's search over the bucket records, as the kernel makes it: the
    record decides an empty bucket and a key equal to its first group's;
    a larger key of a bucket with more groups takes the lower bound over
    the others' grest (its end from the next record where the count is
    at its cap). A miss gives an empty window at row 0."""
    pb = index.prefix_bits
    rb = 32 - pb
    pi = aa_permute(aa_key(q_value, True), True)
    rest = pi & ((1 << rb) - 1)
    bucket = pi >> rb
    rec = index.brec[bucket].to(torch.int64)
    x = rec[:, 0] & 0xFFFFFFFF
    n, rest0, g0 = x >> rb, x & ((1 << rb) - 1), rec[:, 3]
    first = (n > 0) & (rest == rest0)
    more = (n > 0) & (rest > rest0)
    end = torch.where(n == (1 << pb) - 1,
                      index.brec[bucket + 1, 3].to(torch.int64), g0 + n)
    lo = g0 + 1
    hi = torch.where(more, end, lo)
    g_max = index.grest.numel() - 1
    for _ in range(index.search_iters):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = index.grest[torch.clamp(mid, max=g_max)] < rest
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    g = torch.clamp(lo, max=g_max)
    later = more & (lo < end) & (index.grest[g] == rest)
    hit = q_valid & (first | later)
    gs = torch.where(first, rec[:, 1], index.gstart[g].to(torch.int64))
    ge = torch.where(first, rec[:, 2], index.gend[g].to(torch.int64))
    gs = torch.where(hit, gs, 0)
    return gs, torch.where(hit, ge, 0), hit


def search_scan_plain(index: DevIndex, q_value: torch.Tensor,
                      q_valid: torch.Tensor, q_dna48: torch.Tensor | None,
                      W: int, cap: int) -> Candidates:
    """Plain PyTorch version of kernel K2 (and of K11 on a reduced index,
    which reads no ``q_dna48``): each query's candidate window is expanded
    with ``repeat_interleave`` and scanned as one flat batch."""
    dev = q_value.device
    Q = q_value.numel()
    gs, ge, hit = _search_groups(index, q_value, q_valid)
    n_over = int((hit & (gs + cap < ge)).sum())
    cnt = torch.minimum(ge, gs + cap) - gs
    slot = torch.repeat_interleave(torch.arange(Q, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    row = gs[slot] + torch.arange(slot.numel(), device=dev) - first[slot]
    if index.reduced:
        hsum, fwd, rev = hamming_all_reduced_plain(
            q_value[slot] & 0xFFFFFFFF,
            index.tword[row].to(torch.int64) & 0xFFFFFFFF)
    else:
        hsum, fwd, rev = _hamming48(q_dna48[slot], index.d48[row])
    frame = torch.div(slot, W, rounding_mode="floor") % 6
    h16 = torch.where((frame < 3) != (index.kmer_format != 2), fwd, rev)
    min_h = torch.full((Q,), 255, dtype=torch.int64, device=dev)
    min_h.scatter_reduce_(0, slot, hsum, reduce="amin")
    keep = hsum <= torch.clamp(2 * min_h, max=7)[slot]
    pay = (h16 << 6) | (hsum << 3) | frame
    return Candidates(row[keep].to(torch.int32), slot[keep].to(torch.int32),
                      pay[keep].to(torch.int32), n_over)


# most entries per query slot of K2's stash (8 B each)
STASH_MAX_PER_SLOT = 8


def stash_per_slot(index: DevIndex) -> int:
    """Entries per query slot of the pool in which K2's count launch hands
    its kept pairs to the write launch: twice the window that a query
    drawn like a table row meets (the index's size-biased mean group),
    at most STASH_MAX_PER_SLOT. A warp reserves its windows' rows at once;
    one that finds the pool full walks its windows again in the write
    launch (``Candidates.n_rewalk``)."""
    return min(STASH_MAX_PER_SLOT, max(1, math.ceil(2 * index.rows_per_hit)))


def search_scan(index: DevIndex, q_value: torch.Tensor,
                q_valid: torch.Tensor, q_dna48: torch.Tensor | None,
                W: int, cap: int) -> Candidates:
    """Kernel K2 wrapper: a count launch, a scan of the per-warp counts,
    one read-back of the output size, a write launch in slot order. A
    reduced index launches K11, K2's reduced variant (its query word is
    ``q_value``'s low half, so ``q_dna48`` is not read; it searches the
    bucket records and scores the dense codon words). CPU tensors take
    the plain version."""
    if q_value.device.type == "cpu":
        return search_scan_plain(index, q_value, q_valid, q_dna48, W, cap)
    reduced = index.reduced
    # the query and table words the scan scores, and the bucket table
    q_word = q_value if reduced else q_dna48
    t_word = index.tword if reduced else index.d48
    buckets = index.brec if reduced else index.prefix
    if q_value.dtype != torch.int64 or q_word.dtype != torch.int64 \
            or q_valid.dtype != torch.bool:
        raise TypeError("search_scan: value/dna48 int64, valid bool")
    if not 0 < cap < (1 << 31):
        raise ValueError(f"search_scan: cap {cap} outside (0, 2^31)")
    dev = q_value.device
    Q = q_value.numel()
    tabs = (index.grest, index.gstart, index.gend, buckets, t_word)
    build.require_cuda("search_scan", q_value, q_valid, q_word, *tabs)
    if reduced and buckets.data_ptr() % 16:
        raise ValueError("search_scan: bucket records must be 16-byte "
                         "aligned")
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    if Q == 0:
        e = torch.empty(0, **i32)
        return Candidates(e, e, e, 0)
    n_warps = (Q + 31) // 32
    start, wlen, cut = (torch.empty(Q, **i32) for _ in range(3))
    # kept pairs per warp, the over-cap slots, the warps that walk again;
    # then the stash's fill
    counters = torch.zeros(n_warps + 3, **i64)
    acc, top = counters[:-1], counters[-1:]
    n_stash = stash_per_slot(index) * Q
    stash = torch.empty((n_stash, 2), **i32)
    wstash = torch.empty(n_warps, **i64)
    lib = build.get_lib()
    st = build.stream(dev)
    name = "search_scan_reduced" if reduced else "search_scan"
    # K11's table rides as one more argument of its two launches
    lut = (reduced_lut(dev).data_ptr(),) if reduced else ()
    count, write = ((lib.mtb_search_count_reduced,
                     lib.mtb_search_write_reduced) if reduced else
                    (lib.mtb_search_count, lib.mtb_search_write))
    rc = count(
        q_value.data_ptr(), q_valid.data_ptr(), q_word.data_ptr(), Q, W,
        index.grest.data_ptr(), index.gstart.data_ptr(),
        index.gend.data_ptr(), buckets.data_ptr(),
        t_word.data_ptr(), index.prefix_bits, cap, start.data_ptr(),
        wlen.data_ptr(), cut.data_ptr(), acc.data_ptr(),
        stash.data_ptr(), n_stash, top.data_ptr(), wstash.data_ptr(), *lut,
        index.grest.numel(), t_word.numel(), buckets.shape[0],
        index.kmer_format, st)
    build.check(rc, name)
    build.launches[name] += 1
    scan = torch.cumsum(acc, 0)
    total, with_over, with_rewalk = scan[-3:].tolist()  # the one read-back
    row, slot, pay = (torch.empty(total, **i32) for _ in range(3))
    if total:
        rc = write(
            q_word.data_ptr(), Q, W, t_word.data_ptr(),
            start.data_ptr(), wlen.data_ptr(), cut.data_ptr(),
            scan.data_ptr(), stash.data_ptr(), wstash.data_ptr(),
            row.data_ptr(), slot.data_ptr(), pay.data_ptr(), *lut,
            n_stash, t_word.numel(), total, index.kmer_format, st)
        build.check(rc, name)
    return Candidates(row, slot, pay, with_over - total,
                      with_rewalk - with_over)


# ------------------------------------------------------------ match core
class MatchColumns(NamedTuple):
    """Matches in reference order; ``packed`` = frame | hamming << 3 |
    h16 << 11, as in the reference package."""

    qid: torch.Tensor
    species: torch.Tensor
    pos: torch.Tensor
    dna: torch.Tensor
    taxid: torch.Tensor
    packed: torch.Tensor


def sort_by_keys(keys, cols):
    """Stable lexicographic sort of ``cols`` by int64 ``keys`` (most
    significant first): one stable pass per key, least significant first."""
    order = None
    for k in reversed(keys):
        k = k if order is None else k[order]
        o = torch.sort(k, stable=True)[1]
        order = o if order is None else order[o]
    if order is None:
        return list(cols)
    return [c[order] for c in cols]


# padded bases (rows x the longest row) of a block of the match core's
# input: a batch of 8,192 2x150 bp pairs is one block
BLOCK_BASES = 1 << 22


class Block(NamedTuple):
    """Rows of a batch as K1 takes them: base codes [rows, the block's
    longest row] (INVALID past a row's end), each row's length, position
    offset and read (qid)."""

    codes: torch.Tensor
    lens: torch.Tensor
    pos: torch.Tensor
    qid: torch.Tensor


def length_blocks(lens: np.ndarray, limit: int = BLOCK_BASES
                  ) -> list[np.ndarray] | None:
    """A batch's rows (their lengths ``lens``) in blocks for the match
    core: None where the batch is one block (every row of one length, or
    rows x longest row within ``limit``), else each block's rows. The rows
    are ordered by length, longest first (stable), and cut into
    consecutive blocks of at most ``limit`` padded bases (rows x the
    block's first, longest row), at least one row a block.

    Each row of a block is at least as long as the next block's first
    row, so block j pads at most rows_j x (w_j - w_j+1) <= limit x (1 -
    w_j+1 / w_j) bases, and the batch's padding stays below ``limit`` x
    ln(longest / shortest row): the padded bases follow the bases, not
    the longest read."""
    lens = np.asarray(lens)
    n = lens.size
    if n == 0 or lens.min() == lens.max() or n * int(lens.max()) <= limit:
        return None
    order = np.argsort(-lens.astype(np.int64), kind="stable")
    out, a = [], 0
    while a < n:
        width = max(1, int(lens[order[a]]))
        b = min(n, a + max(1, limit // width))
        out.append(order[a:b])
        a = b
    return out


def match_blocks(index, tax2species: torch.Tensor, blocks: list[Block], *,
                 cap: int, syncmer: bool = False, smer_len: int = 5,
                 plain: bool = False, timer=None):
    """A batch's blocks -> (one unsorted MatchColumns per block and
    resident index of ``index``, counters): K1 on every block, then K2
    (K11 on a reduced index) and the fetch of every block against each
    resident index in turn, a chunked index copying each chunk in once.
    ``sort_matches`` orders them. ``counts["total_kmers"]`` is a device
    tensor: reading it waits for the device, so a caller reads it once
    its next stages are queued.

    ``plain=True`` runs the plain versions of K1 and K2 wherever the
    tensors lie (the kernel-versus-plain check on the card); otherwise the
    kernel wrappers choose by device. ``timer`` (optional) marks stage
    boundaries (see classifier.StageTimer); each block's marks add to its
    stage's."""
    mark = timer.mark if timer is not None else (lambda name: None)
    extract = (encode.extract_metamers_plain if plain
               else encode.extract_metamers)
    scan = search_scan_plain if plain else search_scan
    reduced = index.reduced
    queries = []
    total_kmers = None
    for b in blocks:
        mm = extract(b.codes, b.lens, syncmer=syncmer, smer_len=smer_len,
                     reduced=reduced, kmer_format=index.kmer_format)
        mark("extract")
        W = mm.value.shape[2]
        kmers = mm.valid.sum()
        total_kmers = kmers if total_kmers is None else total_kmers + kmers
        queries.append((b, W, (mm.value.reshape(-1), mm.valid.reshape(-1),
                               None if reduced else mm.dna48.reshape(-1)),
                        mm.pos.reshape(-1)))
    parts = []
    n_over = 0
    for ix in index.on_device(mark):
        for b, W, q, q_pos in queries:
            cand = scan(ix, *q, W, cap)
            mark("search_scan")
            tw = ix.taxdna[cand.row.to(torch.int64)]
            slot = cand.slot.to(torch.int64)
            read = (torch.div(slot, 6 * W, rounding_mode="floor") if W
                    else slot)
            taxid = (tw & 0xFFFFFFFF).to(torch.int32)
            if reduced:
                # the full 32-bit codon-number word, as int32 bits
                dna = srl(tw, 32)
                dna = (dna - ((dna & 0x80000000) << 1)).to(torch.int32)
            else:
                dna = (srl(tw, 32) & 0xFFFFFF).to(torch.int32)
            pay = cand.pay
            packed = (pay & 7) | (((pay >> 3) & 7) << 3) | ((pay >> 6) << 11)
            parts.append(MatchColumns(
                b.qid[read], tax2species[taxid.to(torch.int64)],
                q_pos[slot] + b.pos[read], dna, taxid, packed))
            n_over += cand.n_over_cap
            mark("fetch")
    counts = {
        "n_matches": sum(int(p.qid.numel()) for p in parts),
        "n_over_cap": n_over,
        "total_kmers": total_kmers,
    }
    return parts, counts


def cat_columns(parts) -> MatchColumns:
    """Match columns of several parts, concatenated in order."""
    if len(parts) == 1:
        return parts[0]
    return MatchColumns(*(torch.cat(c) for c in zip(*parts)))


def sort_matches(m: MatchColumns, reduced: bool = False) -> MatchColumns:
    """Match columns in the reference order (qid, species, frame, pos,
    hamming, dna), by one stable sort. Rows that tie on every key come
    from one query slot, whose amino-acid group lies in one resident
    index (chunk or shard), so concatenating the parts in index order
    keeps the single index's order."""
    i64 = lambda x: x.to(torch.int64)
    frame = m.packed & 7
    ham = (m.packed >> 3) & 7
    k1 = (i64(m.qid) << 32) | i64(m.species)
    if reduced:
        # 32 bits of dna leave no room beside pos: a third key, the dna
        # compared unsigned (the reference package flips its sign bit)
        keys = [k1, (i64(frame) << 35) | (i64(m.pos) << 3) | i64(ham),
                i64(m.dna) & 0xFFFFFFFF]
    else:
        keys = [k1, (i64(frame) << 59) | (i64(m.pos) << 27)
                | (i64(ham) << 24) | i64(m.dna)]
    return MatchColumns(*sort_by_keys(keys, m))


def classify_blocks(index, tax2species: torch.Tensor, blocks: list[Block],
                    *, cap: int, syncmer: bool = False, smer_len: int = 5,
                    plain: bool = False, timer=None):
    """A batch's blocks -> (MatchColumns, counters), against a
    ``DevIndex`` or a ``chunked.ChunkedIndex``: ``match_blocks``, then
    the parts' rows, concatenated, through the one stable sort
    (``sort_matches``). Rows that tie on every key come from one query
    slot, which lies in one block and one resident index, so the order is
    that of one block against the single index."""
    parts, counts = match_blocks(
        index, tax2species, blocks, cap=cap, syncmer=syncmer,
        smer_len=smer_len, plain=plain, timer=timer)
    m = sort_matches(cat_columns(parts), index.reduced)
    if timer is not None:
        timer.mark("sort")
    counts["total_kmers"] = int(counts["total_kmers"])
    return m, counts


def classify_core(index, tax2species: torch.Tensor,
                  codes: torch.Tensor, lens: torch.Tensor,
                  pos_offsets: torch.Tensor, qid_offsets: torch.Tensor,
                  **kw):
    """``classify_blocks`` of one padded matrix taken as one block."""
    return classify_blocks(index, tax2species,
                           [Block(codes, lens, pos_offsets, qid_offsets)],
                           **kw)


# the reference package's host match fields (``pipeline.FIELDS`` there)
FIELDS = ("qid", "species", "frame", "pos", "hamming", "dna", "taxid", "h16")


def matches_to_host(m: MatchColumns) -> dict:
    """Sorted match columns on the host -> the reference package's host
    match dict (``matches_to_host`` / ``_unpack_match_data`` for its
    5-word layout): ``FIELDS`` as int32 numpy arrays, frame, hamming and
    h16 unpacked from ``packed``, and ``n_matches``; without the match
    core's counters, which no taxonomer reads. The rows are in the
    reference order already (the device sort equals its lexsort), so the
    dict is marked ``sorted``."""
    col = lambda t: t.numpy().astype(np.int32, copy=False)
    packed = col(m.packed)
    out = {"qid": col(m.qid), "species": col(m.species),
           "frame": packed & 7, "pos": col(m.pos),
           "hamming": (packed >> 3) & 0xFF, "dna": col(m.dna),
           "taxid": col(m.taxid), "h16": (packed >> 11) & 0xFFFF}
    out.update(n_matches=len(packed), sorted=True)
    return out


# ------------------------------------------------------------ to the host
class HostCopy(NamedTuple):
    """Host tensors whose copy from the device may still be in flight."""

    tensors: list
    event: object  # torch.cuda.Event recorded after the copies, or None

    def wait(self) -> list:
        """The tensors, once their copies are done: blocks on the event
        alone (the copies were queued on the dispatching stream, so a
        ``.cpu()`` here would wait behind that stream's later kernels)."""
        if self.event is not None:
            self.event.synchronize()
        return self.tensors


def to_host_async(tensors) -> HostCopy:
    """Copies of device tensors in pinned host memory, queued with
    ``non_blocking=True`` on the current stream, and a CUDA event recorded
    after them. CPU tensors come back as they are."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type != "cuda":
        return HostCopy(tensors, None)
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return HostCopy(host, event)
