"""6-frame metamer extraction (kernel K1), the amino-acid k-mer scanners
(kernel K12), and their plain PyTorch versions.

K1 has the semantics of ``metabuli_tpu.ops.encode.extract_metamers``
(`KmerScanner.h:49-182`, `SyncmerScanner.h:9-103`,
`KmerExtractor.cpp:342-373`):

  * a read of length ``len`` covers ``aa_len = (len-2)//3`` codons per frame
    (none below length 2); the batch holds ``A = (L-2)//3`` codon columns
    and ``W = A-7`` windows;
  * forward frame f (0..2) starts at base f; reverse frame f (3..5) starts
    at ``(len%3 - (f-3)) mod 3`` and reads each base triple as its reverse
    complement;
  * window w is valid iff its 8 codons are; forward windows pack codon w
    most significant, reverse windows pack codon w+7 most significant
    (descending genome order); value = aa(5 bits x 8) << 24 | codon
    numbers (3 bits x 8); dna48 = the 8 codons' raw bases, 6 bits each, in
    the same order; pos = begin + 3w in every frame;
  * the reduced 16-letter alphabet (``reduced=True``) takes its own codon
    tables and packs value = aa(4 bits x 8) << 32 | codon numbers (4 bits
    x 8) (`SeqIterator.cpp:29-43`); it is scored on those codon numbers
    (K11), so it has no dna48;
  * closed syncmers keep a window iff the first minimal s-mer of its
    canonical s-mer sequence sits at offset 0 or 8-s;
  * ``kmer_format`` 1 (old-format DBs, `KmerScanner.h:120-182`) packs the
    same eight codons little-endian: the codon of slot j (the one format 2
    packs j-th most significant) weighs 21^j in a base-21 amino-acid sum
    (16^j for the reduced alphabet), its codon number sits at bits 3j (4j)
    and its bases at dna48 bits 6j.

Invalid windows carry value = dna48 = 0 (the reference package leaves
garbage there; only valid windows are ever read).

K12 has the semantics of ``extract_aa_kmers`` and ``extract_aa_kmers_dna``
there (`KmerScanner.h:185-350`, the UniRef DBs' kmerFormat 3/4): k
residues (12) of 5 bits, most significant first, at every window of a
protein row whose residues are all valid (code <= 23), optionally closed
syncmers of s-mers (first minimum at offset 0 or k-s); or of each of the
six frames of a DNA row translated codon by codon (the frames and codon
validity of K1; a reverse frame's codon p is read down from the frame's
last base, so its window w starts at base seq_end - 3(w+k) + 1). Every
slot's value, pos and valid are written, invalid ones included, as the
reference package computes them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..csrc import build
from .genetic_code import codon_tables

K = 8  # metamer length in codons


class Metamers(NamedTuple):
    value: torch.Tensor  # [B, 6, W] int64 metamer bit patterns
    pos: torch.Tensor    # [B, 6, W] int32
    valid: torch.Tensor  # [B, 6, W] bool
    dna48: torch.Tensor | None  # [B, 6, W] int64; None for reduced


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def max_windows(max_len: int) -> int:
    return max(0, max(0, (max_len - 2) // 3) - K + 1)


# (device, reduced) -> (amino acid, codon number) int32 tables of the
# alphabet, built and uploaded once per device
_TABLES: dict[tuple[torch.device, bool],
              tuple[torch.Tensor, torch.Tensor]] = {}


def _tables(device, reduced: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    key = (torch.device(device), bool(reduced))
    if key not in _TABLES:
        aa_tab, num_tab = codon_tables(reduced)
        _TABLES[key] = (
            torch.as_tensor(aa_tab.astype(np.int32), device=key[0]),
            torch.as_tensor(num_tab.astype(np.int32), device=key[0]))
    return _TABLES[key]


def _frame_codons(codes: torch.Tensor, lens: torch.Tensor, A: int,
                  reduced: bool = False):
    """Per-frame codon arrays [B, 6, A]: amino acid (-1 invalid), codon
    number, raw 6-bit bases, and each frame's begin [B, 6]."""
    B, L = codes.shape
    dev = codes.device
    aa_tab, num_tab = _tables(dev, reduced)
    c = codes.to(torch.int64)
    lens = lens.to(torch.int64)
    aa_len = torch.clamp(3 * torch.div(lens - 2, 3, rounding_mode="floor"),
                         min=0) // 3
    k = torch.arange(A, device=dev)
    aas, nums, c6s, oks, begins = [], [], [], [], []
    for f in range(6):
        if f < 3:
            begin = torch.full((B,), f, dtype=torch.int64, device=dev)
        else:
            begin = torch.remainder(lens % 3 - (f - 3), 3)
        p = begin[:, None] + 3 * k[None, :]                      # [B, A]
        inside = p + 2 < L
        pc = torch.clamp(p, max=max(L - 3, 0))
        b0 = torch.gather(c, 1, pc)
        b1 = torch.gather(c, 1, pc + 1)
        b2 = torch.gather(c, 1, pc + 2)
        ok = inside & (b0 < 4) & (b1 < 4) & (b2 < 4) & (k[None, :] < aa_len[:, None])
        if f < 3:
            c6 = (b0 << 4) | (b1 << 2) | b2
        else:
            c6 = ((b2 ^ 2) << 4) | ((b1 ^ 2) << 2) | (b0 ^ 2)
        c6 = torch.where(ok, c6 & 63, 0)
        aas.append(torch.where(ok, aa_tab[c6].to(torch.int64), -1))
        nums.append(torch.where(ok, num_tab[c6].to(torch.int64), 0))
        c6s.append(c6)
        oks.append(ok)
        begins.append(begin)
    return (torch.stack(aas, 1), torch.stack(nums, 1), torch.stack(c6s, 1),
            torch.stack(oks, 1), torch.stack(begins, 1))


def _syncmer_keep_plain(aa: torch.Tensor, smer_len: int, W: int):
    """Closed-syncmer mask [B, 6, W]; ``aa`` is [B, 6, A] in genome order.
    Reverse frames enumerate their s-mers from the window's top codon
    down (the canonical order of the reverse-complement scan)."""
    s = smer_len
    n_smer = K - s + 1
    a = torch.clamp(aa, min=0)
    smers = []
    for t in range(n_smer):
        fwd = torch.zeros(a[:, :3, :W].shape, dtype=torch.int64,
                          device=a.device)
        rev = torch.zeros_like(fwd)
        for j in range(s):
            fwd = (fwd << 5) | a[:, :3, t + j: t + j + W]
            o = K - 1 - t - j
            rev = (rev << 5) | a[:, 3:, o: o + W]
        smers.append(torch.cat([fwd, rev], 1))
    stack = torch.stack(smers, -1)
    # first occurrence of the minimum (torch.argmin returns the first)
    first = torch.argmin(stack, dim=-1)
    return (first == 0) | (first == n_smer - 1)


def extract_metamers_plain(codes: torch.Tensor, lens: torch.Tensor, *,
                           syncmer: bool = False, smer_len: int = 5,
                           reduced: bool = False,
                           kmer_format: int = 2) -> Metamers:
    """Plain PyTorch version of kernel K1 (any device)."""
    if kmer_format not in (1, 2):
        raise ValueError(f"unsupported kmer_format {kmer_format}")
    B, L = codes.shape
    A = max(0, (L - 2) // 3)
    W = max(0, A - K + 1)
    dev = codes.device
    if W == 0:
        z = torch.zeros((B, 6, 0), dtype=torch.int64, device=dev)
        return Metamers(z, z.to(torch.int32), z.to(torch.bool),
                        None if reduced else z)
    aa, num, c6, ok, begin = _frame_codons(codes, lens, A, reduced)
    bits_aa, bits_codon = (4, 4) if reduced else (5, 3)
    aa_part = torch.zeros((B, 6, W), dtype=torch.int64, device=dev)
    dna_part = torch.zeros_like(aa_part)
    dna48 = torch.zeros_like(aa_part)
    valid = torch.ones((B, 6, W), dtype=torch.bool, device=dev)
    aa_base = 16 if reduced else 21
    for j in range(K):
        # codon feeding bit slot j (most significant first): forward frames
        # take codon w+j, reverse frames codon w+7-j
        o = K - 1 - j
        a_j = torch.cat([aa[:, :3, j: j + W], aa[:, 3:, o: o + W]], 1)
        n_j = torch.cat([num[:, :3, j: j + W], num[:, 3:, o: o + W]], 1)
        c_j = torch.cat([c6[:, :3, j: j + W], c6[:, 3:, o: o + W]], 1)
        if kmer_format == 2:
            aa_part = (aa_part << bits_aa) | torch.clamp(a_j, min=0)
            dna_part = (dna_part << bits_codon) | n_j
            dna48 = (dna48 << 6) | c_j
        else:  # slot j is the j-th least significant
            aa_part = aa_part + torch.clamp(a_j, min=0) * aa_base ** j
            dna_part = dna_part | (n_j << (bits_codon * j))
            dna48 = dna48 | (c_j << (6 * j))
        valid = valid & ok[:, :, j: j + W]
    if syncmer:
        valid = valid & _syncmer_keep_plain(aa, smer_len, W)
    value = (aa_part << 8 * bits_codon) | dna_part
    value = torch.where(valid, value, 0)
    dna48 = None if reduced else torch.where(valid, dna48, 0)
    pos = begin[:, :, None] + 3 * torch.arange(W, device=dev)[None, None, :]
    return Metamers(value, pos.to(torch.int32), valid, dna48)


def extract_metamers(codes: torch.Tensor, lens: torch.Tensor, *,
                     syncmer: bool = False, smer_len: int = 5,
                     reduced: bool = False, kmer_format: int = 2) -> Metamers:
    """Kernel K1 wrapper: CUDA tensors launch ``mtb_extract_metamers``, or
    ``mtb_extract_metamers_reduced`` for the reduced alphabet (a CTA per
    chunk of a row's windows; the kernel writes every output element),
    with the packing of ``kmer_format``; CPU tensors take the plain
    version."""
    if codes.device.type == "cpu":
        return extract_metamers_plain(codes, lens, syncmer=syncmer,
                                      smer_len=smer_len, reduced=reduced,
                                      kmer_format=kmer_format)
    if kmer_format not in (1, 2):
        raise ValueError(f"unsupported kmer_format {kmer_format}")
    if codes.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise TypeError("extract_metamers: codes uint8 [B, L], lens int32 [B]")
    B, L = codes.shape
    if lens.shape != (B,) or not 1 <= smer_len <= K:
        raise ValueError("extract_metamers: lens must be [B] and smer_len "
                         f"in 1..{K}")
    W = max_windows(L)
    dev = codes.device
    value = torch.empty((B, 6, W), dtype=torch.int64, device=dev)
    dna48 = (None if reduced else
             torch.empty((B, 6, W), dtype=torch.int64, device=dev))
    pos = torch.empty((B, 6, W), dtype=torch.int32, device=dev)
    valid = torch.empty((B, 6, W), dtype=torch.bool, device=dev)
    if B == 0 or W == 0:
        return Metamers(value, pos, valid, dna48)
    aa_tab, num_tab = _tables(dev, reduced)
    build.require_cuda("extract_metamers", codes, lens)
    lib = build.get_lib()
    fn = (lib.mtb_extract_metamers_reduced if reduced
          else lib.mtb_extract_metamers)
    rc = fn(codes.data_ptr(), lens.data_ptr(), B, L, W, int(bool(syncmer)),
            int(smer_len), aa_tab.data_ptr(), num_tab.data_ptr(),
            value.data_ptr(), pos.data_ptr(), valid.data_ptr(),
            None if reduced else dna48.data_ptr(), codes.numel(),
            value.numel(), kmer_format, build.stream(dev))
    name = "extract_metamers" if kmer_format == 2 else "extract_metamers_f1"
    build.check(rc, name)
    # both alphabets count as K1 (of their format)
    build.launches[name] += 1
    return Metamers(value, pos, valid, dna48)


# ------------------------------------------------------------------- K12
AA_K = 12  # residues of an amino-acid k-mer (the UniRef DBs' KMER_LEN)
_RC8 = (2, 3, 0, 1, 7, 7, 7, 7)  # reverse complement of 3-bit base codes


def _build_aa_char_table() -> np.ndarray:
    """Residue char -> code (`KmerScanner.h:272-306`); codes > 23 invalid."""
    tab = np.full(256, 27, np.uint8)
    for i, ch in enumerate("ARNDCQEGHILKMFPSTWYV"):
        tab[ord(ch)] = i
    tab[ord("B")] = 20
    tab[ord("Z")] = 21
    tab[ord("U")] = 22
    tab[ord("O")] = 23
    tab[ord("*")] = 24
    for ch in "-.?":
        tab[ord(ch)] = 25
    tab[ord("X")] = 26
    # lowercase maps like uppercase (kseq yields raw sequence; the reference
    # indexes the raw char, so keep lowercase invalid to match `aacids`)
    return tab


AA_CHAR_CODE = _build_aa_char_table()


def encode_aa_seqs_padded(seqs, max_len=None):
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    if max_len is None:
        max_len = int(lens.max()) if len(seqs) else 0
    out = np.full((len(seqs), max_len), 27, dtype=np.uint8)
    for i, s in enumerate(seqs):
        if isinstance(s, str):
            s = s.encode()
        n = min(len(s), max_len)
        out[i, :n] = AA_CHAR_CODE[np.frombuffer(s, dtype=np.uint8)[:n]]
    return out, lens


def _check_aa_args(name, codes, lens, k, smer_len=1):
    # s-mers of at most 12 residues (60 bits) compare the same as int64
    if not (1 <= k <= 32 and 1 <= smer_len <= min(k, 12)):
        raise ValueError(f"{name}: need 1 <= k <= 32 and "
                         "1 <= smer_len <= min(k, 12)")
    if codes.dim() != 2 or lens.shape != (codes.shape[0],):
        raise ValueError(f"{name}: codes [B, L] and lens [B]")


def extract_aa_kmers_plain(codes: torch.Tensor, lens: torch.Tensor, *,
                           k: int = AA_K, syncmer: bool = False,
                           smer_len: int = 5):
    """Plain PyTorch version of kernel K12 on protein rows (any device):
    (value int64 [B, W], pos int32, valid bool), W = L - k + 1."""
    _check_aa_args("extract_aa_kmers", codes, lens, k, smer_len)
    B, L = codes.shape
    W = max(0, L - k + 1)
    dev = codes.device
    c = codes.to(torch.int64)
    ok = c <= 23
    value = torch.zeros((B, W), dtype=torch.int64, device=dev)
    valid = torch.ones((B, W), dtype=torch.bool, device=dev)
    for j in range(k):
        value = (value << 5) | c[:, j: j + W]
        valid = valid & ok[:, j: j + W]
    pos = torch.arange(W, dtype=torch.int32, device=dev).expand(B, W)
    valid = valid & (pos + k <= lens.to(torch.int64)[:, None])
    if syncmer and W:
        n_pos = L - smer_len + 1
        c0 = torch.where(ok, c, 0)
        smer = torch.zeros((B, n_pos), dtype=torch.int64, device=dev)
        for j in range(smer_len):
            smer = (smer << 5) | c0[:, j: j + n_pos]
        n_smer = k - smer_len + 1
        # torch.argmin returns the first minimum
        first = torch.argmin(torch.stack(
            [smer[:, t: t + W] for t in range(n_smer)], -1), dim=-1)
        valid = valid & ((first == 0) | (first == n_smer - 1))
    return value, pos.contiguous(), valid


def _translate_frames_plain(codes: torch.Tensor, lens: torch.Tensor):
    """The six frames of DNA rows, codon by codon: (amino acid [B, 6, A],
    -1 where the codon is invalid; valid [B, 6, A]; the frame's seq_end
    [B, 6], its last covered base)."""
    B, L = codes.shape
    A = max(0, (L - 2) // 3)
    dev = codes.device
    aa_tab = _tables(dev)[0].to(torch.int64)
    rc = torch.tensor(_RC8, dtype=torch.int64, device=dev)
    c = codes.to(torch.int64)
    lens = lens.to(torch.int64)
    used = torch.clamp(3 * torch.div(lens - 2, 3, rounding_mode="floor"),
                       min=0)
    idx = torch.arange(A, device=dev)

    def base(bi):
        v = torch.gather(c, 1, torch.clamp(bi, 0, max(L - 1, 0)))
        return torch.where((bi >= 0) & (bi < L), v, 7)

    aas, oks, ends = [], [], []
    for f in range(6):
        if f < 3:
            begin = torch.full((B,), f, dtype=torch.int64, device=dev)
            b1 = begin[:, None] + 3 * idx[None, :]
            c1, c2, c3 = base(b1), base(b1 + 1), base(b1 + 2)
        else:
            begin = torch.remainder(lens % 3 - (f - 3), 3)
            b1 = (begin + used - 1)[:, None] - 3 * idx[None, :]
            c1, c2, c3 = rc[base(b1)], rc[base(b1 - 1)], rc[base(b1 - 2)]
        ok = (c1 < 4) & (c2 < 4) & (c3 < 4) & (idx[None, :] < (used // 3)[:, None])
        ci = (c1 * 16 + c2 * 4 + c3) & 63
        aas.append(torch.where(ok, aa_tab[ci], -1))
        oks.append(ok)
        ends.append(begin + used - 1)
    return torch.stack(aas, 1), torch.stack(oks, 1), torch.stack(ends, 1)


def extract_aa_kmers_dna_plain(codes: torch.Tensor, lens: torch.Tensor, *,
                               k: int = AA_K):
    """Plain PyTorch version of kernel K12 on DNA rows (any device):
    (value int64 [B, 6, W], pos int32, valid bool), W = (L-2)//3 - k + 1."""
    _check_aa_args("extract_aa_kmers_dna", codes, lens, k)
    B, L = codes.shape
    A = max(0, (L - 2) // 3)
    W = max(0, A - k + 1)
    dev = codes.device
    if W == 0:
        z = torch.zeros((B, 6, 0), dtype=torch.int64, device=dev)
        return z, z.to(torch.int32), z.to(torch.bool)
    aa, ok, end = _translate_frames_plain(codes, lens)
    a = torch.clamp(aa, min=0)
    value = torch.zeros((B, 6, W), dtype=torch.int64, device=dev)
    valid = torch.ones((B, 6, W), dtype=torch.bool, device=dev)
    for j in range(k):
        value = (value << 5) | a[..., j: j + W]
        valid = valid & ok[..., j: j + W]
    p = torch.arange(W, device=dev)
    fwd = torch.arange(3, device=dev)[None, :, None] + 3 * p
    rev = end[:, 3:, None] - 3 * (p + k) + 1
    pos = torch.cat([fwd.expand(B, 3, W), rev], 1).to(torch.int32)
    return value, pos, valid


def _aa_outputs(shape, dev):
    return (torch.empty(shape, dtype=torch.int64, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.bool, device=dev))


def extract_aa_kmers(codes: torch.Tensor, lens: torch.Tensor, *,
                     k: int = AA_K, syncmer: bool = False,
                     smer_len: int = 5):
    """Kernel K12 wrapper, protein rows: CUDA tensors launch
    ``mtb_extract_aa_kmers`` (a warp per chunk of 288 windows of a row),
    CPU tensors take the plain version."""
    if codes.device.type == "cpu":
        return extract_aa_kmers_plain(codes, lens, k=k, syncmer=syncmer,
                                      smer_len=smer_len)
    _check_aa_args("extract_aa_kmers", codes, lens, k, smer_len)
    build.require_cuda("extract_aa_kmers", codes)
    build.require_cuda("extract_aa_kmers", lens, dtype=torch.int32)
    if codes.dtype != torch.uint8:
        raise TypeError("extract_aa_kmers: codes uint8 [B, L]")
    B, L = codes.shape
    W = max(0, L - k + 1)
    value, pos, valid = _aa_outputs((B, W), codes.device)
    if B == 0 or W == 0:
        return value, pos, valid
    rc = build.get_lib().mtb_extract_aa_kmers(
        codes.data_ptr(), lens.data_ptr(), B, L, W, k, int(bool(syncmer)),
        smer_len, value.data_ptr(), pos.data_ptr(), valid.data_ptr(),
        build.stream(codes.device))
    build.check(rc, "extract_aa_kmers")
    build.launches["extract_aa_kmers"] += 1
    return value, pos, valid


def extract_aa_kmers_dna(codes: torch.Tensor, lens: torch.Tensor, *,
                         k: int = AA_K):
    """Kernel K12 wrapper, DNA rows: CUDA tensors launch
    ``mtb_extract_aa_kmers_dna`` (the six frames translated and scanned in
    one pass: a warp per row of up to 484 bases and, where the batch's
    padded length allows longer rows, a CTA per chunk of each such row's
    windows), CPU tensors take the plain version."""
    if codes.device.type == "cpu":
        return extract_aa_kmers_dna_plain(codes, lens, k=k)
    _check_aa_args("extract_aa_kmers_dna", codes, lens, k)
    build.require_cuda("extract_aa_kmers_dna", codes)
    build.require_cuda("extract_aa_kmers_dna", lens, dtype=torch.int32)
    if codes.dtype != torch.uint8:
        raise TypeError("extract_aa_kmers_dna: codes uint8 [B, L]")
    B, L = codes.shape
    W = max(0, max(0, (L - 2) // 3) - k + 1)
    value, pos, valid = _aa_outputs((B, 6, W), codes.device)
    if B == 0 or W == 0:
        return value, pos, valid
    aa_tab = _tables(codes.device)[0]
    rc = build.get_lib().mtb_extract_aa_kmers_dna(
        codes.data_ptr(), lens.data_ptr(), B, L, W, k, aa_tab.data_ptr(),
        value.data_ptr(), pos.data_ptr(), valid.data_ptr(), value.numel(),
        build.stream(codes.device))
    build.check(rc, "extract_aa_kmers_dna")
    build.launches["extract_aa_kmers_dna"] += 1
    return value, pos, valid
