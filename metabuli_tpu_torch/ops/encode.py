"""6-frame metamer extraction (kernel K1) and its plain PyTorch version.

Semantics of ``metabuli_tpu.ops.encode.extract_metamers`` for
``kmer_format`` 2 (`KmerScanner.h:49-118`, `SyncmerScanner.h:9-103`,
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
    canonical s-mer sequence sits at offset 0 or 8-s.

Invalid windows carry value = dna48 = 0 (the reference package leaves
garbage there; only valid windows are ever read).
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
                           reduced: bool = False) -> Metamers:
    """Plain PyTorch version of kernel K1 (any device)."""
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
    for j in range(K):
        # codon feeding bit slot j (most significant first): forward frames
        # take codon w+j, reverse frames codon w+7-j
        o = K - 1 - j
        a_j = torch.cat([aa[:, :3, j: j + W], aa[:, 3:, o: o + W]], 1)
        n_j = torch.cat([num[:, :3, j: j + W], num[:, 3:, o: o + W]], 1)
        c_j = torch.cat([c6[:, :3, j: j + W], c6[:, 3:, o: o + W]], 1)
        aa_part = (aa_part << bits_aa) | torch.clamp(a_j, min=0)
        dna_part = (dna_part << bits_codon) | n_j
        dna48 = (dna48 << 6) | c_j
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
                     reduced: bool = False) -> Metamers:
    """Kernel K1 wrapper: CUDA tensors launch ``mtb_extract_metamers``, or
    ``mtb_extract_metamers_reduced`` for the reduced alphabet (a CTA per
    chunk of a row's windows; the kernel writes every output element);
    CPU tensors take the plain version."""
    if codes.device.type == "cpu":
        return extract_metamers_plain(codes, lens, syncmer=syncmer,
                                      smer_len=smer_len, reduced=reduced)
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
            None if reduced else dna48.data_ptr(), build.stream(dev))
    build.check(rc, "extract_metamers")
    # both alphabets count as K1
    build.launches["extract_metamers"] += 1
    return Metamers(value, pos, valid, dna48)
