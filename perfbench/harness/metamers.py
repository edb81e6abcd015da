"""Six-frame metamers of DNA rows, in plain PyTorch: the benchmark's own
extraction, used to make the DB's table and, in the reference, the
queries' k-mers.

Metabuli's scheme (``KmerScanner.h``), standard alphabet, k-mer format
2: a row of ``len`` bases has ``(len - 2) // 3`` codons a frame; forward
frame f (0..2) starts at base f, reverse frame f (3..5) at ``(len % 3 -
(f - 3)) mod 3`` and reads each base triple as its reverse complement.
Window w of a frame holds 8 codons and is valid iff they all are; a
forward window packs codon w most significant, a reverse window codon
w + 7 (descending genome order). value = the 8 amino acids (5 bits each)
<< 24 | the 8 codon numbers (3 bits each); dna48 = the 8 codons' raw
bases, 6 bits each, in the same order; pos = begin + 3w.
"""

from __future__ import annotations

import numpy as np
import torch

from . import code

K = 8


def to_codes(seqs: np.ndarray) -> np.ndarray:
    """ASCII bases (uint8 [B, L]) -> base codes."""
    return code.CHAR_CODE[seqs]


class Extractor:
    """The code tables on one device."""

    def __init__(self, device):
        aa, num, exp = code.tables()
        self.device = torch.device(device)
        self.aa = torch.as_tensor(aa, device=self.device)
        self.num = torch.as_tensor(num, device=self.device)
        self.exp = torch.as_tensor(exp, device=self.device)

    def extract(self, codes: torch.Tensor, lens: torch.Tensor):
        """(value, dna48, pos, valid), each [B, 6, W], of the rows
        ``codes`` (uint8 [B, L], base codes) of lengths ``lens`` [B]."""
        B, L = codes.shape
        A = max(0, (L - 2) // 3)
        W = max(0, A - K + 1)
        dev = codes.device
        c = codes.to(torch.int64)
        lens = lens.to(device=dev, dtype=torch.int64)
        n_codons = torch.clamp(torch.div(lens - 2, 3, rounding_mode="floor"),
                               min=0)
        k = torch.arange(A, device=dev)
        aas, nums, c6s, oks, begins = [], [], [], [], []
        for f in range(6):
            begin = (torch.full((B,), f, device=dev) if f < 3
                     else torch.remainder(lens % 3 - (f - 3), 3))
            p = begin[:, None] + 3 * k[None, :]
            pc = torch.clamp(p, max=max(L - 3, 0))
            b0, b1, b2 = (torch.gather(c, 1, pc + i) for i in range(3))
            ok = ((p + 2 < L) & (b0 < 4) & (b1 < 4) & (b2 < 4)
                  & (k[None, :] < n_codons[:, None]))
            c6 = ((b0 << 4) | (b1 << 2) | b2 if f < 3 else
                  ((b2 ^ 2) << 4) | ((b1 ^ 2) << 2) | (b0 ^ 2))
            c6 = torch.where(ok, c6 & 63, 0)
            aas.append(self.aa[c6])
            nums.append(self.num[c6])
            c6s.append(c6)
            oks.append(ok)
            begins.append(begin)
        aa, num, c6, ok = (torch.stack(x, 1) for x in (aas, nums, c6s, oks))
        value = torch.zeros((B, 6, W), dtype=torch.int64, device=dev)
        codons = torch.zeros_like(value)
        dna48 = torch.zeros_like(value)
        valid = torch.ones((B, 6, W), dtype=torch.bool, device=dev)
        for j in range(K):
            o = K - 1 - j  # a reverse frame's slot j holds codon w + 7 - j
            sl = lambda x: torch.cat([x[:, :3, j:j + W], x[:, 3:, o:o + W]], 1)
            value = (value << 5) | sl(aa)
            codons = (codons << 3) | sl(num)
            dna48 = (dna48 << 6) | sl(c6)
            valid &= ok[:, :, j:j + W]
        value = torch.where(valid, (value << 24) | codons, 0)
        dna48 = torch.where(valid, dna48, 0)
        pos = (torch.stack(begins, 1)[:, :, None]
               + 3 * torch.arange(W, device=dev)[None, None, :])
        return value, dna48, pos, valid

    def row_dna48(self, value: torch.Tensor) -> torch.Tensor:
        """dna48 of table rows from their values: each slot's (amino acid,
        codon number) names one codon."""
        d48 = torch.zeros_like(value)
        for j in range(K):
            a = (value >> (24 + 5 * (K - 1 - j))) & 31
            n = (value >> (3 * (K - 1 - j))) & 7
            d48 = (d48 << 6) | self.exp[torch.clamp(a, max=20) * 8 + n]
        return d48
