"""Reduced-alphabet codon distances: the plain PyTorch version of kernel
K11 (``metabuli_tpu.ops.hamming.hamming_all_reduced``,
`ReducedKmerMatcher.h:24-56`).

Under ``--reduced-aa 1`` a metamer's DNA part is 8 codon numbers of 4 bits
each (codon i at bits [4i, 4i+4)), and two same-AA metamers are scored
codon by codon through an 11x11 distance table, not by base-level XOR. The
packed 16-bit words keep the reference's quirk bit for bit: a distance of
up to 4 is ORed into a 2-bit lane with no masking, so a 4 at codon i
spills a bit into codon i+1's lane, and the word is cut to 16 bits at the
end.

K11 itself runs inside K2's reduced variant (``csrc/search_scan.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

# True per-codon distances over 4-bit codon numbers
# (`ReducedKmerMatcher.h:10-21`), padded to 16x16: codon numbers 11..15
# never occur and get 0.
REDUCED_SUM_LUT = np.zeros((16, 16), np.int32)
REDUCED_SUM_LUT[:11, :11] = np.array(
    [
        [0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3],
        [1, 0, 1, 1, 2, 1, 2, 2, 2, 2, 3],
        [1, 1, 0, 1, 2, 2, 1, 2, 2, 3, 2],
        [1, 1, 1, 0, 2, 2, 2, 1, 1, 3, 3],
        [1, 2, 2, 2, 0, 1, 1, 1, 2, 4, 4],
        [2, 1, 2, 2, 1, 0, 1, 2, 4, 4, 4],
        [2, 2, 1, 2, 1, 1, 0, 2, 4, 4, 4],
        [2, 2, 2, 1, 1, 2, 2, 0, 1, 4, 4],
        [2, 2, 2, 1, 2, 4, 4, 1, 0, 4, 4],
        [3, 2, 3, 3, 4, 4, 4, 4, 4, 0, 4],
        [3, 3, 2, 3, 4, 4, 4, 4, 4, 4, 0],
    ],
    dtype=np.int32,
)

# device -> the flat 256-entry table, uploaded once per device
_LUT: dict[torch.device, torch.Tensor] = {}


def reduced_lut(device) -> torch.Tensor:
    """``REDUCED_SUM_LUT`` flat, int32 [256] on ``device`` (row = query
    codon number, column = table codon number)."""
    device = torch.device(device)
    if device not in _LUT:
        _LUT[device] = torch.as_tensor(REDUCED_SUM_LUT.reshape(-1),
                                       device=device)
    return _LUT[device]


def hamming_all_reduced_plain(q_dna: torch.Tensor, t_dna: torch.Tensor):
    """(sum, packed_fwd, packed_rev) of two 32-bit DNA parts, elementwise
    and broadcast; any integer dtype (only the low 32 bits are read).

    sum        the total distance (0..32)
    packed_fwd codon i's distance ORed in at bit 2i, cut to 16 bits
    packed_rev codon i's distance ORed in at bit 2(7-i), cut to 16 bits"""
    lut = reduced_lut(q_dna.device)
    q = q_dna.to(torch.int64)
    t = t_dna.to(torch.int64)
    total = fwd = rev = None
    for i in range(8):
        d = lut[(((q >> (4 * i)) & 15) << 4) | ((t >> (4 * i)) & 15)]
        d = d.to(torch.int64)
        if total is None:
            total, fwd, rev = d, d << (2 * i), d << (2 * (7 - i))
        else:
            total = total + d
            fwd = fwd | (d << (2 * i))
            rev = rev | (d << (2 * (7 - i)))
    return total, fwd & 0xFFFF, rev & 0xFFFF
