"""The standard genetic code as Metabuli encodes it (``GeneticCode.h``):
bases A=0 C=1 T=2 G=3, a codon's index ``b0 * 16 + b1 * 4 + b2``, its
amino acid (20 = stop) and its 3-bit codon number within the amino acid.
A frozen copy of the port's ``ops/genetic_code.py`` tables."""

from __future__ import annotations

import numpy as np

AA_CODONS = {
    0: ["GCA", "GCC", "GCT", "GCG"], 1: ["CGA", "CGC", "CGT", "CGG", "AGG",
                                          "AGA"],
    2: ["AAT", "AAC"], 3: ["GAT", "GAC"], 4: ["TGT", "TGC"],
    5: ["CAA", "CAG"], 6: ["GAA", "GAG"], 7: ["GGA", "GGC", "GGT", "GGG"],
    8: ["CAT", "CAC"], 9: ["ATT", "ATC", "ATA"],
    10: ["TTA", "TTG", "CTA", "CTC", "CTT", "CTG"], 11: ["AAA", "AAG"],
    12: ["ATG"], 13: ["TTT", "TTC"], 14: ["CCA", "CCC", "CCT", "CCG"],
    15: ["TCA", "TCC", "TCT", "TCG", "AGT", "AGC"],
    16: ["ACA", "ACC", "ACT", "ACG"], 17: ["TGG"], 18: ["TAT", "TAC"],
    19: ["GTA", "GTC", "GTT", "GTG"], 20: ["TAA", "TGA", "TAG"],
}
# codon numbers beyond the third-base rule
NUM_OVERRIDES = {"AGG": 4, "AGA": 5, "TTG": 4, "TTA": 5, "AGT": 6,
                 "AGC": 7, "TGA": 5}
BASE = {"A": 0, "C": 1, "T": 2, "G": 3}


def _index(codon: str) -> int:
    return BASE[codon[0]] * 16 + BASE[codon[1]] * 4 + BASE[codon[2]]


def tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(amino acid [64], codon number [64], codon index [21 * 8]: the
    codon of an (amino acid, codon number) pair)."""
    aa = np.full(64, -1, np.int64)
    num = np.full(64, -1, np.int64)
    for a, codons in AA_CODONS.items():
        for c in codons:
            aa[_index(c)] = a
    for c1 in "ACTG":
        for c2 in "ACTG":
            for c3 in "ACTG":
                num[_index(c1 + c2 + c3)] = BASE[c3]
    for c, v in NUM_OVERRIDES.items():
        num[_index(c)] = v
    assert (aa >= 0).all() and (num >= 0).all()
    exp = np.zeros(21 * 8, np.int64)
    for ci in range(64):
        exp[aa[ci] * 8 + num[ci]] = ci
    return aa, num, exp


# raw character -> base code (A=0 C=1 T=2 G=3, 7 for anything else); the
# benchmark's reads hold only ACGT
CHAR_CODE = np.full(256, 7, np.uint8)
for _c, _v in BASE.items():
    CHAR_CODE[ord(_c)] = _v
    CHAR_CODE[ord(_c.lower())] = _v
