"""--cds-info support: coding-region extraction without gene prediction.

Re-provides `IndexCreator::loadCdsInfo` (`/root/reference/src/commons/IndexCreator.cpp:1275-1380`)
and `SeqIterator::devideToCdsAndNonCds` (`/root/reference/src/commons/SeqIterator.cpp:180-250`):
parse NCBI ``*_cds_from_genomic.fna`` headers ([protein_id=..], [location=..]
with complement()/join(), pseudo/hypothetical skipped), then split each
genome into CDS blocks (boundaries extended 7 codons into the flanks,
reverse-complemented when on the minus strand) and non-CDS remainders.
CDS blocks are extracted in their single coding frame; this is the exact
alternative to the Prodigal pipeline for assemblies with annotation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..io import fasta

# SeqIterator's member kmerLen is 12 (SeqIterator.h:46) — a leftover from
# the 12-mer AA formats — so CDS boundaries extend (12-1)=11 codons into the
# flanks (SeqIterator.cpp:195-206), NOT the metamer length 8.
KMER_LEN = 12
_RC = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


@dataclass
class CdsInfo:
    protein_id: str
    is_complement: bool = False
    loc: list = field(default_factory=list)  # [(begin, end)] 1-based inclusive


def _parse_location(value: str, info: CdsInfo):
    value = value.strip()
    if value.startswith("complement(") and value.endswith(")"):
        info.is_complement = True
        value = value[len("complement(") : -1]
    if value.startswith("join(") and value.endswith(")"):
        value = value[len("join(") : -1]
    for part in value.split(","):
        part = part.strip().lstrip("<").replace(">", "")
        if ".." in part:
            a, b = part.split("..", 1)
            info.loc.append((int(a.lstrip("<")), int(b.lstrip(">"))))
        elif part:
            info.loc.append((int(part), int(part)))


def parse_cds_file(path: str, cds_map: dict[str, list[CdsInfo]]):
    """Accumulate accession -> CDS list from one cds_from_genomic FASTA.

    Ordered scan faithful to `IndexCreator::loadCdsInfo`
    (`IndexCreator.cpp:1275-1380`), including its quirks:
      - accession = name[find('|')+1 : find('.')+2] (one version digit);
      - bracket features are scanned starting at the '.'-index of the NAME
        reused as an offset into the comment, so a feature inside the first
        ~10 chars of the comment is silently skipped (real NCBI headers
        lead with [locus_tag=...], which absorbs the skip);
      - features are processed in order; pseudo / hypothetical-protein
        abort the record (keeping an already-emplaced location-less entry);
      - parsing stops after [location=...]; [frame=N] shifts the first
        (plus) or last (minus) boundary by N-1.
    """
    for rec in fasta.read_records(path):
        name = rec.name
        start = name.find("|") + 1
        dot = name.find(".", start)
        accession = name[start:dot + 2] if dot >= 0 else name
        comment = rec.comment
        end = max(dot, 0)
        frame = 1
        cur = None
        while True:
            s = comment.find("[", end) + 1
            if s == 0:
                break
            end = comment.find("]", s)
            if end < 0:
                break
            eq = comment.find("=", s)
            if eq < 0 or eq > end:
                continue
            feature = comment[s:eq]
            value = comment[eq + 1:end]
            if feature == "pseudo":
                break
            if feature == "protein" and value == "hypothetical protein":
                break
            if feature == "frame":
                frame = int(value)
            elif feature == "protein_id":
                cur = CdsInfo(protein_id=value)
                cds_map.setdefault(accession, []).append(cur)
            elif feature == "location":
                if cur is None:
                    # the reference dereferences back() of an empty vector
                    # here (UB/crash); treat as malformed input instead
                    raise ValueError(
                        f"CDS entry with [location] before [protein_id]: "
                        f"{name} in {path}")
                _parse_location(value, cur)
                if frame != 1 and cur.loc:
                    if not cur.is_complement:
                        b, e = cur.loc[0]
                        cur.loc[0] = (b + frame - 1, e)
                    else:
                        b, e = cur.loc[-1]
                        cur.loc[-1] = (b, e - (frame - 1))
                break


def load_cds_info(cds_list_file: str) -> dict[str, list[CdsInfo]]:
    cds_map: dict[str, list[CdsInfo]] = {}
    with open(cds_list_file) as fh:
        for line in fh:
            path = line.strip()
            if path:
                parse_cds_file(path, cds_map)
    return cds_map


def divide_cds_noncds(
    seq: bytes, cds_list: list[CdsInfo]
) -> tuple[list[bytes], list[bytes]]:
    """(cds blocks, non-cds blocks). CDS boundaries extended 7 codons into
    the flanks; minus-strand CDS reverse-complemented (so a single forward
    frame-0 scan covers the coding frame).

    Reference quirks replicated (`SeqIterator::devideToCdsAndNonCds`,
    SeqIterator.cpp:180-245, and the extraction call sites
    `IndexCreator.cpp:1105-1127`):
      - non-CDS blocks are kept only when longer than 32 bases;
      - the reference extracts non-CDS block i over a window of
        length(cds[i]) — the CDS vector's element — instead of the block's
        own length (`IndexCreator.cpp:1124`). When the CDS is longer than
        the gap this makes the scanner read PAST the block's bytes
        (AddressSanitizer-verified heap-buffer-overflow, so those extra
        k-mers encode uninitialized memory and are irreproducible by
        design); when shorter, the gap is silently truncated. We replicate
        the deterministic part: non-CDS block i is truncated to
        min(len(block), len(cds[i])), and blocks with no corresponding CDS
        entry keep their own length (the reference reads cds[i] out of the
        vector's bounds there — also UB).
    """
    n = len(seq)
    cds_out: list[bytes] = []
    covered = bytearray(n)
    for info in cds_list:
        parts = []
        for j, (b1, e1) in enumerate(info.loc):
            begin = b1 - 1
            end = e1 - 1
            if j == 0:
                k = 0
                while k < KMER_LEN - 1 and begin >= 3:
                    begin -= 3
                    k += 1
            if j == len(info.loc) - 1:
                k = 0
                while k < KMER_LEN - 1 and end + 3 < n:
                    end += 3
                    k += 1
            parts.append(seq[begin : end + 1])
        block = b"".join(parts)
        if info.is_complement:
            block = block.translate(_RC)[::-1]
        cds_out.append(block)
        for b1, e1 in info.loc:
            for k in range(b1 - 1, min(e1, n)):
                covered[k] = 1
    non_cds: list[bytes] = []
    i = 0
    while i < n:
        if covered[i]:
            i += 1
            continue
        j = i
        while j < n and not covered[j]:
            j += 1
        if j - i > 32:
            k = len(non_cds)
            block = seq[i:j]
            if k < len(cds_out):
                block = block[: len(cds_out[k])]
            non_cds.append(block)
        i = j
    return cds_out, non_cds
