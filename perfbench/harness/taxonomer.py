"""Per-read assignment from a read's sorted matches: a frozen copy of the
port's Python taxonomer (``classify/taxonomer.py``, the host port of
Metabuli's ``Taxonomer.cpp``), cut to the paths the benchmark's
configurations take (no eukaryotes, no EM, no accession level, no
syncmers, k-mer format 2, the standard alphabet).

``num`` is the precision scores are kept in: ``np.float32``, as Metabuli's
C++ ``float``, or ``bf16`` for the control."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

F32 = np.float32


def bf16_array(x) -> np.ndarray:
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float32."""
    b = np.atleast_1d(np.asarray(x, np.float32)).view(np.uint32).astype(
        np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def bf16(x) -> np.float32:
    """A scalar rounded to bfloat16, as float32."""
    return bf16_array(x)[0]


@dataclass
class Params:
    seq_mode: int = 2
    min_score: float = 0.0
    min_sp_score: float = 0.0
    min_cons_cnt: int = 4
    tie_ratio: float = 0.95

    @property
    def denominator(self) -> int:
        return 100 if self.seq_mode in (1, 2) else 1000


SCORE_LUT = np.array([3.0, 1.5, 1.0, 0.5], np.float32)
DNA_SHIFT = 3       # Taxonomer.cpp:34-42 without syncmers
BITS_PER_CODON = 3
TOTAL_DNA_BITS = 24
MAX_CODON_SHIFT = 1


@dataclass
class Result:
    is_classified: bool = False
    taxid: int = 0
    score: float = 0.0
    tax_counts: dict = field(default_factory=dict)


class _Path:
    __slots__ = ("start", "end", "score", "hamming", "depth", "start_idx",
                 "end_idx")

    def __init__(self, start, end, score, hamming, depth, start_idx, end_idx):
        self.start, self.end, self.score = start, end, score
        self.hamming, self.depth = hamming, depth
        self.start_idx, self.end_idx = start_idx, end_idx


class Taxonomer:
    def __init__(self, params: Params, taxonomy, num=F32):
        self.p = params
        self.tax = taxonomy
        self.num = num

    # per-codon scores (Match.h:32-44): 3 if the codon matches, else
    # 2 - 0.5 h
    def _part_score(self, h16: int, idx) -> np.float32:
        s = F32(0)
        for i in idx:
            h = (h16 >> (2 * i)) & 3
            s = self.num(s + (F32(3.0) if h == 0
                              else F32(2.0) - F32(0.5) * F32(h)))
        return s

    def _scores(self, h16: np.ndarray) -> np.ndarray:
        """Match::getScore of each match, the codons summed in order."""
        total = np.zeros(len(h16), np.float32)
        for i in range(8):
            total = total + SCORE_LUT[(h16 >> (2 * i)) & 3]
            if self.num is bf16:
                total = bf16_array(total)
        return total

    @staticmethod
    def _part_hamming(h16: int, idx) -> int:
        return sum((h16 >> (2 * i)) & 3 for i in idx)

    def classify(self, m: dict, read_len: int) -> Result:
        """chooseBestTaxon (``Taxonomer.cpp:130-202``) for one read."""
        res = Result()
        score, lca_flag, best_taxid, best_range = self._best_species(
            m, read_len)
        if score == 0 or score < self.p.min_score:
            res.score = float(score)
            return res
        res.is_classified = True
        res.score = float(score)
        if lca_flag:
            res.taxid = best_taxid
            return res
        res.tax_counts = self._filter_redundant(m, best_range)
        if score < self.p.min_sp_score:
            res.taxid = self.tax.parent[self.tax.species_of(best_taxid)]
            return res
        res.taxid = self._lower_rank(res.tax_counts, best_taxid, read_len)
        return res

    def _best_species(self, m, read_len):
        """getBestSpeciesMatches (``Taxonomer.cpp:316-407``)."""
        species, frame = m["species"], m["frame"]
        n = len(species)
        sp2score = []
        best_sp_score = F32(0)
        best_range = (0, 0)
        meaningful = 0
        i = 0
        while i < n:
            cur_sp = species[i]
            sp_start = i
            paths: list[_Path] = []
            while i < n and species[i] == cur_sp:
                cur_frame = frame[i]
                f_start = i
                while i < n and species[i] == cur_sp and frame[i] == cur_frame:
                    i += 1
                if i - f_start > 1:
                    self._match_paths(m, f_start, i, paths)
            if paths:
                score = min(self._combine_paths(m, paths, read_len), F32(1.0))
                if score < self.p.min_score:
                    continue
                sp2score.append((int(cur_sp), score))
                if score > 0:
                    meaningful += 1
                if score > best_sp_score:
                    best_sp_score = score
                    best_range = (sp_start, i)
        if meaningful == 0:
            return F32(0), False, 0, (0, 0)
        max_species = []
        total = F32(0)
        for sp, sc in sp2score:
            if sc >= self.num(best_sp_score * F32(self.p.tie_ratio)):
                max_species.append(sp)
                total = self.num(total + sc)
        if len(max_species) > 1:
            return (self.num(total / len(max_species)), True,
                    self.tax.lca(max_species), best_range)
        return total, False, max_species[0], best_range

    def _match_paths(self, m, start, end, out_paths: list):
        """getMatchPaths (``Taxonomer.cpp:487-648``)."""
        pos, dna, h16, ham = m["pos"], m["dna"], m["h16"], m["hamming"]
        forward = m["frame"][start] < 3
        scores = self._scores(h16[start:end].astype(np.int64))
        local = [_Path(int(pos[j]), int(pos[j]) + 23, scores[j - start],
                       int(ham[j]), 1, j, j) for j in range(start, end)]
        connected = [False] * (end - start)
        i = start
        cur_pos = int(pos[start])
        cur_s = i
        while i < end and int(pos[i]) == cur_pos:
            i += 1
        cur_e = i
        while i < end:
            next_pos = int(pos[i])
            nxt_s = i
            while i < end and int(pos[i]) == next_pos:
                i += 1
            nxt_e = i
            shift = (next_pos - cur_pos) // 3
            if 0 < shift <= MAX_CODON_SHIFT:
                mask = (1 << (TOTAL_DNA_BITS - BITS_PER_CODON * shift)) - 1
                for nj in range(nxt_s, nxt_e):
                    inc = self._part_score(int(h16[nj]), range(shift))
                    best = None
                    best_score = F32(0)
                    for cj in range(cur_s, cur_e):
                        a, b = (cj, nj) if forward else (nj, cj)
                        da = int(dna[a]) & 0xFFFFFFFF
                        db = int(dna[b]) & 0xFFFFFFFF
                        if (da & mask) == (db >> (BITS_PER_CODON * shift)):
                            connected[cj - start] = True
                            lp = local[cj - start]
                            if lp.score > best_score:
                                best, best_score = lp, lp.score
                    if best is not None:
                        ln = local[nj - start]
                        ln.start = best.start
                        ln.score = self.num(best.score + inc)
                        ln.hamming = best.hamming + self._part_hamming(
                            int(h16[nj]), range(shift))
                        ln.depth = best.depth + shift
                        ln.start_idx = best.start_idx
            for cj in range(cur_s, cur_e):
                if (not connected[cj - start]
                        and local[cj - start].depth >= self.p.min_cons_cnt):
                    out_paths.append(local[cj - start])
            if i == end:
                for nj in range(nxt_s, nxt_e):
                    if local[nj - start].depth >= self.p.min_cons_cnt:
                        out_paths.append(local[nj - start])
            cur_s, cur_e, cur_pos = nxt_s, nxt_e, next_pos

    def _combine_paths(self, m, paths: list, read_len: int) -> np.float32:
        """combineMatchPaths (``Taxonomer.cpp:410-468``) with
        trimMatchPath (``:475-485``)."""
        h16 = m["h16"]
        paths.sort(key=lambda a: (-a.score, a.hamming, -a.start))
        combined: list[_Path] = []
        total = F32(0)
        for path in paths:
            overlapped = False
            for comb in combined:
                if path.end < comb.start or comb.end < path.start:
                    continue
                ov = min(path.end, comb.end) - max(path.start, comb.start) + 1
                if ov == path.end - path.start + 1:
                    overlapped = True
                    break
                if ov < 24:
                    if path.start < comb.start:
                        path.end = comb.start - 1
                        idx, h = range(ov // 3), int(h16[path.end_idx])
                    else:
                        path.start = comb.end + 1
                        idx = [7 - i for i in range(ov // 3)]
                        h = int(h16[path.start_idx])
                    path.hamming = max(0, path.hamming
                                       - self._part_hamming(h, idx))
                    path.score = self.num(path.score
                                          - self._part_score(h, idx)
                                          - F32(ov % 3))
                    continue
                overlapped = True
                break
            if not overlapped:
                combined.append(path)
                total = self.num(total + path.score)
        return self.num(total / F32(read_len))

    def _filter_redundant(self, m, best_range) -> dict:
        """filterRedundantMatches (``Taxonomer.cpp:205-241``)."""
        lo, hi = best_range
        pos, ham, taxid = m["pos"], m["hamming"], m["taxid"]
        best_tax: dict[int, int] = {}
        best_ham: dict[int, int] = {}
        for j in range(lo, hi):
            q = int(pos[j]) // DNA_SHIFT
            h = int(ham[j])
            if q not in best_tax or h < best_ham[q]:
                best_tax[q], best_ham[q] = int(taxid[j]), h
            elif h == best_ham[q]:
                best_tax[q] = self.tax.lca([best_tax[q], int(taxid[j])])
        counts: dict[int, int] = {}
        for t in best_tax.values():
            counts[t] = counts.get(t, 0) + 1
        return counts

    def _lower_rank(self, tax_cnt: dict, species: int, read_len: int) -> int:
        """lowerRankClassification (``Taxonomer.cpp:252-314``)."""
        threshold = (read_len - 1) // self.p.denominator
        clade: dict[int, dict] = {}
        for t, c in tax_cnt.items():
            node = int(t)
            e = clade.setdefault(node, {"clade": 0, "children": []})
            e["clade"] += c
            guard = 0
            while node != species and guard < 64:
                pnode = int(self.tax.parent[node])
                pe = clade.setdefault(pnode, {"clade": 0, "children": []})
                if node not in pe["children"]:
                    pe["children"].append(node)
                pe["clade"] += c
                if pnode == node:
                    break
                node = pnode
                guard += 1
        if species not in clade:
            return int(species)
        return self._bfs(clade, int(species), threshold)

    def _bfs(self, clade: dict, root: int, max_cnt: int) -> int:
        entry = clade.get(root)
        if entry is None or not entry["children"]:
            return root
        best_children = []
        cur_max = max_cnt
        for ch in entry["children"]:
            cnt = clade.get(ch, {"clade": 0})["clade"]
            if cnt > cur_max:
                best_children, cur_max = [ch], cnt
            elif cnt == cur_max:
                best_children.append(ch)
        if len(best_children) == 1:
            return self._bfs(clade, best_children[0], max_cnt)
        return root
