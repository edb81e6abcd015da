"""One general generator of read samples from a traffic mix's
parameters (``perfbench/traffic/<name>.json``) and the run's seed.

Parameters:
  reads         reads (pairs) a sample
  read_len      bases a read (a mate), where lengths are not drawn
  paired        pairs: a fragment of ``fragment_len`` bases, mate 1 its
                first ``read_len`` bases, mate 2 the reverse complement
                of its last (tools/benchmark.py's paired sampler, a port
                of upstream makeBenchmarkSet.cpp)
  fragment_len  bases of a pair's fragment
  random_share  share of reads (pairs) of uniform random DNA, organisms
                absent from the DB
  reverse_share share of the other reads taken from the reverse strand
  sub_rate      per-base substitution rate (each hit base becomes another)
  samples       distinct samples a run writes and classifies in turn
  check_reads   reads of each sample whose lines the reference checks

Optional, single reads only (``paired`` false); a mix with none of them
is made as above, drawing nothing more:
  len_mean, len_sd   each read's length drawn from a lognormal of this
                     mean and standard deviation, rounded and clamped to
  min_len, max_len   this range (without them, every read is
                     ``read_len`` long)
  length_seed        the seed of the lengths: they are the mix's, the
                     same in every sample of every run
  ins_rate, del_rate per-base insertion and deletion rates

A read with insertions or deletions is made from a source window longer
than the read: its deletions (each base at ``del_rate``), then its
substitutions (each kept base), then an insertion of a uniform base after
each kept base at ``ins_rate``, and cut to its length. A random read is
uniform DNA of its length; a reverse-strand read is the reverse
complement of its window. Every read comes out at exactly its length.

Every seed gives the same sizes: exactly ``reads`` reads of the same
lengths, the same count of random and reversed reads, genomes taken in
turn; the seed draws which reads, where and what."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")
RAGGED = ("len_mean", "len_sd", "min_len", "max_len", "length_seed",
          "ins_rate", "del_rate")


class Mate(NamedTuple):
    """One mate of some reads: their ASCII bases, one read after
    another, and each read's length."""

    bases: np.ndarray  # uint8
    lens: np.ndarray   # int64 [reads]

    def starts(self) -> np.ndarray:
        return np.cumsum(self.lens) - self.lens

    def part(self, a: int, b: int) -> "Mate":
        """Reads ``[a, b)``."""
        s = self.starts()
        end = int(s[b - 1] + self.lens[b - 1]) if b > a else int(s[a])
        return Mate(self.bases[int(s[a]):end], self.lens[a:b])

    def take(self, idx) -> "Mate":
        """Reads ``idx``, in that order."""
        s, ln = self.starts(), self.lens
        return Mate(np.concatenate([self.bases[s[i]:s[i] + ln[i]]
                                    for i in idx] or [self.bases[:0]]),
                    ln[np.asarray(idx, np.int64)])


class Sample:
    """One sample's reads: a ``Mate`` each for mate 1 (and mate 2)."""

    def __init__(self, mates: list[Mate]):
        self.mates = mates

    @property
    def n(self) -> int:
        return len(self.mates[0].lens)

    def names(self) -> list[str]:
        return [f"r{i}" for i in range(self.n)]

    def write(self, d: str, tag: str) -> list[str]:
        """FASTQ files of the mates under ``d``, each record its read's
        own length; their paths."""
        paths = []
        names = [f"@r{i}\n".encode() for i in range(self.n)]
        for m, mate in enumerate(self.mates):
            raw = mate.bases.tobytes()
            qual = b"I" * int(mate.lens.max(initial=0))
            path = os.path.join(d, f"{tag}_{m + 1}.fq")
            with open(path, "wb") as fh:
                fh.writelines(n + raw[a:a + ln] + b"\n+\n" + qual[:ln] + b"\n"
                              for n, a, ln in zip(names,
                                                  mate.starts().tolist(),
                                                  mate.lens.tolist()))
            paths.append(path)
        return paths


def _substitute(bases: np.ndarray, hit, rng) -> None:
    """In place: each base where ``hit`` becomes another base."""
    idx = np.searchsorted(ACGT, bases[hit])
    bases[hit] = ACGT[(idx + rng.integers(1, 4, size=idx.size)) % 4]


def revcomp(seqs: np.ndarray) -> np.ndarray:
    return COMP[seqs[:, ::-1]]


def lengths(mix: dict) -> np.ndarray:
    """Each read's length: ``read_len``, or drawn from the mix's own
    ``length_seed``, the same for every run seed and sample."""
    n = mix["reads"]
    if "len_mean" not in mix:
        return np.full(n, mix["read_len"], np.int64)
    mean, sd = float(mix["len_mean"]), float(mix["len_sd"])
    s2 = np.log1p((sd / mean) ** 2)
    x = np.random.default_rng(mix["length_seed"]).lognormal(
        np.log(mean) - s2 / 2, np.sqrt(s2), n)
    return np.clip(np.rint(x), mix["min_len"], mix["max_len"]).astype(
        np.int64)


def events(rng, n: int, p: float) -> np.ndarray:
    """Sorted positions in ``[0, n)`` where trials of rate ``p`` hit:
    geometric gaps, so the draws scale with the hits, not with ``n``."""
    if p <= 0 or n <= 0:
        return np.zeros(0, np.int64)
    out, at = [], -1
    while True:
        pos = at + np.cumsum(rng.geometric(
            p, size=int(n * p + 4 * np.sqrt(n * p)) + 16))
        out.append(pos[pos < n])
        if pos[-1] >= n:
            return np.concatenate(out)
        at = int(pos[-1])


def window_lens(lens: np.ndarray, del_rate: float) -> np.ndarray:
    """Source bases a read of each length is drawn from: enough to outlast
    its deletions but on a vanishing share of reads (their mean and 6
    standard deviations, and 8 more); ``edit`` undoes the excess there."""
    if del_rate <= 0:
        return lens.copy()
    d = del_rate * lens
    return lens + np.ceil(d + 6 * np.sqrt(d * (1 - del_rate))).astype(
        np.int64) + 8


def edit(src: np.ndarray, win: np.ndarray, lens: np.ndarray, mix: dict,
         rng) -> np.ndarray:
    """Reads of ``lens`` from source windows (``src``, one after another,
    of ``win`` bases each): each base deleted at ``del_rate``, each kept
    base substituted at ``sub_rate``, a uniform base inserted after each
    kept base at ``ins_rate``, each read cut to its length. Their bases,
    one read after another.

    Only what survives the cut is made: the insertions are drawn first,
    over each read's first ``lens`` kept bases, and those past the cut
    dropped; a read then takes ``need`` kept bases, so only the deletions
    before its ``need``-th kept base apply."""
    n = lens.size
    ends = np.cumsum(lens)
    ins = events(rng, int(ends[-1]) if n else 0, mix.get("ins_rate", 0.0))
    r = np.searchsorted(ends, ins, side="right")
    q = np.arange(ins.size) - np.searchsorted(ins, ends - lens)[r]
    live = ins - (ends - lens)[r] + 1 + q < lens[r]
    ins, r = ins[live], r[live]
    need = lens - np.bincount(r, minlength=n)
    bounds = np.concatenate([[0], np.cumsum(win)])
    dels = events(rng, src.size, mix.get("del_rate", 0.0))
    at = np.searchsorted(dels, bounds)
    seg = np.repeat(np.arange(n), np.diff(at))
    # kept bases before each deletion in its window
    before = dels - bounds[seg] - (np.arange(dels.size) - at[seg])
    used = before < need[seg]
    m = np.bincount(seg[used], minlength=n)
    for i in np.nonzero(need + m > win)[0]:
        # a window too short for its deletions: only its first apply
        m[i] = win[i] - need[i]
        used[at[i]:at[i + 1]] = np.arange(at[i + 1] - at[i]) < m[i]
    keep = np.ones(src.size, bool)
    keep[dels[used]] = False
    for a, b in zip((bounds[:-1] + need + m).tolist(), bounds[1:].tolist()):
        keep[a:b] = False
    out = src[keep]
    if mix["sub_rate"]:
        _substitute(out, events(rng, out.size, mix["sub_rate"]), rng)
    if ins.size:
        # after kept base j of read r: kept bases of reads before r, j + 1
        at_kept = (np.cumsum(need) - need)[r] + ins - (ends - lens)[r] + 1
        out = np.insert(out, at_kept, ACGT[rng.integers(0, 4, ins.size)])
    return out


def _ragged(mix: dict, genomes, rng) -> Sample:
    """A sample of single reads of the mix's lengths, with indels."""
    if mix.get("paired"):
        raise ValueError("drawn lengths and indels are for single reads; "
                         "the mix is paired")
    n = mix["reads"]
    lens = lengths(mix)
    win = window_lens(lens, mix.get("del_rate", 0.0))
    n_rand = int(round(n * mix["random_share"]))
    is_rand = np.zeros(n, bool)
    is_rand[rng.permutation(n)[:n_rand]] = True
    real = np.nonzero(~is_rand)[0]
    glens = np.array([len(g) for g, _ in genomes], np.int64)
    offs = np.concatenate([[0], np.cumsum(glens)[:-1]])
    gi = np.arange(real.size) % len(genomes)
    if np.any(win[real] > glens[gi]):
        raise ValueError(f"a read's source window ({int(win.max())} bases) "
                         f"is longer than its genome ({int(glens.min())})")
    rev = np.zeros(n, bool)
    rev[real[rng.permutation(real.size)[:int(round(
        real.size * mix["reverse_share"]))]]] = True
    start = np.zeros(n, np.int64)
    start[real] = offs[gi] + (rng.random(real.size)
                              * (glens[gi] - win[real] + 1)).astype(np.int64)
    # a random read's window: uniform DNA, one after another in a pool
    start[is_rand] = np.cumsum(win[is_rand]) - win[is_rand]
    pool = ACGT[rng.integers(0, 4, int(win[is_rand].sum()))]
    buf = np.frombuffer(b"".join(g for g, _ in genomes), np.uint8)
    src = np.concatenate(
        [(pool if x else buf)[s:s + w] if not r else COMP[buf[s:s + w][::-1]]
         for s, w, r, x in zip(start.tolist(), win.tolist(), rev.tolist(),
                               is_rand.tolist())] or [buf[:0]])
    return Sample([Mate(edit(src, win, lens, mix, rng), lens)])


def sample(mix: dict, genomes, seed: int, index: int) -> Sample:
    """Sample ``index`` of the run with ``seed``."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), index])
    if any(k in mix for k in RAGGED):
        return _ragged(mix, genomes, rng)
    n, rl = mix["reads"], mix["read_len"]
    paired = mix["paired"]
    span = mix["fragment_len"] if paired else rl
    n_rand = int(round(n * mix["random_share"]))
    is_rand = np.zeros(n, bool)
    is_rand[rng.permutation(n)[:n_rand]] = True
    real = np.nonzero(~is_rand)[0]
    lens = np.array([len(g) for g, _ in genomes], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    buf = np.frombuffer(b"".join(g for g, _ in genomes), np.uint8)
    gi = np.arange(real.size) % len(genomes)
    start = offs[gi] + (rng.random(real.size) * (lens[gi] - span + 1)
                        ).astype(np.int64)
    frag = buf[start[:, None] + np.arange(span)[None, :]]
    rev = np.zeros(real.size, bool)
    rev[rng.permutation(real.size)[:int(round(real.size
                                              * mix["reverse_share"]))]] = True
    frag[rev] = revcomp(frag[rev])
    mates = [frag[:, :rl].copy()] + ([revcomp(frag[:, -rl:])] if paired
                                     else [])
    out = []
    for m in mates:
        if mix["sub_rate"]:
            _substitute(m, rng.random(m.shape) < mix["sub_rate"], rng)
        full = np.empty((n, rl), np.uint8)
        full[real] = m
        full[is_rand] = ACGT[rng.integers(0, 4, size=(n_rand, rl))]
        out.append(Mate(full.reshape(-1), np.full(n, rl, np.int64)))
    return Sample(out)
