"""One general generator of read samples from a traffic mix's
parameters (``perfbench/traffic/<name>.json``) and the run's seed.

Parameters:
  reads         reads (pairs) a sample
  read_len      bases a read (a mate)
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

Every seed gives the same sizes: exactly ``reads`` reads of
``read_len``, the same count of random and reversed reads, genomes
taken in turn; the seed draws which reads, where and what."""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")


class Sample:
    """One sample's reads: ASCII bases [reads, read_len] a mate."""

    def __init__(self, mates: list[np.ndarray]):
        self.mates = mates

    @property
    def n(self) -> int:
        return len(self.mates[0])

    def names(self) -> list[str]:
        return [f"r{i}" for i in range(self.n)]

    def write(self, d: str, tag: str) -> list[str]:
        """FASTQ files of the mates under ``d``; their paths."""
        paths = []
        names = [f"@r{i}\n".encode() for i in range(self.n)]
        for m, seqs in enumerate(self.mates):
            qual = b"\n+\n" + b"I" * seqs.shape[1] + b"\n"
            path = os.path.join(d, f"{tag}_{m + 1}.fq")
            with open(path, "wb") as fh:
                fh.write(b"".join(n + s + qual for n, s in
                                  zip(names, (r.tobytes() for r in seqs))))
            paths.append(path)
        return paths


def _substitute(bases: np.ndarray, hit: np.ndarray, rng) -> None:
    """In place: each base where ``hit`` becomes another base."""
    idx = np.searchsorted(ACGT, bases[hit])
    bases[hit] = ACGT[(idx + rng.integers(1, 4, size=idx.size)) % 4]


def revcomp(seqs: np.ndarray) -> np.ndarray:
    return COMP[seqs[:, ::-1]]


def sample(mix: dict, genomes, seed: int, index: int) -> Sample:
    """Sample ``index`` of the run with ``seed``."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), index])
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
        out.append(full)
    return Sample(out)
