"""Synthetic genomes and their taxonomy, drawn from a configuration's
world seed.

A frozen copy of the port's smoke worlds (``tools/world.py`` at the
commit that added this benchmark): ``clades`` genera of ``per_clade``
species, each genome a wobble-diverged copy of its genus's core
followed by a unique tail. The same spec and seed give the
same genomes as that module.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _substitute(out: np.ndarray, pos: np.ndarray, rng) -> None:
    """In place: each base at ``pos`` becomes a random different base."""
    if not len(pos):
        return
    base_idx = np.searchsorted(ACGT, out[pos])
    out[pos] = ACGT[(base_idx + rng.integers(1, 4, size=len(pos))) % 4]


def _mutate(seq: np.ndarray, rate: float, wobble: float, rng) -> np.ndarray:
    """A diverged copy: ``wobble`` of third-codon positions substituted,
    then ``rate`` of all positions."""
    n = len(seq)
    out = seq.copy()
    wpos = np.arange(2, n, 3)
    if wobble:
        _substitute(out, wpos[rng.random(len(wpos)) < wobble], rng)
    if rate:
        _substitute(out, rng.choice(n, size=int(n * rate), replace=False),
                    rng)
    return out


def genomes(spec: dict):
    """(nodes [(taxid, parent, rank)], names {taxid: name}, [(genome
    bytes, species taxid)]) of ``spec`` (its ``seed`` included). Taxids
    run 1.. in the order nodes are listed, so a taxonomy read from the
    written nodes.dmp numbers them as they are here."""
    rng = np.random.default_rng(spec["seed"])
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom")]
    names = {1: "root", 2: "Bacteria"}
    tid, species = 3, []
    for g in range(spec["clades"]):
        gid = tid
        nodes.append((tid, 2, "genus"))
        names[tid] = f"G{g}"
        tid += 1
        for s in range(spec["per_clade"]):
            nodes.append((tid, gid, "species"))
            names[tid] = f"S{g}_{s}"
            species.append((tid, g))
            tid += 1
    cores = [rng.choice(ACGT, spec["core_len"])
             for _ in range(spec["clades"])]
    out = []
    for sp, clade in species:
        uniq = rng.choice(ACGT, spec["unique_len"])
        core = _mutate(cores[clade], spec["divergence"], spec["wobble"], rng)
        out.append((bytes(np.concatenate([core, uniq])), sp))
    return nodes, names, out


def write_taxonomy(d: str, nodes, names) -> None:
    """nodes.dmp, names.dmp and an empty merged.dmp under ``d``."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "nodes.dmp"), "w") as fh:
        fh.write("".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    with open(os.path.join(d, "names.dmp"), "w") as fh:
        fh.write("".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                         for t, n in names.items()))
    open(os.path.join(d, "merged.dmp"), "w").close()


class Taxonomy:
    """The world's tree for the reference: parent, rank and name by taxid
    (taxids as written, which are also the DB's)."""

    def __init__(self, nodes, names):
        self.parent = {t: p for t, p, _ in nodes}
        self.rank = {t: r for t, _, r in nodes}
        self.name = dict(names)
        self.depth = {}
        for t, _, _ in nodes:
            d, n = 0, t
            while self.parent[n] != n:
                n = self.parent[n]
                d += 1
            self.depth[t] = d

    def species_of(self, t: int) -> int:
        while self.rank[t] != "species":
            if self.parent[t] == t:
                return 0
            t = self.parent[t]
        return t

    def lca2(self, a: int, b: int) -> int:
        while self.depth[a] > self.depth[b]:
            a = self.parent[a]
        while self.depth[b] > self.depth[a]:
            b = self.parent[b]
        while a != b:
            a, b = self.parent[a], self.parent[b]
        return a

    def lca(self, ids) -> int:
        ids = [int(i) for i in ids if int(i) != 0]
        if not ids:
            return 0
        acc = ids[0]
        for i in ids[1:]:
            acc = self.lca2(acc, i)
        return acc
