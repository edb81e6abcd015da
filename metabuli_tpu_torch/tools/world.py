"""The smoke world: synthetic genomes, a taxonomy and sampled reads.

The port's own copy of the world and read sampler of the repository's
benchmark script (``bench.py``): the adversarial "skew" world and
``sample_reads`` draw from the generator in the same order, so one seed
gives the same genomes and reads in both packages.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

# adversarial AA-group skew: 192 species per clade share a conserved 6 kb
# core whose divergence is dominated by third-codon-position ("wobble")
# substitutions, mostly synonymous like real conserved genes, so AA groups
# go ~150-200 deep while DNA windows vary; a light uniform substitution
# rate adds nonsynonymous realism
SKEW = dict(clades=2, per_clade=192, core_len=6_000, unique_len=94_000,
            divergence=0.002, wobble=0.2)


def _substitute(out: np.ndarray, pos: np.ndarray, rng) -> None:
    """In place: each base at ``pos`` becomes a random DIFFERENT base."""
    if not len(pos):
        return
    # a shift by 1-3 places in ACGT order always gives another base
    base_idx = np.searchsorted(ACGT, out[pos])
    out[pos] = ACGT[(base_idx + rng.integers(1, 4, size=len(pos))) % 4]


def _mutate(seq: np.ndarray, rate: float, wobble: float, rng) -> np.ndarray:
    """A diverged copy: ``wobble`` of third-codon positions substituted
    (mostly synonymous under the real genetic code, keeping the AA word)
    plus ``rate`` of all positions substituted uniformly."""
    n = len(seq)
    out = seq.copy()
    wpos = np.arange(2, n, 3)
    if wobble:
        _substitute(out, wpos[rng.random(len(wpos)) < wobble], rng)
    if rate:
        _substitute(out, rng.choice(n, size=int(n * rate), replace=False),
                    rng)
    return out


def write_taxonomy(d: str, nodes, names) -> None:
    """nodes.dmp, names.dmp and an empty merged.dmp under ``d``."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "nodes.dmp"), "w") as fh:
        fh.write("".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in nodes))
    with open(os.path.join(d, "names.dmp"), "w") as fh:
        fh.write("".join(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                         for t, n in names.items()))
    open(os.path.join(d, "merged.dmp"), "w").close()


def skew_genomes(rng):
    """(nodes, names, [(genome bytes, species taxid)]) of the skew world,
    drawn from ``rng``: 2 genera of 192 species, each a wobble-diverged
    copy of its genus's core followed by a unique tail."""
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom")]
    names = {1: "root", 2: "Bacteria"}
    tid, species = 3, []
    for g in range(SKEW["clades"]):
        gid = tid
        nodes.append((tid, 2, "genus")); names[tid] = f"G{g}"; tid += 1
        for s in range(SKEW["per_clade"]):
            nodes.append((tid, gid, "species")); names[tid] = f"S{g}_{s}"
            species.append((tid, g)); tid += 1
    cores = [rng.choice(ACGT, SKEW["core_len"])
             for _ in range(SKEW["clades"])]
    genomes = []
    for sp, clade in species:
        uniq = rng.choice(ACGT, SKEW["unique_len"])
        core = _mutate(cores[clade], SKEW["divergence"], SKEW["wobble"], rng)
        genomes.append((bytes(np.concatenate([core, uniq])), sp))
    return nodes, names, genomes


def skew_world(tmp: str, seed: int = 0):
    """(taxonomy, [(genome, species taxid)], rng): the skew world from
    ``seed``, its taxonomy written under ``tmp/skew_taxonomy``; ``rng`` is
    left where the reads are drawn next."""
    from ..db.taxonomy import Taxonomy

    rng = np.random.default_rng(seed)
    nodes, names, genomes = skew_genomes(rng)
    d = os.path.join(tmp, "skew_taxonomy")
    write_taxonomy(d, nodes, names)
    tax = Taxonomy.from_dmp(*(os.path.join(d, f) for f in
                              ("names.dmp", "nodes.dmp", "merged.dmp")))
    return tax, genomes, rng


def genus_of(tax, genomes) -> dict[int, int]:
    """species taxid -> its parent's taxid, for each genome."""
    return {sp: tax.to_original(int(tax.parent[tax.to_internal(sp)]))
            for _, sp in genomes}


def write_library(d: str, genomes, genus: dict[int, int]) -> tuple[str, str]:
    """The genomes as a FASTA library for ``build``/``updateDB``: one file
    per genus (``genus_<taxid>.fna``, ``genus`` maps each species to it),
    one record per species with the accession ``SKW_<species taxid>.1``,
    the list of the files and an accession -> taxid map. Returns (list
    path, map path)."""
    os.makedirs(d, exist_ok=True)
    by_genus: dict[int, list[str]] = {}
    for seq, sp in genomes:
        by_genus.setdefault(genus[sp], []).append(
            f">SKW_{sp}.1\n{seq.decode()}\n")
    files = []
    for g, recs in by_genus.items():
        files.append(os.path.join(d, f"genus_{g}.fna"))
        with open(files[-1], "w") as fh:
            fh.write("".join(recs))
    lib = os.path.join(d, "library.txt")
    with open(lib, "w") as fh:
        fh.write("".join(f"{f}\n" for f in files))
    acc = os.path.join(d, "acc2taxid.map")
    with open(acc, "w") as fh:
        fh.write("accession\ttaxid\n"
                 + "".join(f"SKW_{sp}.1\t{sp}\n" for _, sp in genomes))
    return lib, acc


def new_genus(d: str, tax, n_species: int = 16, length: int = 100_000,
              seed: int = 1):
    """A genus the taxonomy does not have yet, for ``updateDB``: taxids
    after the largest one, under the superkingdom (taxid 2), with
    ``n_species`` uniform random genomes of ``length`` bases drawn from
    ``seed``, written as a library (``write_library``) and a --new-taxa
    file. Returns (list path, map path, new-taxa path, genomes)."""
    rng = np.random.default_rng(seed)
    gid = int(tax.internal2org.max()) + 1
    rows = [(gid, 2, "genus", "G_new")] + [
        (gid + 1 + i, gid, "species", f"S_new_{i}") for i in range(n_species)]
    genomes = [(bytes(rng.choice(ACGT, length)), gid + 1 + i)
               for i in range(n_species)]
    os.makedirs(d, exist_ok=True)
    new_taxa = os.path.join(d, "new_taxa.tsv")
    with open(new_taxa, "w") as fh:
        fh.write("".join(f"{t}\t{p}\t{r}\t{n}\n" for t, p, r, n in rows))
    lib, acc = write_library(d, genomes, {sp: gid for _, sp in genomes})
    return lib, acc, new_taxa, genomes


def sample_reads(genomes, rng, n_reads: int, read_len: int, max_mut: int):
    """``n_reads`` reads of ``read_len`` bases: every tenth uniform random,
    the rest cut from the genomes in turn with up to ``max_mut`` random
    bases set, half of them reverse-complemented."""
    reads = []
    for i in range(n_reads):
        if i % 10 == 9:
            reads.append(bytes(rng.choice(ACGT, read_len)))
            continue
        g, _ = genomes[i % len(genomes)]
        st = int(rng.integers(0, len(g) - read_len))
        read = bytearray(g[st:st + read_len])
        for _ in range(int(rng.integers(0, max_mut + 1))):
            p = int(rng.integers(0, read_len))
            read[p] = b"ACGT"[int(rng.integers(0, 4))]
        if rng.integers(0, 2):
            read = bytearray(
                bytes(read).translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1])
        reads.append(bytes(read))
    return reads
