"""The smoke worlds: synthetic genomes, a taxonomy, sampled reads and a
metamer DB of them.

The port's own copy of the worlds and read sampler of the repository's
benchmark script (``bench.py``): the adversarial "skew" world, the
"uniform" world of its ``longread`` configuration and ``sample_reads``
draw from the generator in the same order, so one seed gives the same
genomes and reads in both packages.

    python -m metabuli_tpu_torch.tools.world OUT

writes ``chip_smoke.py``'s smoke DB and reads on the card: the skew
world from seed 0, its metamer DB padded to 2^28 rows (``OUT/db``,
``build_db``) and 65,536 reads of 150 bases (``OUT/reads.fq``).

``uniref_world`` and ``uniref_queries`` make the UniRef-like protein
clusters, their XML dump and the DNA and protein queries of the smoke
run's ``uniref`` phase.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

# adversarial AA-group skew: 192 species per clade share a conserved 6 kb
# core whose divergence is dominated by third-codon-position ("wobble")
# substitutions, mostly synonymous like real conserved genes, so AA groups
# go ~150-200 deep while DNA windows vary; a light uniform substitution
# rate adds nonsynonymous realism
SKEW = dict(clades=2, per_clade=192, core_len=6_000, unique_len=94_000,
            divergence=0.002, wobble=0.2)
# independent random genomes: 4 genera x 2 species of 200 kb, no core, so
# AA groups stay ~1-2 rows deep (bench.py's longread configuration)
UNIFORM = dict(clades=4, per_clade=2, core_len=0, unique_len=200_000,
               divergence=0.0, wobble=0.0)
WORLDS = {"skew": SKEW, "uniform": UNIFORM}


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


def world_genomes(spec: dict, rng):
    """(nodes, names, [(genome bytes, species taxid)]) of a world, drawn
    from ``rng``: ``clades`` genera of ``per_clade`` species, each a
    wobble-diverged copy of its genus's core (if ``core_len``) followed by
    a unique tail."""
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom")]
    names = {1: "root", 2: "Bacteria"}
    tid, species = 3, []
    for g in range(spec["clades"]):
        gid = tid
        nodes.append((tid, 2, "genus")); names[tid] = f"G{g}"; tid += 1
        for s in range(spec["per_clade"]):
            nodes.append((tid, gid, "species")); names[tid] = f"S{g}_{s}"
            species.append((tid, g)); tid += 1
    cores = [rng.choice(ACGT, spec["core_len"])
             for _ in range(spec["clades"])] if spec["core_len"] else None
    genomes = []
    for sp, clade in species:
        uniq = rng.choice(ACGT, spec["unique_len"])
        if cores is None:
            genomes.append((bytes(uniq), sp))
            continue
        core = _mutate(cores[clade], spec["divergence"], spec["wobble"], rng)
        genomes.append((bytes(np.concatenate([core, uniq])), sp))
    return nodes, names, genomes


def make_world(tmp: str, name: str = "skew", seed: int = 0):
    """(taxonomy, [(genome, species taxid)], rng): world ``name`` of
    ``WORLDS`` from ``seed``, its taxonomy written under
    ``tmp/<name>_taxonomy``; ``rng`` is left where the reads are drawn
    next."""
    from ..db.taxonomy import Taxonomy

    rng = np.random.default_rng(seed)
    nodes, names, genomes = world_genomes(WORLDS[name], rng)
    d = os.path.join(tmp, f"{name}_taxonomy")
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


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")


# UniRef-like protein clusters (chip_smoke.py's uniref phase): UniRef50
# seeds, each UniRef90 seed at ~30 % substitutions from its UniRef50's,
# each UniRef100 entry at ~5 % from its UniRef90's: the clusters' identity
# thresholds, at the real entry length and query shapes, cut in count
UNIREF = dict(entries=32_768, length=300, u90=4_096, u50=512, sub90=0.05,
              sub50=0.30)
AA20 = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
_UNIREF_NS = 'xmlns="http://uniprot.org/uniref"'


def _aa_substitute(idx: np.ndarray, rate: float, rng) -> np.ndarray:
    """A copy of residue indices ``idx`` (0..19) with ``rate`` of them
    replaced by a different residue."""
    out = idx.copy()
    hit = rng.random(out.shape) < rate
    out[hit] = (out[hit] + rng.integers(1, 20, int(hit.sum()))) % 20
    return out


def uniref_world(d: str, seed: int = 2, spec: dict = UNIREF):
    """A UniRef100 XML dump (``d/uniref100.xml``, the schema the UniRef
    tools read: entry id, the representative member's UniRef90 and
    UniRef50 IDs and its sequence) of ``spec["entries"]`` entries in
    ``u90`` UniRef90 and ``u50`` UniRef50 clusters, drawn from ``seed``.
    Returns (xml path, [entry sequence bytes])."""
    rng = np.random.default_rng(seed)
    n, length = spec["entries"], spec["length"]
    per90, per50 = n // spec["u90"], spec["u90"] // spec["u50"]
    seeds50 = rng.integers(0, 20, (spec["u50"], length))
    seeds90 = _aa_substitute(np.repeat(seeds50, per50, axis=0),
                             spec["sub50"], rng)
    members = _aa_substitute(np.repeat(seeds90, per90, axis=0),
                             spec["sub90"], rng)
    seqs = [AA20[m].tobytes() for m in members]
    parts = [f'<?xml version="1.0"?><UniRef100 {_UNIREF_NS}>']
    for i, seq in enumerate(seqs):
        c90 = i // per90
        parts.append(
            f'<entry id="UniRef100_U{i:06d}" updated="2024-01-01">'
            '<representativeMember><dbReference type="UniProtKB ID" id="x">'
            f'<property type="UniRef90 ID" value="UniRef90_U{c90:05d}"/>'
            '<property type="UniRef50 ID" '
            f'value="UniRef50_U{c90 // per50:04d}"/>'
            f'</dbReference><sequence length="{length}">{seq.decode()}'
            "</sequence></representativeMember></entry>")
    parts.append("</UniRef100>")
    os.makedirs(d, exist_ok=True)
    xml = os.path.join(d, "uniref100.xml")
    with open(xml, "w") as fh:
        fh.write("".join(parts))
    return xml, seqs


def uniref_queries(seqs, rng, n: int, length: int, dna: bool,
                   error: float = 0.02):
    """``n`` queries cut from the entries ``seqs`` in turn at random
    offsets, every tenth uniform random: ``dna`` back-translates a
    fragment of ``length // 3`` residues with random synonymous codons,
    sets ``error`` of its bases to another base and reverse-complements
    half of them; otherwise protein fragments of ``length`` residues."""
    from ..ops.genetic_code import _STD_AA_CODONS

    letter = {c: i for i, c in enumerate(AA20.tolist())}
    codons = [[c.encode() for c in _STD_AA_CODONS[a]] for a in range(20)]
    out = []
    for i in range(n):
        if i % 10 == 9:
            out.append(bytes(rng.choice(ACGT, length)) if dna
                       else AA20[rng.integers(0, 20, length)].tobytes())
            continue
        s = seqs[i % len(seqs)]
        k = length // 3 if dna else length
        st = int(rng.integers(0, len(s) - k + 1))
        frag = s[st:st + k]
        if not dna:
            out.append(frag)
            continue
        pick = rng.random(k)
        read = np.frombuffer(b"".join(
            cs[int(p * len(cs))] for cs, p in
            zip((codons[letter[c]] for c in frag), pick)), np.uint8).copy()
        _substitute(read, np.nonzero(rng.random(len(read)) < error)[0], rng)
        if rng.integers(0, 2):
            read = np.frombuffer(read.tobytes().translate(
                bytes.maketrans(b"ACGT", b"TGCA"))[::-1], np.uint8)
        out.append(read.tobytes())
    return out


def write_fasta(path: str, seqs, prefix: str = "q") -> None:
    with open(path, "w") as fh:
        fh.write("".join(f">{prefix}{i}\n{s.decode()}\n"
                         for i, s in enumerate(seqs)))


def uniref_inputs(d: str, n_dna: int = 65_536, n_protein: int = 4_096):
    """The uniref phase's inputs under ``d``: the XML dump of
    ``uniref_world`` (seed 2), ``n_dna`` DNA reads of 150 bases
    (``d/dna.fna``) and ``n_protein`` protein fragments of 100 residues
    (``d/protein.fasta``) drawn from seed 3. Returns the three paths and
    the entries' sequences, in the dump's order."""
    xml, seqs = uniref_world(d)
    rng = np.random.default_rng(3)
    dna = os.path.join(d, "dna.fna")
    write_fasta(dna, uniref_queries(seqs, rng, n_dna, 150, dna=True), "d")
    prot = os.path.join(d, "protein.fasta")
    write_fasta(prot, uniref_queries(seqs, rng, n_protein, 100, dna=False),
                "p")
    return xml, dna, prot, seqs


def uniref_tree_sha256(tree_path: str) -> str:
    """sha256 of a saved UniRef tree's arrays (parent, rank, the names one
    a line): the .npz file itself holds zip timestamps."""
    import hashlib

    z = np.load(tree_path if tree_path.endswith(".npz")
                else tree_path + ".npz", allow_pickle=True)
    h = hashlib.sha256(np.ascontiguousarray(z["parent"]).tobytes())
    h.update(np.ascontiguousarray(z["rank"]).tobytes())
    h.update("\n".join(str(x) for x in z["names"]).encode())
    return h.hexdigest()


DB_CHUNK = 64  # genomes per K1 launch of build_db


def build_db(db_dir: str, tax, genomes, device, rows: int = 0,
             never_match: bool = False) -> dict:
    """Metamer DB of species-level genomes: 6-frame metamers of every
    window (K1, DB_CHUNK genomes a launch), unique per (value, species)
    (each genome is its own species, so the LCA taxid is that species),
    optionally padded with decoy rows to ``rows``.

    The decoys are bench.py's: uniform 40-bit AA keys (colliding keys
    dropped, so every genome-derived group stays as it is), uniform
    codons, taxids drawn from the real species. A uniform key has every
    5-bit residue below 21 (a residue a read can translate to) 3.4 % of
    the time, so a read's k-mer may meet a decoy. ``never_match`` sets
    each decoy's first residue to 31, which no codon translates to: no
    query meets a decoy, and the table's last row (which the classifier
    leaves out of its search) is a decoy, so any number of decoys gives
    the classifications of the genome-derived rows alone."""
    import torch

    from ..db.formats import DbParameters
    from ..db.index import MetamerIndex
    from ..ops import encode
    from ..ops.encode import srl
    from ..ops.genetic_code import encode_seqs_padded

    t0 = time.perf_counter()
    sp_int = [tax.to_internal(sp) for _, sp in genomes]
    assert all(int(tax.species_of[t]) == t for t in sp_int)
    vals, taxs = [], []
    for i in range(0, len(genomes), DB_CHUNK):
        chunk = genomes[i:i + DB_CHUNK]
        codes, lens = encode_seqs_padded([g for g, _ in chunk])
        mm = encode.extract_metamers(torch.from_numpy(codes).to(device),
                                     torch.from_numpy(lens).to(device))
        t = torch.tensor(sp_int[i:i + DB_CHUNK], dtype=torch.int64,
                         device=device)
        vals.append(mm.value[mm.valid])
        taxs.append(t[:, None, None].expand(mm.valid.shape)[mm.valid])
        del mm
    v = torch.cat(vals)
    t = torch.cat(taxs)
    del vals, taxs
    flip = -(1 << 63)  # signed order of v ^ 2^63 == unsigned order of v

    def sort_vt(v, t):
        o = torch.sort(t, stable=True)[1]
        o = o[torch.sort(v[o] ^ flip, stable=True)[1]]
        return v[o], t[o]

    v, t = sort_vt(v, t)
    keep = torch.ones(v.numel(), dtype=torch.bool, device=device)
    keep[1:] = (v[1:] != v[:-1]) | (t[1:] != t[:-1])
    v, t = v[keep], t[keep]
    n_real = int(v.numel())
    n_decoys = max(0, rows - n_real) if rows else 0
    if n_decoys:
        # a 0.1 % surplus of draws makes up for the dropped keys so the
        # table has exactly `rows`
        rng = np.random.default_rng(12345)
        n_draw = n_decoys + n_decoys // 1000 + 1024
        aa = torch.from_numpy(rng.integers(0, 1 << 40, size=n_draw,
                                           dtype=np.uint64).view(np.int64))
        aa = aa.to(device)
        if never_match:
            aa |= 31 << 35
        aa = aa[~torch.isin(aa, torch.unique(srl(v, 24)))][:n_decoys]
        dna = torch.from_numpy(rng.integers(0, 1 << 24, size=aa.numel(),
                                            dtype=np.int64)).to(device)
        species = np.unique(np.asarray(sp_int, np.int64))
        dt = torch.from_numpy(rng.choice(species, size=aa.numel())).to(device)
        v, t = sort_vt(torch.cat([v, (aa << 24) | dna]), torch.cat([t, dt]))
        del aa, dna, dt
    values = v.cpu().numpy().view(np.uint64)
    taxids = t.to(torch.int32).cpu().numpy().view(np.uint32)
    del v, t, keep
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    aa = values >> np.uint64(24)
    change = np.nonzero(aa[1:] != aa[:-1])[0]
    bounds = np.concatenate([[-1], change, [len(aa) - 1]])
    max_group = int(np.diff(bounds).max())
    del aa, change, bounds
    MetamerIndex(values=values, taxids=taxids, taxonomy=tax,
                 params=DbParameters(db_name="smoke", skip_redundancy=1),
                 max_group=max_group).save(db_dir)
    return {"rows": len(values), "genome_rows": n_real,
            "decoy_rows": len(values) - n_real, "max_group": max_group,
            "build_s": round(t1 - t0, 3),
            "write_s": round(time.perf_counter() - t1, 3)}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="metabuli_tpu_torch.tools.world")
    ap.add_argument("out")
    out = ap.parse_args(argv).out
    os.makedirs(out, exist_ok=True)
    tax, genomes, rng = make_world(out, "skew")
    info = build_db(os.path.join(out, "db"), tax, genomes,
                    torch.device("cuda"), rows=1 << 28)
    write_fastq(os.path.join(out, "reads.fq"),
                sample_reads(genomes, rng, 65_536, 150, max_mut=2))
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
