"""Benchmark set construction tools.

Reproduces the reference's distinct benchmark-set builders:

  * ``make_inclusion_query_set`` — assembly-split inclusion design of
    `/root/reference/src/benchmark/makeInclusionQuerySet.cpp:16-256`:
    a random eighth of the multi-assembly species donate two assemblies
    each (subspecies-level inclusion queries), and a random quarter of
    the multi-species genera donate one assembly from each of two
    species (species-level inclusion queries).
  * ``make_virus_benchmark_set`` — the virus-specific exclusion/inclusion
    sampling of `makeVirusBenchmarkSet.cpp:12-401`: a quarter of the
    multi-genus families lose one whole genus, a quarter of the remaining
    multi-species genera lose one species, half of the remaining
    multi-assembly species lose one assembly; the surviving assemblies
    form the database list, and every exclusion is validated by LCA rank
    against the database (family / genus / species level respectively).
  * ``uniref2taxonomy`` — `/root/reference/src/util/uniref2taxonomy.cpp:9-49`.
    NOTE: the upstream source is unfinished and not part of the reference
    build (absent from `src/util/CMakeLists.txt` and the command table,
    and contains a bare `std::unordered` statement that cannot compile);
    its loop parses the 10-column UniRef mapping into uniref100->90 and
    90->50 maps and then discards them, returning 0. We reproduce the
    argument validation and parsing, and (as the evident intent) persist
    the two maps into the target directory as TSVs consumable by the
    uniref tree builder.

Sampling uses deterministic numpy generators. The reference seeds C
``rand()`` with 4 and ``std::mt19937`` with 0; the *stream* is
implementation-defined C rand, so the selection scheme (which strata,
how many, without replacement) is reproduced exactly while the drawn
elements differ.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..db.taxonomy import Taxonomy, rank_index


def _load_taxonomy(tax_path: str) -> Taxonomy:
    return Taxonomy.from_dmp(
        os.path.join(tax_path, "names.dmp"),
        os.path.join(tax_path, "nodes.dmp"),
        os.path.join(tax_path, "merged.dmp"),
    )


def _name2internal(tax: Taxonomy) -> dict:
    """name -> internal id map with version-stripped accession fallbacks
    (`makeInclusionQuerySet.cpp:30-44`)."""
    m = {}
    for i in range(1, tax.n_nodes() + 1):
        m[tax.name_of(i)] = i
    extra = {}
    for name, iid in m.items():
        if "." in name:
            extra[name.split(".", 1)[0]] = iid
    for k, v in extra.items():
        m.setdefault(k, v)
    return m


class _Assembly:
    __slots__ = ("name", "taxid", "species", "genus", "family")

    def __init__(self, name, taxid, tax: Taxonomy):
        self.name = name
        self.taxid = taxid
        self.species = tax.at_rank(taxid, "species")
        self.genus = tax.at_rank(taxid, "genus")
        self.family = tax.at_rank(taxid, "family")


def _group(tax: Taxonomy, assemblies):
    species2assembly: dict[int, list] = {}
    for a in assemblies:
        species2assembly.setdefault(a.species, []).append(a)
    genus2species: dict[int, list] = {}
    for sp in species2assembly:
        genus2species.setdefault(tax.at_rank(sp, "genus"), []).append(sp)
    family2genus: dict[int, list] = {}
    for g in genus2species:
        family2genus.setdefault(tax.at_rank(g, "family"), []).append(g)
    return species2assembly, genus2species, family2genus


def _read_assemblies(assembly_list: str, get_taxid) -> list:
    accs = []
    with open(assembly_list) as fh:
        for line in fh:
            acc = line.rstrip("\n")
            if acc:
                accs.append(acc)
    return accs


def make_inclusion_query_set(assembly_list: str, tax_path: str) -> dict:
    """Write the four inclusion query-set files next to ``assembly_list``."""
    tax = _load_taxonomy(tax_path)
    n2i = _name2internal(tax)
    seen = set()
    assemblies = []
    for acc in _read_assemblies(assembly_list, None):
        if acc in seen:
            print(f"Warning: assembly {acc} has already been observed")
        seen.add(acc)
        iid = n2i.get(acc) or n2i.get(acc.split(".", 1)[0])
        if iid is None:
            print(f"Error: accession {acc} not found in the taxonomy",
                  file=sys.stderr)
            return {"error": 1}
        assemblies.append(_Assembly(acc, iid, tax))
    species2assembly, genus2species, _ = _group(tax, assemblies)

    # --- subspecies inclusion: 1/8 of multi-assembly species, two
    # distinct assemblies each (`makeInclusionQuerySet.cpp:108-148`)
    multi_sp = sorted(s for s, v in species2assembly.items() if len(v) > 1)
    rng = np.random.default_rng(0)
    rng.shuffle(multi_sp)
    picked_sp = multi_sp[: len(multi_sp) // 8]
    out = {}
    f1 = assembly_list + ".subspeciesInclusionQuerySet"
    f2 = assembly_list + ".subspeciesInclusionAssemblies"
    with open(f1, "w") as qf, open(f2, "w") as af:
        qf.write("Species\tSpecies_Size\tQuery_Assemblies\n")
        for sp in picked_sp:
            pool = species2assembly[sp]
            i1, i2 = rng.choice(len(pool), size=2, replace=False)
            qf.write(f"{tax.to_original(sp)}\t{len(pool)}\t"
                     f"{pool[i1].name},{pool[i2].name}\n")
            af.write(pool[i1].name + "\n")
            af.write(pool[i2].name + "\n")
    out["subspecies_species"] = len(picked_sp)

    # --- species inclusion: 1/4 of multi-species genera, one assembly
    # from each of two distinct species (`:150-203`)
    multi_gen = sorted(g for g, v in genus2species.items() if len(v) > 1)
    rng2 = np.random.default_rng(1)
    rng2.shuffle(multi_gen)
    picked_gen = multi_gen[: len(multi_gen) // 4]
    f3 = assembly_list + ".speciesInclusionQuerySet"
    f4 = assembly_list + ".speciesInclusionAssemblies"
    with open(f3, "w") as qf, open(f4, "w") as af:
        qf.write("Genus\tGenus_Size\tQuery_Species\tQuery_Assemblies\n")
        for g in picked_gen:
            spp = genus2species[g]
            i1, i2 = rng2.choice(len(spp), size=2, replace=False)
            s1, s2 = spp[i1], spp[i2]
            a1 = species2assembly[s1][rng2.integers(len(species2assembly[s1]))]
            a2 = species2assembly[s2][rng2.integers(len(species2assembly[s2]))]
            qf.write(f"{tax.to_original(g)}\t{len(spp)}\t"
                     f"{tax.to_original(s1)},{tax.to_original(s2)}\t"
                     f"{a1.name},{a2.name}\n")
            af.write(a1.name + "\n")
            af.write(a2.name + "\n")
    out["species_genera"] = len(picked_gen)
    out["files"] = [f1, f2, f3, f4]
    return out


def _lca_ranks(tax: Taxonomy, taxid: int, others: np.ndarray) -> np.ndarray:
    lcas = tax.lca_pairwise(
        np.full(len(others), taxid, np.int64), others.astype(np.int64))
    return np.array(
        [rank_index(tax.rank_of(int(t))) for t in lcas], np.int32)


def make_virus_benchmark_set(assembly_list: str, tax_path: str,
                             acc2taxid_path: str) -> dict:
    """Exclusion/inclusion sampling + LCA validation
    (`makeVirusBenchmarkSet.cpp:12-401`). Writes six files next to
    ``assembly_list``; returns counters (error=1 on validation failure)."""
    tax = _load_taxonomy(tax_path)
    acc2taxid = {}
    with open(acc2taxid_path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                acc2taxid[parts[0]] = int(parts[1])
    assemblies = []
    seen = set()
    for acc in _read_assemblies(assembly_list, None):
        if acc in seen:
            print(f"Warning: assembly {acc} has already been observed")
        seen.add(acc)
        if acc not in acc2taxid:
            print(f"Error: accession {acc} not found in the assembly "
                  f"accession to taxid mapping", file=sys.stderr)
            return {"error": 1}
        assemblies.append(_Assembly(acc, tax.to_internal(acc2taxid[acc]), tax))
    species2assembly, genus2species, family2genus = _group(tax, assemblies)
    rng = np.random.default_rng(4)
    total_excluded: list[str] = []

    # --- exclude one genus from 1/4 of multi-genus families
    multi_fam = sorted(f for f, v in family2genus.items() if len(v) > 1)
    excluded_genera = []
    genus_excl_assemblies = []
    fpath = assembly_list + ".excludedGenera"
    with open(fpath, "w") as fh:
        fh.write(f"Families with multiple genera: {len(multi_fam)}\n")
        fh.write("Family\tFamily_Size\tExcluded_Genus\tGenus_Size\t"
                 "Assemblies\tQuery_Assembly\n")
        take = len(multi_fam) // 4
        fams = list(rng.choice(multi_fam, size=take, replace=False)) \
            if take else []
        for fam in fams:
            genera = family2genus[fam]
            g = genera[rng.integers(len(genera))]
            excluded_genera.append(g)
            cur = [a.name for sp in genus2species[g]
                   for a in species2assembly[sp]]
            total_excluded.extend(cur)
            genus_excl_assemblies.extend(cur)
            query = cur[rng.integers(len(cur))]
            fh.write(f"{tax.to_original(int(fam))}\t{len(genera)}\t"
                     f"{tax.to_original(int(g))}\t{len(genus2species[g])}\t"
                     f"{','.join(cur)}\t{query}\n")

    # --- exclude one species from 1/4 of the remaining multi-species genera
    excluded_species = []
    species_excl_assemblies = []
    multi_gen = sorted(g for g, v in genus2species.items()
                       if len(v) > 1 and g not in excluded_genera)
    fpath = assembly_list + ".excludedSpecies"
    with open(fpath, "w") as fh:
        fh.write(f"Genera with multiple species: {len(multi_gen)}\n")
        fh.write("Genus\tGenus_Size\tExcluded_Species\tSpecies_Size\t"
                 "Assemblies\tQuery_Assembly\n")
        take = len(multi_gen) // 4
        gens = list(rng.choice(multi_gen, size=take, replace=False)) \
            if take else []
        for g in gens:
            spp = genus2species[g]
            sp = spp[rng.integers(len(spp))]
            excluded_species.append(sp)
            cur = [a.name for a in species2assembly[sp]]
            total_excluded.extend(cur)
            species_excl_assemblies.extend(cur)
            query = cur[rng.integers(len(cur))]
            fh.write(f"{tax.to_original(int(g))}\t{len(spp)}\t"
                     f"{tax.to_original(int(sp))}\t{len(cur)}\t"
                     f"{','.join(cur)}\t{query}\n")
    for g in excluded_genera:
        excluded_species.extend(genus2species[g])

    # --- exclude one assembly from 1/2 of the remaining multi-assembly
    # species; include one from each species left after that
    multi_sp = sorted(s for s, v in species2assembly.items()
                      if len(v) > 1 and s not in excluded_species)
    subspecies_excl = []
    take = len(multi_sp) // 2
    sel = set(int(x) for x in rng.choice(multi_sp, size=take, replace=False)) \
        if take else set()
    remaining_multi_sp = [s for s in multi_sp if s not in sel]
    fpath = assembly_list + ".excludedAssembly"
    with open(fpath, "w") as fh:
        fh.write(f"Species with multiple assemblies: "
                 f"{len(remaining_multi_sp)}\n")
        fh.write("Species\tSpecies_Size\tExcluded_Assemblies\n")
        for sp in sorted(sel):
            pool = species2assembly[sp]
            a = pool[rng.integers(len(pool))].name
            total_excluded.append(a)
            subspecies_excl.append(a)
            fh.write(f"{tax.to_original(sp)}\t{len(pool)}\t{a}\n")
    included = []
    with open(assembly_list + ".includedAssembly", "w") as fh:
        fh.write("Species\tSpecies_Size\tIncluded_Assemblies\n")
        for sp in remaining_multi_sp:
            pool = species2assembly[sp]
            a = pool[rng.integers(len(pool))].name
            included.append(a)
            fh.write(f"{tax.to_original(int(sp))}\t{len(pool)}\t{a}\n")
    with open(assembly_list + ".totalExcludedAssembly", "w") as fh:
        fh.writelines(a + "\n" for a in total_excluded)
    excluded_set = set(total_excluded)
    database = [a.name for a in assemblies if a.name not in excluded_set]
    with open(assembly_list + ".databaseAssembly", "w") as fh:
        fh.writelines(a + "\n" for a in database)

    # --- validations (`makeVirusBenchmarkSet.cpp:289-398`)
    by_name = {a.name: a for a in assemblies}
    db_tax = np.array([by_name[a].taxid for a in database], np.int64)

    def validate(names, exact_rank, floor_rank, must_be_in_db=False):
        floor = rank_index(floor_rank)
        for name in names:
            if must_be_in_db and name not in set(database):
                print(f"Error: {name} is not a valid inclusion. Not in "
                      f"database assembly list.")
                return False
            ranks = _lca_ranks(tax, by_name[name].taxid, db_tax)
            if not (ranks == rank_index(exact_rank)).any():
                print(f"Error: {name} is not a valid "
                      f"{'inclusion' if must_be_in_db else 'exclusion'}. "
                      f"No {exact_rank.capitalize()} rank LCA.")
                return False
            if not must_be_in_db and ((ranks >= 0) & (ranks < floor)).any():
                print(f"Error: {name} is not a valid exclusion. LCA is "
                      f"below {floor_rank.capitalize()} rank.")
                return False
        return True

    ok = (validate(included, "species", "species", must_be_in_db=True)
          and validate(genus_excl_assemblies, "family", "family")
          and validate(species_excl_assemblies, "genus", "genus")
          and validate(subspecies_excl, "species", "species"))
    return {
        "error": 0 if ok else 1,
        "excluded_genera": len(excluded_genera),
        "excluded_species": len(species_excl_assemblies),
        "excluded_assemblies": len(subspecies_excl),
        "included": len(included),
        "database": len(database),
    }


def uniref2taxonomy(mapping_file: str, db_dir: str) -> int:
    """Validate + parse the UniRef idmapping TSV and persist the
    uniref100->90 / uniref90->50 maps (see module docstring for the
    upstream state this extends)."""
    if not os.path.isfile(mapping_file):
        print(f"Error: Mapping file {mapping_file} does not exist.",
              file=sys.stderr)
        return 1
    if not os.path.isdir(db_dir):
        print(f"Error: Database directory {db_dir} does not exist.",
              file=sys.stderr)
        return 1
    u100to90 = {}
    u90to50 = {}
    with open(mapping_file) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 10:
                continue
            u100to90[cols[7]] = cols[8]
            u90to50[cols[8]] = cols[9]
    with open(os.path.join(db_dir, "uniref100to90.tsv"), "w") as fh:
        fh.writelines(f"{k}\t{v}\n" for k, v in u100to90.items())
    with open(os.path.join(db_dir, "uniref90to50.tsv"), "w") as fh:
        fh.writelines(f"{k}\t{v}\n" for k, v in u90to50.items())
    return 0
