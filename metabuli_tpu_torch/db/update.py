"""`updateDB`: add new sequences to an existing database.

Mirrors `Metabuli src/workflow/updateDB.cpp:36-158`: extract metamers
from the new FASTAs, optionally extend the taxonomy with --new-taxa entries
(`TaxonomyWrapper::addNewTaxa`), then merge with the old DB's k-mer stream,
re-deduplicating (value, species) groups with LCA on collision.
"""

from __future__ import annotations

import os

import numpy as np

from ..params import BuildParams
from .build import (IndexBuilder, SeqTask, accession_of, predict_gene_blocks,
                    read_acc2taxid)
from .index import MetamerIndex
from .taxonomy import Taxonomy
from ..io import fasta


def parse_new_taxa(path: str) -> list[tuple[int, int, str, str]]:
    """--new-taxa file: taxid<TAB>parent<TAB>rank<TAB>name
    (`TaxonomyWrapper::getListOfTaxa`)."""
    out = []
    with open(path) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 4:
                out.append((int(cols[0]), int(cols[1]), cols[2], cols[3]))
    return out


def extend_taxonomy(tax: Taxonomy, new_taxa: list[tuple[int, int, str, str]]) -> Taxonomy:
    """Append new nodes (dense internal IDs continue after existing ones)."""
    parent = list(tax.parent)
    rank_id = list(tax.rank_id)
    name_id = list(tax.name_id)
    ranks = list(tax.ranks)
    names = list(tax.names)
    internal2org = list(tax.internal2org)
    org2int = dict(tax.org2internal)

    def intern(s, pool):
        try:
            return pool.index(s)
        except ValueError:
            pool.append(s)
            return len(pool) - 1

    # two passes: allocate ids first so forward-referencing parents work
    for taxid, _, _, _ in new_taxa:
        if taxid in org2int:
            raise ValueError(f"new taxon {taxid} already exists")
        org2int[taxid] = len(parent)
        parent.append(0)
        rank_id.append(0)
        name_id.append(0)
        internal2org.append(taxid)
    for taxid, p_org, rank, name in new_taxa:
        iid = org2int[taxid]
        if p_org not in org2int:
            raise ValueError(f"parent {p_org} of new taxon {taxid} unknown")
        parent[iid] = org2int[p_org]
        rank_id[iid] = intern(rank, ranks)
        name_id[iid] = intern(name, names)
    return Taxonomy(
        parent=np.array(parent, np.int32),
        rank_id=np.array(rank_id, np.int32),
        name_id=np.array(name_id, np.int32),
        ranks=ranks,
        names=names,
        internal2org=np.array(internal2org, np.int64),
        use_internal=tax.use_internal,
    )


def update_database(
    db_dir: str,
    old_db_dir: str,
    fasta_list: str,
    acc2taxid_path: str,
    params: BuildParams | None = None,
    new_taxa: str = "",
    device="cuda",
) -> dict:
    params = params or BuildParams()
    # the old DB can stream through the k-way merge without ever being
    # decompressed in full (`updateDB.cpp:139-142` feeds the old
    # diffIdx/info as one more merge input) when its info entries carry no
    # redundancy bit and it uses the classic diffIdx layout
    old_diff = os.path.join(old_db_dir, "diffIdx")
    old_params_path = os.path.join(old_db_dir, "db.parameters")
    from .formats import DbParameters
    from .index import load_db_taxonomy

    old_params = (DbParameters.read(old_params_path)
                  if os.path.exists(old_params_path) else DbParameters())
    streaming = (
        os.path.exists(old_diff)
        and old_params.skip_redundancy == 1
        and os.path.abspath(old_db_dir) != os.path.abspath(db_dir)
    )
    if streaming:
        old = None
        tax = load_db_taxonomy(old_db_dir)
    else:
        old = MetamerIndex.load(old_db_dir)
        old_params = old.params
        tax = old.taxonomy
    if new_taxa:
        tax = extend_taxonomy(tax, parse_new_taxa(new_taxa))

    # carry DB-defining parameters over from the old DB
    params.syncmer = old_params.syncmer
    params.smer_len = old_params.smer_len
    params.kmer_format = old_params.kmer_format
    params.reduced_aa = old_params.reduced_aa

    acc2taxid = read_acc2taxid(acc2taxid_path)
    builder = IndexBuilder(params, tax,
                           flush_dir=os.path.join(db_dir, "flush"),
                           device=device)
    with open(fasta_list) as fh:
        files = [line.strip() for line in fh if line.strip()]

    # the reference's updateDB runs the FULL IndexCreator over the new
    # sequences (`updateDB.cpp:104-106` createIndex: CDS bypass, gene
    # prediction, masking — same as build), so the update path shares the
    # build path's task preparation
    cds_map = {}
    if params.cds_info:
        from .cds import load_cds_info

        cds_map = load_cds_info(params.cds_info)
    tasks = []
    acc_rows = []
    skipped = 0
    for path in files:
        for rec in fasta.read_records(path):
            acc = accession_of(rec.name)
            org = acc2taxid.get(acc) or acc2taxid.get(acc.split(".")[0])
            internal = tax.to_internal(org) if org else -1
            if internal is None or internal < 0:
                skipped += 1
                continue
            species = int(tax.species_of[internal])
            if acc in cds_map:
                from .cds import divide_cds_noncds

                src = rec.seq
                if params.mask_mode:
                    from ..ops.mask import mask_bytes

                    src = mask_bytes(rec.seq, params.mask_prob)
                cds_blocks, non_cds = divide_cds_noncds(src, cds_map[acc])
                for block in cds_blocks + non_cds:
                    if len(block) >= 24:
                        tasks.append(SeqTask(block, internal, species,
                                             single_frame=True))
            else:
                tasks.append(SeqTask(rec.seq, internal, species))
            acc_rows.append((acc, org))
    if params.gene_prediction:
        buffer_kmers = max(1 << 22, (params.max_ram << 30) >> 5)
        tasks = predict_gene_blocks(tasks, tax, buffer_kmers,
                                    params.mask_mode, params.mask_prob,
                                    builder.timer)
    elif params.mask_mode:
        from ..ops.mask import mask_bytes

        tasks = [
            t if t.single_frame
            else SeqTask(mask_bytes(t.seq, params.mask_prob), t.taxid,
                         t.species)
            for t in tasks
        ]
    builder.add_sequences(tasks)

    # merge: feed the old DB's entries through the same dedup machinery
    if streaming:
        # flush the new k-mers, then k-way merge with the old DB stream
        if builder._pending:
            builder._flush()
        builder._flush_pairs.append(
            (old_diff, os.path.join(old_db_dir, "info"))
        )
    else:
        old_species = tax.species_of[
            old.taxids.astype(np.int64)].astype(np.uint32)
        builder._values.append(old.values)
        builder._taxids.append(old.taxids)
        builder._species.append(old_species)

    stats = builder.finalize(db_dir, params.db_name or old_params.db_name)
    stats["sequences"] = len(tasks)
    stats["skipped_accessions"] = skipped
    # merge acc2taxid maps
    out_map = os.path.join(db_dir, "acc2taxid.map")
    with open(out_map, "w") as fh:
        fh.write("accession\ttaxID\n")
        old_map = os.path.join(old_db_dir, "acc2taxid.map")
        if os.path.exists(old_map):
            with open(old_map) as oldfh:
                for line in oldfh:
                    if not line.startswith("accession"):
                        fh.write(line)
        for acc, org in acc_rows:
            fh.write(f"{acc}\t{org}\n")
    return stats
