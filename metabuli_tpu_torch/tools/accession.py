"""`accession2taxid`: derive an accession2taxid map for GTDB-style libraries.

Mirrors `/root/reference/src/util/accession2taxid.cpp`: for each FASTA in a
library list, look its *file name* up in a (name -> taxid) map and emit one
row per sequence accession in the file.
"""

from __future__ import annotations

import os

from ..io import fasta


def accession2taxid_from_library(library_list: str, taxid_map: str) -> str:
    name2taxid: dict[str, int] = {}
    with open(taxid_map) as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 2:
                try:
                    name2taxid[cols[0]] = int(cols[1])
                except ValueError:
                    continue

    out_path = os.path.join(
        os.path.dirname(os.path.abspath(library_list)), "my.accession2taxid"
    )
    with open(library_list) as fh:
        files = [line.strip() for line in fh if line.strip()]
    with open(out_path, "w") as out:
        out.write("accession\taccession.version\ttaxid\tgi\n")
        for path in files:
            base = os.path.basename(path)
            taxid = None
            for key in (base, base.rsplit(".", 1)[0], fasta.query_base_name(path)):
                if key in name2taxid:
                    taxid = name2taxid[key]
                    break
            if taxid is None:
                continue
            for rec in fasta.read_records(path):
                acc_ver = rec.name.split()[0]
                acc = acc_ver.rsplit(".", 1)[0]
                out.write(f"{acc}\t{acc_ver}\t{taxid}\t0\n")
    return out_path
