"""`databases` command: prebuilt database download/unpack machinery.

Re-provides the reference's compiled-in download flow
(`/root/reference/data/metabulidatabases.sh`,
`/root/reference/src/MetabuliBase.cpp:299-332`): select a catalog entry,
fetch its tarball into a resumable tmp path, unpack into the output
directory, and sanity-check the unpacked DB. urllib replaces the
aria2c/curl/wget ladder (it also accepts file:// URLs, which is how the
zero-egress test environment exercises the full flow end to end).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import urllib.request

# name -> (tarball file name, description, citation) — the reference's
# externalDownloads table (MetabuliBase.cpp:299-332) + its download script's
# URL mapping (metabulidatabases.sh:92-126)
CATALOG = {
    "RefSeq": (
        "refseq_prokaryote_virus.tar.gz",
        "NCBI RefSeq (Complete Genome/Chromosome level assemblies, "
        "prokaryote & virus) and a human genome (T2T-CHM13v2.0)",
        "O'Leary et al. Nucleic Acids Res. (2016)",
    ),
    "GTDB": (
        "gtdb+virus+human.tar.gz",
        "GTDB 220 (Complete/Chromosome level only, CheckM completeness > 90 "
        "and contamination < 5), a human genome, RefSeq viruses",
        "Donovan et al. Nucleic Acids Res. (2022)",
    ),
    "RefSeq_virus": (
        "refseq_virus.tar.gz",
        "NCBI RefSeq release 223 virus genomes and a human genome",
        "O'Leary et al. Nucleic Acids Res. (2016)",
    ),
    "RefSeq_release": (
        "refseq_release.tar.gz",
        "NCBI release 224 (Prokaryote & Virus) and a human genome",
        "O'Leary et al. Nucleic Acids Res. (2016)",
    ),
}

DEFAULT_BASE_URL = "https://metabuli.steineggerlab.workers.dev"


def download_file(url: str, output: str) -> None:
    """Fetch url -> output (atomic via .part); file:// works offline."""
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    part = output + ".part"
    with urllib.request.urlopen(url) as resp, open(part, "wb") as out:
        shutil.copyfileobj(resp, out, length=1 << 20)
    os.replace(part, output)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_database(
    selection: str,
    out_db: str,
    tmp_path: str,
    base_url: str = DEFAULT_BASE_URL,
    checksum: str | None = None,
) -> str:
    """Full flow: fetch (resumable: an existing tarball is reused, like the
    script's notExists guard), optional sha256 verify, unpack, validate.
    Returns the unpacked DB directory."""
    if selection not in CATALOG:
        raise ValueError(
            f"unknown database {selection!r}; available: "
            + ", ".join(sorted(CATALOG))
        )
    tar_name = CATALOG[selection][0]
    os.makedirs(tmp_path, exist_ok=True)
    os.makedirs(out_db, exist_ok=True)
    tar_path = os.path.join(tmp_path, tar_name)
    if not os.path.exists(tar_path):
        download_file(f"{base_url.rstrip('/')}/{tar_name}", tar_path)
    if checksum:
        got = _sha256(tar_path)
        if got != checksum:
            raise ValueError(
                f"checksum mismatch for {tar_name}: got {got}, "
                f"expected {checksum}"
            )
    with tarfile.open(tar_path, "r:gz") as tf:
        tf.extractall(out_db, filter="data")

    # locate the unpacked DB dir (tarballs may nest one directory)
    def has_db(d):
        return any(
            os.path.exists(os.path.join(d, f))
            for f in ("diffIdx", "deltaIdx.mtbl")
        )

    db_dir = out_db
    if not has_db(db_dir):
        for entry in sorted(os.listdir(out_db)):
            cand = os.path.join(out_db, entry)
            if os.path.isdir(cand) and has_db(cand):
                db_dir = cand
                break
        else:
            raise ValueError(
                f"unpacked {tar_name} but found no diffIdx/deltaIdx.mtbl "
                f"under {out_db}"
            )
    return db_dir


def print_catalog() -> None:
    print("Available prebuilt databases (metabuli databases <name> "
          "<outDB> <tmp>):")
    for name, (tar, desc, cite) in CATALOG.items():
        print(f"  {name}\n    {desc}\n    [{cite}]  {tar}")
