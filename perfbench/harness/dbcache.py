"""The configuration's reference DB, made once a checkout and kept under
``perfbench/cache/<config>/``.

The table is the world's six-frame metamers, each (value, species) once,
padded with decoy rows to the configuration's ``rows`` (a frozen copy of
the port's ``tools/world.py::build_db`` decoy scheme: uniform 40-bit
amino-acid keys that no genome key shares, uniform codon numbers, taxids
drawn from the real species). Both sides get it: the
program as DB files (``diffIdx``, ``info``, ``db.parameters``,
``taxID_list`` and the taxonomy's ``.dmp`` files, written in Metabuli's
formats as the port's ``db/formats.py`` writes them), the reference as
the raw arrays (``values.u64`` beside ``db/info``)."""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from . import metamers, world

FLIP = -(1 << 63)  # v ^ FLIP orders int64 bit patterns as unsigned values
GENOMES_A_CHUNK = 64


class Db:
    """A made DB: its directory for the program, its raw arrays and its
    taxonomy for the reference."""

    def __init__(self, root: str, cfg: dict):
        self.root = root
        self.db_dir = os.path.join(root, "db")
        nodes, names, self.genomes = world.genomes(cfg["world"])
        self.taxonomy = world.Taxonomy(nodes, names)
        self.nodes, self.names = nodes, names

    def values(self) -> np.ndarray:
        return np.fromfile(os.path.join(self.root, "values.u64"), np.uint64)

    def taxids(self) -> np.ndarray:
        return np.fromfile(os.path.join(self.db_dir, "info"), np.uint32)

    def disk_bytes(self) -> int:
        total = 0
        for d, _, files in os.walk(self.root):
            total += sum(os.path.getsize(os.path.join(d, f)) for f in files)
        return total


def sort_rows(v: torch.Tensor, t: torch.Tensor):
    """Rows by unsigned value, then taxid."""
    o = torch.sort(t, stable=True)[1]
    o = o[torch.sort(v[o] ^ FLIP, stable=True)[1]]
    return v[o], t[o]


def table(cfg: dict, genomes, device) -> tuple[np.ndarray, np.ndarray]:
    """(values uint64, taxids uint32) of the configuration's table."""
    dev = torch.device(device)
    ex = metamers.Extractor(dev)
    vals, taxs = [], []
    for i in range(0, len(genomes), GENOMES_A_CHUNK):
        chunk = genomes[i:i + GENOMES_A_CHUNK]
        L = max(len(g) for g, _ in chunk)
        codes = np.full((len(chunk), L), 7, np.uint8)
        for r, (g, _) in enumerate(chunk):
            codes[r, :len(g)] = metamers.to_codes(np.frombuffer(g, np.uint8))
        lens = torch.tensor([len(g) for g, _ in chunk], device=dev)
        value, _, _, valid = ex.extract(torch.from_numpy(codes).to(dev), lens)
        sp = torch.tensor([s for _, s in chunk], device=dev)
        vals.append(value[valid])
        taxs.append(sp[:, None, None].expand(valid.shape)[valid])
        del value, valid
    v, t = sort_rows(torch.cat(vals), torch.cat(taxs))
    del vals, taxs
    keep = torch.ones(v.numel(), dtype=torch.bool, device=dev)
    keep[1:] = (v[1:] != v[:-1]) | (t[1:] != t[:-1])
    v, t = v[keep], t[keep]
    n_decoys = max(0, cfg["rows"] - v.numel())
    if n_decoys:
        dcfg = cfg["decoys"]
        rng = np.random.default_rng(dcfg["seed"])
        n_draw = n_decoys + n_decoys // 1000 + 1024
        aa = torch.from_numpy(rng.integers(0, 1 << 40, size=n_draw,
                                           dtype=np.uint64).view(np.int64))
        aa = aa.to(dev)
        genome_keys = torch.unique((v >> 24) & ((1 << 40) - 1))
        aa = aa[~torch.isin(aa, genome_keys)][:n_decoys]
        del genome_keys
        dna = torch.from_numpy(rng.integers(0, 1 << 24, size=aa.numel(),
                                            dtype=np.int64)).to(dev)
        species = np.unique(np.asarray([s for _, s in genomes], np.int64))
        dt = torch.from_numpy(rng.choice(species, size=aa.numel())).to(dev)
        v, t = sort_rows(torch.cat([v, (aa << 24) | dna]), torch.cat([t, dt]))
        del aa, dna, dt
    values = v.cpu().numpy().view(np.uint64)
    taxids = t.to(torch.int32).cpu().numpy().view(np.uint32)
    return values, taxids


def delta_stream(values: np.ndarray, prev: int = 0) -> np.ndarray:
    """Sorted uint64 values -> Metabuli's diffIdx u16 stream: each
    difference from the value before in 15-bit chunks, most significant
    first, the last with its top bit set (``IndexCreator.cpp:874-892``)."""
    d = np.empty(len(values), np.uint64)
    if not len(values):
        return np.zeros(0, np.uint16)
    d[0] = values[0] - np.uint64(prev)
    np.subtract(values[1:], values[:-1], out=d[1:])
    n = np.ones(len(d), np.int64)
    for s in (15, 30, 45, 60):
        n += d >= np.uint64(1 << s)
    end = np.cumsum(n) - 1
    out = np.zeros(int(end[-1]) + 1, np.uint16)
    for j in range(5):  # chunk j counted from the last
        sel = n > j
        chunk = ((d[sel] >> np.uint64(15 * j)) & np.uint64(0x7FFF))
        out[end[sel] - j] = chunk.astype(np.uint16) | np.uint16(
            0x8000 if j == 0 else 0)
    return out


def write_db(db_dir: str, cfg: dict, values: np.ndarray,
             taxids: np.ndarray, nodes, names, step: int = 1 << 24) -> None:
    """The program's DB files."""
    os.makedirs(db_dir, exist_ok=True)
    prev = 0
    with open(os.path.join(db_dir, "diffIdx"), "wb") as fh:
        for a in range(0, len(values), step):
            delta_stream(values[a:a + step], prev).tofile(fh)
            prev = int(values[min(a + step, len(values)) - 1])
    taxids.tofile(os.path.join(db_dir, "info"))
    p = cfg["db"]
    with open(os.path.join(db_dir, "db.parameters"), "w") as fh:
        fh.write(f"DB_name\t{cfg['name']}\nCreation_date\t\n"
                 "Metabuli commit used to create the DB\tperfbench\n"
                 f"Reduced_alphabet\t0\nAccession_level\t0\nMask_mode\t0\n"
                 f"Mask_prob\t0.900000\n"
                 f"Skip_redundancy\t{p['skip_redundancy']}\n"
                 f"Syncmer\t0\nKmer_format\t{p['kmer_format']}\n")
    with open(os.path.join(db_dir, "taxID_list"), "w") as fh:
        fh.write("".join(f"{int(t)}\n" for t in np.unique(taxids)))
    world.write_taxonomy(os.path.join(db_dir, "taxonomy"), nodes, names)


def db_stamp(cfg: dict) -> str:
    """What of a configuration makes its DB (not its classify settings)."""
    return json.dumps({k: cfg[k] for k in ("name", "rows", "world",
                                           "decoys", "db")}, sort_keys=True)


def make(cfg: dict, root: str, device) -> dict:
    """Make the DB under ``root`` and mark it complete."""
    t0 = time.perf_counter()
    db = Db(root, cfg)
    values, taxids = table(cfg, db.genomes, device)
    t1 = time.perf_counter()
    write_db(db.db_dir, cfg, values, taxids, db.nodes, db.names)
    values.tofile(os.path.join(root, "values.u64"))
    os.sync()  # written back before any run reads it
    info = {"config": db_stamp(cfg),
            "rows": int(len(values)), "table_s": t1 - t0,
            "write_s": time.perf_counter() - t1,
            "disk_bytes": db.disk_bytes()}
    with open(os.path.join(root, "done.json"), "w") as fh:
        json.dump(info, fh)
    return info


def ensure(cfg: dict, cache_root: str, device, log=print) -> Db:
    """The configuration's DB, made on its first use in this checkout
    (under a lock, in a process of its own, so that the run goes on as a
    later run starts: with the DB on disk and nothing of its making in
    memory)."""
    root = os.path.join(cache_root, cfg["name"])
    os.makedirs(cache_root, exist_ok=True)
    stamp = db_stamp(cfg)
    done = os.path.join(root, "done.json")
    with open(os.path.join(cache_root, cfg["name"] + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(done):
            with open(done) as fh:
                if json.load(fh).get("config") == stamp:
                    return Db(root, cfg)
        shutil.rmtree(root, ignore_errors=True)
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        subprocess.run([sys.executable, "-m", "harness.dbcache", stamp, root,
                        str(device)], env=env, check=True)
        with open(done) as fh:
            info = json.load(fh)
        log(f"made the {cfg['name']} DB: rows {info['rows']}, "
            f"table {info['table_s']:.1f} s, write {info['write_s']:.1f} s, "
            f"{info['disk_bytes']} bytes")
    return Db(root, cfg)


if __name__ == "__main__":
    make(json.loads(sys.argv[1]), sys.argv[2], sys.argv[3])
