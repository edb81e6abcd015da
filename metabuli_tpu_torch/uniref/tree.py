"""UniRef cluster tree: root -> UniRef50 -> UniRef90 -> UniRef100.

Re-provides `/root/reference/src/uniref/UnirefTree.{h,cpp}`: a 4-level tree
of cluster names with parent links, built from a UniRef100 XML dump (the
reference parses it with yxml; we use xml.etree.iterparse). Ranks: 1 root,
2 UniRef50, 3 UniRef90, 4 UniRef100 (`UnirefTree.h:16-23`).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

_NS = "{http://uniprot.org/uniref}"


@dataclass
class UnirefTree:
    parent: np.ndarray            # [N] uint32 (0 = root's parent = itself)
    rank: np.ndarray              # [N] uint8
    names: list[str]
    name2id: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.name2id:
            self.name2id = {n: i for i, n in enumerate(self.names)}

    def is_ancestor(self, anc: int, desc: int) -> bool:
        node = int(desc)
        for _ in range(5):
            if node == anc:
                return True
            p = int(self.parent[node])
            if p == node:
                break
            node = p
        return node == anc

    def lca2(self, a: int, b: int) -> int:
        ancestors = []
        node = int(a)
        for _ in range(5):
            ancestors.append(node)
            p = int(self.parent[node])
            if p == node:
                break
            node = p
        node = int(b)
        for _ in range(5):
            if node in ancestors:
                return node
            p = int(self.parent[node])
            if p == node:
                break
            node = p
        return 0

    def lca(self, ids) -> int:
        ids = list(ids)
        if not ids:
            return 0
        acc = ids[0]
        for i in ids[1:]:
            acc = self.lca2(acc, i)
        return acc

    def save(self, path: str):
        np.savez_compressed(
            path, parent=self.parent, rank=self.rank,
            names=np.array(self.names, dtype=object),
        )

    @classmethod
    def load(cls, path: str) -> "UnirefTree":
        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path, allow_pickle=True)
        return cls(parent=z["parent"], rank=z["rank"], names=list(z["names"]))

    def dump(self, path: str):
        with open(path, "w") as fh:
            for i, name in enumerate(self.names):
                fh.write(f"{i}\t{int(self.parent[i])}\t{int(self.rank[i])}\t{name}\n")


def iter_uniref_entries(xml_path: str):
    """Yield (uniref100_id, uniref90_id, uniref50_id, sequence) per entry.

    Reads UniRef100 XML: entry id, 'UniRef90 ID'/'UniRef50 ID' properties of
    the representative member, and the representative sequence.
    """
    for _, entry in ET.iterparse(xml_path):
        if entry.tag not in (f"{_NS}entry", "entry"):
            continue
        ns = _NS if entry.tag.startswith(_NS) else ""
        u100 = entry.get("id", "")
        u90 = u50 = ""
        seq = b""
        rep = entry.find(f"{ns}representativeMember")
        if rep is not None:
            for prop in rep.iter(f"{ns}property"):
                if prop.get("type") == "UniRef90 ID":
                    u90 = prop.get("value", "")
                elif prop.get("type") == "UniRef50 ID":
                    u50 = prop.get("value", "")
            seq_el = rep.find(f"{ns}sequence")
            if seq_el is not None and seq_el.text:
                seq = "".join(seq_el.text.split()).encode()
        yield u100, u90, u50, seq
        entry.clear()


def build_tree(xml_path: str) -> UnirefTree:
    names = ["root"]
    parent = [0]
    rank = [1]
    idx: dict[str, int] = {"root": 0}

    def add(name: str, par_id: int, r: int) -> int:
        if name in idx:
            return idx[name]
        idx[name] = len(names)
        names.append(name)
        parent.append(par_id)
        rank.append(r)
        return idx[name]

    for u100, u90, u50, _ in iter_uniref_entries(xml_path):
        p50 = add(u50, 0, 2) if u50 else 0
        p90 = add(u90, p50, 3) if u90 else p50
        if u100:
            add(u100, p90, 4)
    return UnirefTree(
        parent=np.array(parent, np.uint32),
        rank=np.array(rank, np.uint8),
        names=names,
        name2id=idx,
    )
