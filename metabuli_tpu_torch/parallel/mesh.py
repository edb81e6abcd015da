"""Multi-process classify: the metamer table range-partitioned over a
(data, db) grid of ranks.

Counterpart of ``metabuli_tpu.parallel.mesh`` on ``torch.distributed``
(the reference is single-node, `SURVEY.md` §2.8):

  data -- read batches split across the grid's rows (data parallelism),
  db   -- the sorted metamer table cut by amino-acid prefix across its
          columns (the scaled-out ``split`` file of the reference,
          `IndexCreator.cpp:844-858`).

Shard bounds fall on amino-acid group bounds (``chunked.chunk_bounds``,
the rule the reference package's sharding and chunking share), so every
query's candidate window and min-Hamming cutoff (`KmerMatcher.cpp:1117-1146`)
lie in one shard: a shard's matches are complete for the groups it holds.
Each shard is a plain-layout ``DevIndex`` on its rank's device. A data
row's ranks then gather their match columns over the db axis and merge
them with the match core's one stable sort, as a chunked index's chunks
are merged (``pipeline.sort_matches``).

A mesh with a process group holds one (data, db) cell a process; its
collectives (``Mesh.gather_db``, ``all_to_all_db``, ``agree``) take device
tensors on NCCL and go through pinned host buffers on gloo with a card
(two ranks on one card, which NCCL refuses). A one-process mesh
(``--db-shards N`` alone) holds all N shards of one data row on its one
device and gathers by concatenation, as the reference package's
single-process mesh spans its local devices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..classify.chunked import chunk_bounds
from ..classify.pipeline import (Block, MatchColumns, build_dev_index,
                                 cat_columns, match_blocks, sort_matches)

INT32_MAX = 2**31 - 1
# counts["tax_overflow"] bit of the all_to_all route: a segment of the
# row outgrew its block (``a2a_budget``); the caller runs the batch again
# with ``a2a_budget = counts["a2a_segment"]``
A2A_OVERFLOW = 1 << 8


@dataclass
class Mesh:
    """The (data, db) grid: ``n_data`` x ``n_db`` cells, this process's
    rank, device and collectives. ``backend`` is None for a one-process
    mesh without a process group."""

    n_data: int
    n_db: int
    device: torch.device
    rank: int = 0
    world: int = 1
    backend: str | None = None
    db_group: object = None
    # collectives of the db axis over the run: calls, bytes received,
    # host-clock ms (staging copies and the wait for the device included)
    stats: dict = field(default_factory=lambda: {
        "gathers": 0, "gather_bytes": 0, "gather_ms": 0.0})

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def data_row(self) -> int:
        return self.rank // self.n_db

    @property
    def db_cols(self) -> list[int]:
        """The db shards this process holds."""
        return [self.rank % self.n_db] if self.grouped else list(
            range(self.n_db))

    @property
    def writer(self) -> bool:
        """Whether this process writes its data row's reads: the row's
        db rank 0, as the reference package drains each row from its
        first db device."""
        return self.rank % self.n_db == 0

    # ------------------------------------------------------ collectives
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _comm_device(self) -> torch.device:
        return torch.device("cpu") if self._staged() else self.device

    def _out(self, t: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        """``t`` for the transport, padded to ``rows`` along dim 0: itself
        (or a padded copy) on the device for NCCL and on the CPU, a pinned
        host copy for gloo with a card."""
        rows = t.shape[0] if rows is None else rows
        if not self._staged() and rows == t.shape[0]:
            return t.contiguous()
        buf = torch.empty((rows, *t.shape[1:]), dtype=t.dtype,
                          device=self._comm_device(),
                          pin_memory=self._staged())
        buf[:t.shape[0]].copy_(t)
        return buf

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged() else t

    def _clock(self, t0: float, nbytes: int):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += nbytes
        self.stats["gather_ms"] += (time.perf_counter() - t0) * 1e3

    def gather_header(self, header: list[int]) -> list[list[int]]:
        """Every db rank's ``header`` ints (counters, sizes), in db order:
        one all_gather of a small int64 tensor."""
        if not self.grouped:
            return [list(header)]
        import torch.distributed as dist

        head = torch.tensor(header, dtype=torch.int64,
                            device=self._comm_device())
        heads = [torch.empty_like(head) for _ in range(self.n_db)]
        dist.all_gather(heads, head, group=self.db_group)
        return torch.stack(heads).cpu().tolist()

    def gather_db(self, rows: torch.Tensor, header: list[int]):
        """Every db shard's rows of this data row, in db order, and each
        process's ``header`` ints: ``([rows], [header])`` in a one-process
        mesh; else an all_gather over the db group of the variable-length
        rows (the headers with the row counts first, then the rows padded
        to the longest, then trimmed)."""
        if not self.grouped:
            return [rows], [list(header)]
        import torch.distributed as dist

        t0 = time.perf_counter()
        heads = self.gather_header([rows.shape[0], *header])
        sizes = [h[0] for h in heads]
        send = self._out(rows, max(sizes))
        outs = [torch.empty_like(send) for _ in range(self.n_db)]
        dist.all_gather(outs, send, group=self.db_group)
        got = [self._in(o[:n]) for o, n in zip(outs, sizes)]
        self._clock(t0, sum(sizes) * rows.shape[1] * rows.element_size())
        return got, [h[1:] for h in heads]

    def all_to_all_db(self, outbound: list[torch.Tensor]):
        """``outbound[s]``: local shard s's blocks [n_db, B, C], block j
        for db rank j. Returns, for each local db rank j, its inbound
        [n_db, B, C]: block j of every shard, in db order."""
        if not self.grouped:
            return [torch.stack([o[j] for o in outbound])
                    for j in range(self.n_db)]
        import torch.distributed as dist

        t0 = time.perf_counter()
        (o,) = outbound
        send = self._out(o)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.db_group)
        self._clock(t0, recv.numel() * recv.element_size())
        return [self._in(recv)]

    def agree(self, values: list[int], op: str = "max",
              world: bool = False) -> list[int]:
        """``values`` reduced elementwise (``op`` "max" or "min") over the
        db group, or over every process (``world``): choices the ranks
        must share. A one-process mesh holds the whole group: the values
        themselves."""
        if not self.grouped:
            return [int(v) for v in values]
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.int64,
                         device=self._comm_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.MIN,
                        group=None if world else self.db_group)
        return [int(v) for v in t.tolist()]

    def barrier(self):
        if not self.grouped:
            return
        import torch.distributed as dist

        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


# ------------------------------------------------------------ the index
class Shards:
    """This process's db shards of the table, as the match core scans
    them: one resident ``DevIndex`` after another (``on_device``), as a
    chunked index yields its chunks."""

    def __init__(self, indexes: list, reduced: bool, kmer_format: int):
        self.indexes = indexes
        self.reduced = reduced
        self.kmer_format = kmer_format

    @property
    def rows(self) -> int:
        return sum(ix.n for ix in self.indexes)

    def on_device(self, mark=None):
        yield from self.indexes


def shard_index_aa_aligned(values: np.ndarray, taxids: np.ndarray,
                           n_shards: int, kmer_format: int = 2,
                           reduced: bool = False, shards=None,
                           device="cpu"):
    """Cut the sorted table into ``n_shards`` AA-aligned ranges and build
    the ``shards`` among them (default all) as plain-layout ``DevIndex``
    tables on ``device``. Returns (every shard's (first, end) rows,
    ``Shards``). An empty range builds an index no query reaches."""
    bounds = chunk_bounds(values, n_shards, reduced)
    keep = range(n_shards) if shards is None else shards
    indexes = [build_dev_index(values[a:b], taxids[a:b], kmer_format,
                               device=device, reduced=reduced)
               for a, b in (bounds[j] for j in keep)]
    return bounds, Shards(indexes, reduced, kmer_format)


# ------------------------------------------------------------- the steps
def stack_columns(m: MatchColumns) -> torch.Tensor:
    """Match columns as one int32 [M, 6] tensor (one collective moves a
    part)."""
    return torch.stack([c.to(torch.int32) for c in m], 1)


def unstack_columns(rows: torch.Tensor) -> MatchColumns:
    return MatchColumns(*rows.unbind(1))


def sharded_classify(mesh: Mesh, shards: Shards, t2s, blocks: list[Block],
                     *, cap: int, syncmer: bool = False, smer_len: int = 5,
                     plain: bool = False, timer=None):
    """The sharded classify step (``build_sharded_classify``): this
    process's shards' matches for its data row's reads, in the blocks the
    single card takes (``pipeline.match_blocks``: K1 once a block, K2 and
    the fetch per shard and block), the db axis's gather of the match
    columns and the one merge sort. Returns the row's sorted
    ``MatchColumns`` and its counters: matches and over-cap slots summed
    over the shards, k-mers counted once (every shard saw the same
    reads)."""
    mark = timer.mark if timer is not None else (lambda name: None)
    parts, c = match_blocks(shards, t2s, blocks, cap=cap, syncmer=syncmer,
                            smer_len=smer_len, plain=plain, timer=timer)
    got, heads = mesh.gather_db(stack_columns(cat_columns(parts)),
                                [c["n_over_cap"], int(c["total_kmers"])])
    mark("gather")
    rows = got[0] if len(got) == 1 else torch.cat(got)
    m = sort_matches(unstack_columns(rows), shards.reduced)
    mark("sort")
    return m, {"n_matches": int(rows.shape[0]),
               "n_over_cap": sum(h[0] for h in heads),
               "total_kmers": heads[0][1]}


def sharded_fused(mesh: Mesh, shards: Shards, t2s, dtx, read_lens,
                  blocks: list[Block], *, cap: int,
                  syncmer: bool = False, smer_len: int = 5,
                  route: str = "gather", a2a_budget: int = 0,
                  plain: bool = False, timer=None):
    """The sharded fused step (``build_sharded_fused``): the match core
    per shard, then the device taxonomer's tail (``dtx.tail``) on merged
    columns. Returns one (tail handle for ``dtx.start_drain``, counters)
    per output this process holds.

    route="gather": the db axis gathers every shard's columns and each db
    rank merges them all and runs the tail on the row's reads: one output,
    the same on every db rank of the row. Where one process holds the row
    (a one-process mesh, or one shard a row), the classifier's route.

    route="alltoall": the row's reads (local qids ``0..len(read_lens)``)
    are cut into ``n_db`` ranges of ``stride`` reads; each shard's rows
    (its blocks' parts, concatenated), sorted by qid, are cut at ``stride * arange(n_db + 1)`` into blocks of
    ``a2a_budget`` rows (0: the rule ``max(1024, 2 * row matches //
    n_db)``), one all_to_all hands each db rank every shard's block of its
    range, and each merges and tails only those: one output per local db
    rank, results only for its range. Where the row's shards lie in
    several processes, the classifier's route: no rank tails reads it
    does not write. A segment longer than the budget is cut; every rank of the row then sets ``A2A_OVERFLOW`` in
    ``counts["tax_overflow"]`` and carries the row's longest segment in
    ``counts["a2a_segment"]``, the budget a run again needs."""
    mark = timer.mark if timer is not None else (lambda name: None)
    tail = lambda m: dtx.tail(m, read_lens, plain=plain, timer=timer)
    if route == "gather":
        m, counts = sharded_classify(
            mesh, shards, t2s, blocks, cap=cap, syncmer=syncmer,
            smer_len=smer_len, plain=plain, timer=timer)
        return [(tail(m), counts)]
    if route != "alltoall":
        raise ValueError(f"unknown route {route!r}")

    parts, c = match_blocks(shards, t2s, blocks, cap=cap, syncmer=syncmer,
                            smer_len=smer_len, plain=plain, timer=timer)
    # the parts are shard-major: each local shard's blocks in turn
    nb = len(blocks)
    local = [stack_columns(cat_columns(parts[i:i + nb]))
             for i in range(0, len(parts), nb)]
    n_db, dev = mesh.n_db, blocks[0].codes.device
    # the row's counters first: the budget rule needs its match count
    heads = mesh.gather_header([sum(r.shape[0] for r in local),
                                c["n_over_cap"], int(c["total_kmers"])])
    row_matches = sum(h[0] for h in heads)
    budget = a2a_budget or max(1024, 2 * row_matches // n_db)
    stride = -(-len(read_lens) // n_db)
    edges = stride * torch.arange(n_db + 1, dtype=torch.int32, device=dev)
    outbound, longest = [], 0
    for rows in local:
        rows = rows[torch.sort(rows[:, 0], stable=True)[1]]
        cut = torch.searchsorted(rows[:, 0].contiguous(), edges).tolist()
        blocks = torch.full((n_db, budget, 6), INT32_MAX, dtype=torch.int32,
                            device=dev)
        for j in range(n_db):
            seg = cut[j + 1] - cut[j]
            longest = max(longest, seg)
            k = min(seg, budget)
            blocks[j, :k] = rows[cut[j]:cut[j] + k]
        outbound.append(blocks)
    (longest,) = mesh.agree([longest])
    inbound = mesh.all_to_all_db(outbound)
    mark("gather")
    out = []
    for recv in inbound:
        rows = recv.reshape(-1, 6)
        rows = rows[rows[:, 0] != INT32_MAX]
        m = sort_matches(unstack_columns(rows), shards.reduced)
        mark("sort")
        out.append((tail(m), {
            "n_matches": int(rows.shape[0]),
            "n_over_cap": sum(h[1] for h in heads),
            "total_kmers": heads[0][2],
            "tax_overflow": A2A_OVERFLOW if longest > budget else 0,
            "a2a_segment": longest}))
    return out
