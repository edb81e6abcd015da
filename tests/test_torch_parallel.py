"""The port's sharded index and sharded steps (``parallel.mesh``) against
the JAX package's ``parallel.mesh`` on the same seeded inputs, with
tolerance zero: the AA-aligned shards' bounds and tables (2, 3 and 4
shards; format 2, format 1, reduced), the fused step's gather and
all_to_all routes on a one-process mesh and, through the CLI, spawned over
gloo worlds of 2 and 4 processes (per read equal to the port's single
fused path and to JAX's ``build_sharded_fused`` on the CPU mesh, the
world of tests/test_sharded_fused.py), the all_to_all budget's overflow
bit, and the plain route, reduced alphabet included. The one-process
steps also take a batch of mixed read lengths in several length blocks
(``pipeline.length_blocks``), as the single card does."""

import pathlib

import jax
import numpy as np
import pytest
import torch

from helpers import jax_native
from metabuli_tpu.classify.device_taxonomer import (
    DeviceTaxonomer as JaxDeviceTaxonomer)
from metabuli_tpu.classify.pipeline import (classify_batch as jax_batch,
                                            matches_to_host as jax_to_host)
from metabuli_tpu.classify.taxonomer import (
    TaxonomerParams as JaxTaxonomerParams)
from metabuli_tpu.db.taxonomy import Taxonomy as JaxTaxonomy
from metabuli_tpu.io.report import Reporter as JaxReporter
from metabuli_tpu.ops import encode as jenc
from metabuli_tpu.ops.genetic_code import encode_seqs_padded
from metabuli_tpu.parallel import dist_classify as jdist
from metabuli_tpu.parallel import mesh as jmesh
from metabuli_tpu_torch.classify.device_taxonomer import DeviceTaxonomer
from metabuli_tpu_torch.classify.pipeline import (FIELDS, Block,
                                                  build_dev_index,
                                                  classify_core,
                                                  length_blocks,
                                                  matches_to_host)
from metabuli_tpu_torch.classify.taxonomer import TaxonomerParams
from metabuli_tpu_torch.db.formats import DbParameters
from metabuli_tpu_torch.db.index import MetamerIndex
from metabuli_tpu_torch.db.taxonomy import Taxonomy
from metabuli_tpu_torch.io.report import Reporter
from metabuli_tpu_torch.parallel import mesh
from test_torch_distributed import free_port, spawn_ranks

ACGT = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")
# padded bases a block for the mixed-length batches here (2^22 on the card)
LIMIT = 600


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    """The JAX side on its native path, wherever this module runs."""
    jax_native.loaded()


def _world(kmer_format=2, reduced=False, seed=9):
    """16 wobble-diverged copies of a 1.5 kb core beside 500 bp of their
    own (deep AA groups, so shard bounds must move to group ends): values
    unique per (value, genome), sorted, by the JAX package's extraction;
    32 reads with two substitutions each."""
    rng = np.random.default_rng(seed)
    core = rng.choice(ACGT, 1500)
    genomes = []
    for _ in range(16):
        c = core.copy()
        w = np.arange(2, len(c), 3)
        m = w[rng.random(len(w)) < 0.15]
        c[m] = ACGT[(np.searchsorted(ACGT, c[m])
                     + rng.integers(1, 4, len(m))) % 4]
        genomes.append(bytes(c) + bytes(rng.choice(ACGT, 500)))
    vs, ts = [], []
    for g, seq in enumerate(genomes):
        codes, lens = encode_seqs_padded([seq])
        mm = jenc.extract_metamers(codes, lens, reduced=reduced,
                                   kmer_format=kmer_format)
        v = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])
        vs.append(v)
        ts.append(np.full(len(v), g + 2, np.int32))
    values, taxids = np.concatenate(vs), np.concatenate(ts)
    o = np.lexsort((taxids, values))
    reads = []
    for i in range(32):
        g = genomes[i % 16]
        st = int(rng.integers(0, len(g) - 150))
        r = np.frombuffer(g[st:st + 150], np.uint8).copy()
        s = rng.choice(150, 2, replace=False)
        r[s] = ACGT[(np.searchsorted(ACGT, r[s]) + 1) % 4]
        reads.append(r.tobytes())
    t2s = (np.arange(32, dtype=np.int32) % 7) + 1
    return values[o], taxids[o], t2s, reads


def _mixed(reads, seed):
    """``reads`` cut to 60-150 bases (the first kept whole) and their
    read lengths (whole codons)."""
    n = np.random.default_rng(seed).integers(60, 151, len(reads))
    n[0] = 150
    return ([r[:k] for r, k in zip(reads, n)],
            (3 * ((n - 2) // 3)).astype(np.int32))


def _blocks(codes, lens, pos, qid, limit=None):
    """A batch's ``Block``s as the classifier uploads them: the whole
    matrix as one block, or (``limit``) the length blocks of at most
    ``limit`` padded bases, each cut to its longest row; at least 3."""
    arrays = [np.asarray(a) for a in (codes, lens, pos, qid)]
    if limit is None:
        return [Block(*(torch.from_numpy(a) for a in arrays))]
    cut = length_blocks(arrays[1], limit)
    assert len(cut) >= 3
    out = []
    for rows in cut:
        width = int(arrays[1][rows].max())
        out.append(Block(*(torch.from_numpy(np.ascontiguousarray(a))
                           for a in (arrays[0][rows, :width],
                                     *(x[rows] for x in arrays[1:])))))
    return out


def _group_keys(prefix, grest, n_groups, key_bits):
    """Each group's whole permuted key: its bucket (from the prefix
    table) above its rest bits."""
    pb = (len(prefix) - 1).bit_length() - 1
    bucket = np.searchsorted(prefix, np.arange(n_groups), side="right") - 1
    rest = np.asarray(grest[:n_groups], np.int64) & ((1 << (key_bits - pb))
                                                      - 1)
    return (bucket.astype(np.int64) << (key_bits - pb)) | rest


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("kind", ["format2", "format1", "reduced"])
def test_shard_tables_equal_jax(kind, n_shards):
    """Bounds, group order, extents and keys, and every real row of each
    shard equal JAX's ``shard_index_aa_aligned`` (whose prefix width
    comes from the fullest shard and whose shards are padded)."""
    fmt, reduced = (1 if kind == "format1" else 2), kind == "reduced"
    values, taxids, _, _ = _world(fmt, reduced)
    jdb, _, _ = jmesh.shard_index_aa_aligned(values, taxids, n_shards, fmt,
                                             reduced)
    bounds, shards = mesh.shard_index_aa_aligned(values, taxids, n_shards,
                                                 fmt, reduced)
    kb = 32 if reduced else 40
    assert bounds[0][0] == 0 and bounds[-1][1] == len(values)
    assert len(shards.indexes) == n_shards
    for i, ((a, b), ix) in enumerate(zip(bounds, shards.indexes)):
        jprefix = jdb[5][i]
        g = int(jprefix[-1])
        assert b - a == ix.n == (int(jdb[2][i][:g].max()) if g else 0) > 0
        prefix = ix.bucket_prefix()
        assert int(prefix[-1]) == g
        assert np.array_equal(ix.gstart.numpy(), jdb[1][i][:g])
        assert np.array_equal(ix.gend.numpy(), jdb[2][i][:g])
        assert np.array_equal(
            _group_keys(prefix.numpy(), ix.grest.numpy(), g, kb),
            _group_keys(jprefix, jdb[0][i], g, kb))
        td = ix.taxdna.numpy().view(np.uint64)
        if reduced:  # the shard carries its bucket records and codon words
            assert ix.prefix is None and ix.brec.shape == (
                (1 << ix.prefix_bits) + 1, 4)
            assert np.array_equal(ix.tword.numpy().view(np.uint32),
                                  (td >> np.uint64(32)).astype(np.uint32))
            assert np.array_equal((td >> np.uint64(32)).astype(np.uint32),
                                  jdb[3][i][:b - a].view(np.uint32))
            assert np.array_equal(td.astype(np.uint32).view(np.int32),
                                  jdb[4][i][:b - a])
        else:
            assert np.array_equal(td, jdb[3][i][:b - a])
            assert np.array_equal(ix.d48.numpy().view(np.uint64),
                                  jdb[4][i][:b - a])


# ------------------------------------------------------------ fused step
def _taxonomy_files(d):
    """4 genera of 2 species under Bacteria (tests/test_sharded_fused.py's
    taxonomy) as dmp files under ``d/taxonomy``."""
    nodes = [(1, 1, "no rank"), (2, 1, "superkingdom")]
    names = {1: "root", 2: "Bacteria"}
    tid = 3
    for g in range(4):
        gid = tid
        nodes.append((tid, 2, "genus"))
        names[tid] = f"G{g}"
        tid += 1
        for s in range(2):
            nodes.append((tid, gid, "species"))
            names[tid] = f"S{g}_{s}"
            tid += 1
    t = pathlib.Path(d, "taxonomy")
    t.mkdir(parents=True)
    (t / "nodes.dmp").write_text(
        "".join(f"{a}\t|\t{p}\t|\t{r}\t|\n" for a, p, r in nodes))
    (t / "names.dmp").write_text("".join(
        f"{a}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
        for a, n in names.items()))
    (t / "merged.dmp").write_text("")
    return [str(t / f) for f in ("names.dmp", "nodes.dmp", "merged.dmp")]


@pytest.fixture(scope="module")
def fused_world(tmp_path_factory):
    """8 species of 8 kb random genomes, each genome's metamers unique,
    sorted (values, taxids); 32 reads of 150 bp with one substitution and
    4 random reads of them; both packages' taxonomies and taxonomers; the
    port's single fused path's classification line of every read."""
    d = tmp_path_factory.mktemp("fused")
    dmp = _taxonomy_files(d)
    tax, jtax = Taxonomy.from_dmp(*dmp), JaxTaxonomy.from_dmp(*dmp)
    rng = np.random.default_rng(3)
    sp = [i for i in range(1, tax.n_nodes() + 1)
          if tax.rank_of(i) == "species"]
    genomes = [(bytes(rng.choice(ACGT, 8000)), t) for t in sp]
    vs, ts = [], []
    for seq, t in genomes:
        codes, lens = encode_seqs_padded([seq])
        mm = jenc.extract_metamers(codes, lens)
        v = np.unique(np.asarray(mm.value)[np.asarray(mm.valid)])
        vs.append(v)
        ts.append(np.full(len(v), t, np.int32))
    values, taxids = np.concatenate(vs), np.concatenate(ts)
    o = np.lexsort((taxids, values))
    values, taxids = values[o], taxids[o]
    reads = []
    for i in range(32):
        g, _ = genomes[i % len(genomes)]
        st = int(rng.integers(0, len(g) - 150))
        r = bytearray(g[st:st + 150])
        r[40] = ord("A") if r[40] != ord("A") else ord("T")
        reads.append(bytes(r) if i % 8 else bytes(rng.choice(ACGT, 150)))
    names = [f"r{i}" for i in range(32)]
    rl = np.full(32, 3 * ((150 - 2) // 3), np.int32)
    aa = values >> np.uint64(24)
    cap = int(np.diff(np.r_[-1, np.nonzero(aa[1:] != aa[:-1])[0],
                            len(aa) - 1]).max())
    tp = TaxonomerParams(seq_mode=1)
    dtx = DeviceTaxonomer(tp, tax, CPU)
    t2s = torch.from_numpy(tax.species_of.astype(np.int32))
    w = dict(dir=d, tax=tax, jtax=jtax, values=values, taxids=taxids,
             names=names, cap=cap, dtx=dtx, t2s=t2s, reporter=Reporter(tax))
    w.update(_single(w, reads, rl))
    assert sum(ln.startswith("1\t") for ln in w["single"]) >= 24
    return w


def _single(w, reads, rl):
    """``reads`` (read lengths ``rl``) as one batch through the port's
    single fused path: the batch as one matrix (``batch``: codes,
    lengths, offsets, qids), its match counters and every read's
    classification line."""
    n = len(reads)
    codes, lens = encode_seqs_padded(reads)
    batch = tuple(torch.from_numpy(a) for a in (
        codes, lens, np.zeros(n, np.int32), np.arange(n, dtype=np.int32)))
    m, counts = classify_core(build_dev_index(w["values"], w["taxids"]),
                              w["t2s"], *batch, cap=w["cap"])
    dtx = w["dtx"]
    res = dtx.drain(dtx.start_drain(dtx.tail(m, rl)), rl, n)
    single = [w["reporter"].classification_row(nm, rc, int(r))
              for nm, rc, r in zip(w["names"], res, rl)]
    return dict(reads=reads, rl=rl, batch=batch, counts=counts,
                single=single)


@pytest.fixture(scope="module")
def mixed_world(fused_world):
    """fused_world's reads cut to 60-150 bases, through the single fused
    path (``_single``) and JAX's sharded fused step (``jax``: each
    route's lines)."""
    w = dict(fused_world)
    w.update(_single(w, *_mixed(w["reads"], 11)))
    w["jax"] = _jax_fused(w)
    assert sum(ln.startswith("1\t") for ln in w["single"]) >= 20
    return w


def _lines(w, m, outs, route):
    """Each output's classification lines of the reads it owns."""
    lines = {}
    n = len(w["rl"])
    stride = -(-n // m.n_db)
    for j, (handle, _) in zip(m.db_cols, outs):
        res = w["dtx"].drain(w["dtx"].start_drain(handle), w["rl"], n)
        own = range(n) if route == "gather" else range(
            j * stride, min((j + 1) * stride, n))
        for q in own:
            lines[q] = w["reporter"].classification_row(
                w["names"][q], res[q], int(w["rl"][q]))
    return [lines[q] for q in range(n)]


@pytest.mark.parametrize("n_db", [2, 3])
@pytest.mark.parametrize("route,blocks", [
    pytest.param("gather", False, id="gather"),
    pytest.param("alltoall", False, id="alltoall"),
    pytest.param("gather", True, id="gather-blocks"),
    pytest.param("alltoall", True, id="alltoall-blocks")])
def test_one_process_fused_equals_single(request, route, blocks, n_db):
    """A one-process mesh of ``n_db`` shards (gathered by concatenation,
    the all_to_all by regrouping): every read's line equals the single
    fused path's; the gather route's counters equal its counters. With
    ``blocks``, reads of mixed length in several length blocks: the
    lines equal the batch's as one matrix and JAX's."""
    w = request.getfixturevalue("mixed_world" if blocks else "fused_world")
    m = mesh.Mesh(1, n_db, CPU)
    _, shards = mesh.shard_index_aa_aligned(w["values"], w["taxids"], n_db)
    outs = mesh.sharded_fused(
        m, shards, w["t2s"], w["dtx"], w["rl"],
        _blocks(*w["batch"], LIMIT if blocks else None), cap=w["cap"],
        route=route)
    assert len(outs) == (1 if route == "gather" else n_db)
    assert _lines(w, m, outs, route) == w["single"]
    if blocks:
        assert w["single"] == w["jax"][route]
    if route == "gather":
        assert outs[0][1] == w["counts"]
    else:
        assert sum(c["n_matches"] for _, c in outs) == w["counts"][
            "n_matches"]
        assert all(c["tax_overflow"] == 0 for _, c in outs)


def test_grouped_alltoall_sends_each_shards_blocks_as_one(mixed_world):
    """The all_to_all route in a process group (one gloo rank, one db
    shard), on the mixed batch in length blocks: the exchange takes one
    outbound a local shard, its blocks' parts as one set of rows, and
    every read's line equals the batch's as one matrix."""
    import torch.distributed as tdist

    w = mixed_world
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:"
                             f"{free_port()}", world_size=1, rank=0)
    try:
        m = mesh.Mesh(1, 1, CPU, backend="gloo",
                      db_group=tdist.new_group([0]))
        _, shards = mesh.shard_index_aa_aligned(w["values"], w["taxids"], 1)
        outs = mesh.sharded_fused(
            m, shards, w["t2s"], w["dtx"], w["rl"],
            _blocks(*w["batch"], LIMIT), cap=w["cap"], route="alltoall")
    finally:
        tdist.destroy_process_group()
    assert m.stats["gathers"] == 1
    assert _lines(w, m, outs, "alltoall") == w["single"]


def test_alltoall_budget_overflow_then_exact(fused_world):
    """A 1-row budget cuts the segments: every output carries the
    overflow bit and the row's longest segment; a run at that budget
    equals the single path."""
    w = fused_world
    m = mesh.Mesh(1, 2, CPU)
    _, shards = mesh.shard_index_aa_aligned(w["values"], w["taxids"], 2)
    run = lambda budget: mesh.sharded_fused(
        m, shards, w["t2s"], w["dtx"], w["rl"], _blocks(*w["batch"]),
        cap=w["cap"], route="alltoall", a2a_budget=budget)
    outs = run(1)
    seg = outs[0][1]["a2a_segment"]
    assert seg > 1
    assert all(c["tax_overflow"] == mesh.A2A_OVERFLOW
               and c["a2a_segment"] == seg for _, c in outs)
    outs = run(seg)
    assert all(c["tax_overflow"] == 0 for _, c in outs)
    assert _lines(w, m, outs, "alltoall") == w["single"]


@pytest.fixture(scope="module")
def jax_fused_lines(fused_world):
    return _jax_fused(fused_world)


def _jax_fused(w):
    """JAX's ``build_sharded_fused`` on the 8-device CPU mesh (4 data rows
    x 2 db shards, 8 reads a row, local qids), both routes: every read's
    classification line."""
    jm = jmesh.make_mesh(jax.devices(), n_db=2)
    n_data, per_row = jm.shape["data"], 8
    codes, lens = (t.numpy() for t in w["batch"][:2])
    offs = np.zeros(32, np.int32)
    qids = np.tile(np.arange(per_row, dtype=np.int32), n_data)
    tp = JaxTaxonomerParams(seq_mode=1)
    dtx = JaxDeviceTaxonomer(tp, w["jtax"])
    t2s = w["jtax"].species_of.astype(np.int32)
    bm = jax_batch(w["values"], w["taxids"], t2s, codes, lens, offs,
                   np.arange(32, dtype=np.int32), cap=w["cap"],
                   max_matches=1 << 16)
    dtx.set_hints(jax_to_host(bm, t2s), tp.dna_shift)
    max_matches = 1 << 15
    sizes = dtx.fused_sizes(per_row, max_matches, int(w["rl"].max()))
    db, n_pad, iters = jmesh.shard_index_aa_aligned(w["values"],
                                                    w["taxids"], 2)
    rep = JaxReporter(w["jtax"])
    out = {}
    for route in ("gather", "alltoall"):
        step = jmesh.build_sharded_fused(
            jm, n_pad=n_pad, search_iters=iters, cap=w["cap"],
            max_matches=max_matches, sizes=sizes, route=route)
        packed, ovp, counts = (np.asarray(x) for x in step(
            db, t2s, dtx.dt, dtx.min_depth, w["rl"], codes, lens, offs,
            qids))
        lines = []
        stride = -(-per_row // 2)
        for row in range(n_data):
            rl = w["rl"][row * per_row:(row + 1) * per_row]
            got = [None] * per_row
            for rank in ((None,) if route == "gather" else range(2)):
                at = (row,) if rank is None else (row, rank)
                res, info = dtx.drain_fused(
                    (packed[at], ovp[at], counts[at], sizes), rl, per_row)
                assert info["tax_overflow"] == 0
                own = range(per_row) if rank is None else range(
                    rank * stride, (rank + 1) * stride)
                for q in own:
                    got[q] = res[q]
            lines += [rep.classification_row(w["names"][row * per_row + q],
                                             got[q], int(rl[q]))
                      for q in range(per_row)]
        out[route] = lines
    return out


@pytest.mark.parametrize("route", ["gather", "alltoall"])
def test_one_process_fused_equals_jax(fused_world, jax_fused_lines, route):
    """A one-process mesh of 2 shards, all 32 reads in one row: every
    read's line equals JAX's sharded fused step's on the route."""
    w = fused_world
    m = mesh.Mesh(1, 2, CPU)
    _, shards = mesh.shard_index_aa_aligned(w["values"], w["taxids"], 2)
    outs = mesh.sharded_fused(m, shards, w["t2s"], w["dtx"], w["rl"],
                              _blocks(*w["batch"]), cap=w["cap"],
                              route=route)
    assert _lines(w, m, outs, route) == jax_fused_lines[route]


@pytest.mark.parametrize("world", [2, 4], ids=["2x1", "2x2"])
def test_spawned_fused_equals_single_and_jax(fused_world, jax_fused_lines,
                                             world, tmp_path):
    """``classify`` over a gloo world of 2 shards a row (2 processes: 1 x
    2; 4: a 2 x 2 mesh), which takes the all_to_all route: every read's
    line equals the port's single fused path and JAX's sharded fused step
    on both routes, and every rank writes its range of its row's reads."""
    w = fused_world
    db = tmp_path / "db"
    # the searchable table leaves out the DB's last row: a sentinel
    values = np.r_[w["values"], np.uint64(2**64 - 1)]
    taxids = np.r_[w["taxids"], w["taxids"][-1]].astype(np.uint32)
    MetamerIndex(values, taxids, w["tax"], DbParameters(),
                 w["cap"]).save(str(db))
    reads = tmp_path / "reads.fna"
    reads.write_text("".join(f">{n}\n{r.decode()}\n"
                             for n, r in zip(w["names"], w["reads"])))
    out = tmp_path / "out"
    port = free_port()
    res = spawn_ranks([["metabuli_tpu_torch.cli", "classify", str(reads),
                        str(db), str(out), "j", "--seq-mode", "1",
                        "--batch-reads", "32", "--device", "cpu",
                        "--num-processes", str(world), "--process-id",
                        str(i), "--coordinator", f"localhost:{port}",
                        "--db-shards", "2"] for i in range(world)])
    for i, (rc, log) in enumerate(res):
        assert rc == 0, f"rank {i} exited {rc}:\n{log[-3000:]}"
    got = [ln for ln in (out / "j_classifications.tsv").read_text()
           .splitlines(keepends=True) if not ln.startswith("#")]
    assert got == w["single"]
    assert got == jax_fused_lines["gather"] == jax_fused_lines["alltoall"]
    per_rank = 32 // world
    for i in range(world):
        part = (out / f".j_part{i}.tsv").read_text().splitlines()
        assert [int(ln.split("\t")[0]) for ln in part] == list(
            range(i * per_rank, (i + 1) * per_rank))


# ----------------------------------------------------------- plain route
@pytest.mark.parametrize("kind,blocks", [
    pytest.param("format2", False, id="format2"),
    pytest.param("reduced", False, id="reduced"),
    pytest.param("format2", True, id="format2-blocks"),
    pytest.param("reduced", True, id="reduced-blocks")])
def test_plain_route_equals_single_and_jax(kind, blocks):
    """``sharded_classify`` (the plain route: gather, merge, then the host
    assign) on a one-process mesh of 2 and 3 shards: the host match dict
    equals the single index's and JAX's ``build_sharded_classify`` +
    ``merge_shard_matches`` on the CPU mesh, every field. With
    ``blocks``, reads of mixed length in several length blocks."""
    reduced = kind == "reduced"
    values, taxids, t2s, reads = _world(2, reduced)
    if blocks:
        reads, _ = _mixed(reads, 12)
    v, t = values[:-1], taxids[:-1]
    codes, lens = encode_seqs_padded(reads)
    n = len(reads)
    offs, qids = np.zeros(n, np.int32), np.arange(n, dtype=np.int32)
    aa = v >> np.uint64(32 if reduced else 24)
    cap = int(np.diff(np.r_[-1, np.nonzero(aa[1:] != aa[:-1])[0],
                            len(aa) - 1]).max())
    args = tuple(torch.from_numpy(a) for a in (t2s, codes, lens, offs, qids))
    m, c = classify_core(build_dev_index(v, t, reduced=reduced), *args,
                         cap=cap)
    want = matches_to_host(m)
    jm = jmesh.make_mesh(jax.devices(), n_db=2)
    db, n_pad, iters = jmesh.shard_index_aa_aligned(v, t, 2, reduced=reduced)
    step = jmesh.build_sharded_classify(
        jm, n_pad=n_pad, search_iters=iters, cap=cap, max_matches=1 << 16,
        reduced=reduced)
    jw = jmesh.merge_shard_matches(step(db, t2s, codes, lens, offs, qids), n,
                                   t2s)
    assert jw["n_matches"] == want["n_matches"] > 0
    for n_db in (2, 3):
        _, shards = mesh.shard_index_aa_aligned(v, t, n_db, reduced=reduced)
        got, counts = mesh.sharded_classify(
            mesh.Mesh(1, n_db, CPU), shards, args[0],
            _blocks(*args[1:], LIMIT if blocks else None), cap=cap)
        got = matches_to_host(got)
        assert counts == c
        for k in FIELDS:
            assert np.array_equal(got[k], want[k]), (n_db, k)
            assert np.array_equal(got[k], jw[k]), (n_db, k)
