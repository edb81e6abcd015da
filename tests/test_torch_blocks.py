"""The match core on a ragged batch in length-sorted blocks
(``pipeline.length_blocks``): on the CPU, the blocked run, the same batch
as one block and the JAX package write the same bytes (long reads with one
read 20 times the mean, under ``--mask-mode 1``, on a chunked index); a
batch of one length stays one block, handed to K1 as the reader made it;
the cutter's rules; the counters and the ``metabuli.block`` range."""

import os

import numpy as np
import pytest

from helpers import jax_native
from metabuli_tpu.cli import main as jax_main
from metabuli_tpu_torch.classify import chunked
from metabuli_tpu_torch.classify import classifier as port_classifier
from metabuli_tpu_torch.classify import device_taxonomer, pipeline
from metabuli_tpu_torch.classify.classifier import Classifier
from metabuli_tpu_torch.classify.pipeline import length_blocks
from metabuli_tpu_torch.cli import main as port_main
from metabuli_tpu_torch.csrc import build
from metabuli_tpu_torch.ops import encode
from metabuli_tpu_torch.params import ClassifyParams
from test_torch_slice7 import assert_same, fragments_world, outputs

# padded bases a block at the tiny sizes here (2^22 on the card)
LIMIT = 3000
FLAGS = ["--seq-mode", "3", "--batch-reads", "64"]


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native.loaded()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """fragments_world's DB (two 4 kb genomes) and 41 single reads: 40 of
    150-400 bases from either strand and, 18th, one of 6,000 bases (genome
    A, then the first 2 kb of B), 20 times their mean."""
    tmp = tmp_path_factory.mktemp("blocks")
    db, frags = fragments_world(tmp)
    a, b = frags[2][:4000], frags[2][4000:]
    rng = np.random.default_rng(77)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(40):
        g = (a, b)[i % 2]
        n = int(rng.integers(150, 401))
        st = int(rng.integers(0, len(g) - n))
        r = g[st:st + n]
        reads.append(r.translate(comp)[::-1] if i % 3 == 0 else r)
    lens = [len(r) for r in reads]
    reads.insert(17, a + b[:2000])
    assert len(reads[17]) == 6000 and 6000 >= 20 * np.mean(lens)
    q = tmp / "ragged.fna"
    q.write_text("".join(f">L{i}\n{r.decode()}\n"
                         for i, r in enumerate(reads)))
    return str(tmp), db, str(q), [len(r) for r in reads]


def run_port(out, q, db, flags, cut, record=None):
    """The port's CLI on the CPU with ``cut`` as its block cutter; each
    batch's blocks' (rows, width, bases) go to ``record``."""
    upload = Classifier._upload

    def recorded(self, codes, reads, batch):
        blocks = upload(self, codes, reads, batch)
        if record is not None:
            record.append([(b.codes.shape[0], b.codes.shape[1],
                            int(b.lens.sum())) for b in blocks])
        return blocks

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Classifier, "_cut_blocks", lambda self, lens: cut(lens))
        mp.setattr(Classifier, "_upload", recorded)
        assert port_main(["classify", q, db, out, "bl", *flags,
                          "--device", "cpu"]) == 0
    return outputs(out)


def check_blocks(batches, lens):
    """Every read in one block, each within LIMIT padded bases unless it
    is one row, and at most 1.25 times the bases padded in all."""
    (blocks,) = batches
    assert len(blocks) > 2
    assert sum(r for r, _, _ in blocks) == len(lens)
    assert sum(b for _, _, b in blocks) == sum(lens)
    assert all(r * w <= LIMIT or r == 1 for r, w, _ in blocks)
    assert (1, 6000, 6000) in blocks
    assert sum(r * w for r, w, _ in blocks) <= 1.25 * sum(lens)


@pytest.mark.parametrize("mask", [0, 1])
def test_blocks_equal_one_block_and_jax(world, mask):
    """Long reads, one of them 20 times the mean, in blocks: the same
    bytes as the batch as one matrix and as the JAX package, also under
    --mask-mode 1 (the blocks are cut from the masked codes), on the
    single card and on a one-process mesh of two db shards
    (``--db-shards 2``), which takes the same blocks."""
    root, db, q, lens = world
    flags = [*FLAGS, "--mask-mode", str(mask)]
    out = os.path.join(root, f"jax_m{mask}")
    assert jax_main(["classify", q, db, out, "bl", *flags]) == 0
    want = outputs(out)
    batches, sharded_batches = [], []
    blocked = run_port(os.path.join(root, f"blocked_m{mask}"), q, db, flags,
                       lambda ln: length_blocks(ln, LIMIT), batches)
    sharded = run_port(os.path.join(root, f"sharded_m{mask}"), q, db,
                       [*flags, "--db-shards", "2"],
                       lambda ln: length_blocks(ln, LIMIT), sharded_batches)
    one = run_port(os.path.join(root, f"one_m{mask}"), q, db, flags,
                   lambda ln: None)
    check_blocks(batches, lens)
    assert sharded_batches == batches
    assert_same(want, blocked)
    # the mesh's run leaves its rank's part file beside the outputs
    assert sharded.pop(".bl_part0.tsv")
    assert_same(want, sharded)
    assert_same(want, one)
    rows = blocked["bl_classifications.tsv"].decode().splitlines()[1:]
    assert sum(r.startswith("1\t") for r in rows) >= 36
    assert rows[17].split("\t")[3] == "5997"  # whole codons of 6,000


@pytest.mark.parametrize("device_tax", [1, 0])
def test_blocks_on_a_chunked_index(world, device_tax):
    """A chunked index of >= 3 chunks under blocks: the same bytes as the
    single index as one block, and each chunk in once a batch (the chunk
    loop holds the block loop)."""
    root, db, q, lens = world
    par = dict(seq_mode=3, batch_reads=64, device_tax=device_tax)
    outs, yields = {}, []
    on_device = chunked.ChunkedIndex.on_device

    def counted(self, mark=None):
        for ix in on_device(self, mark):
            yields.append(ix.n)
            yield ix

    for name in ("single", "chunked"):
        clf = Classifier(db, ClassifyParams(**par), device="cpu")
        cut = lambda ln: None
        if name == "chunked":
            v = clf.index.values[:-1]
            t = clf.index.taxids[:-1].astype(np.int32)
            clf.dev_index = chunked.ChunkedIndex(v, t, len(v) * 6)
            assert len(clf.dev_index.chunks) >= 3
            cut = lambda ln: length_blocks(ln, LIMIT)
        batches = []
        upload = Classifier._upload

        def recorded(self, *a):
            blocks = upload(self, *a)
            batches.append(len(blocks))
            return blocks

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(chunked.ChunkedIndex, "on_device", counted)
            mp.setattr(Classifier, "_cut_blocks",
                       lambda self, ln, cut=cut: cut(ln))
            mp.setattr(Classifier, "_upload", recorded)
            s = clf.classify_file(q, None, os.path.join(root, name), "ch")
        outs[name] = outputs(os.path.join(root, name))
    assert batches == [len(length_blocks(np.array(lens), LIMIT))]
    assert s["batches"] == 1 and batches[0] > 2
    # each chunk once in the one batch, not once a block
    assert yields == [ix.n for ix in clf.dev_index.chunks]
    assert_same(outs["single"], outs["chunked"])


def test_a_batch_of_one_length_is_one_block(tmp_path, world):
    """Paired reads of one length: one block a batch, its codes the
    reader's array itself (no gather, no copy on the CPU), and K1 once
    and K2 once a batch, as before blocks."""
    root, db, _, _ = world
    g = open(os.path.join(root, "ACC_A.1.fna")).read().split("\n")[1]
    for m, off in ((1, 0), (2, 400)):
        (tmp_path / f"p_{m}.fna").write_text("".join(
            f">p{i}\n{g[off + i * 60:off + i * 60 + 150]}\n"
            for i in range(30)))
    seen, calls = [], {"extract": 0, "scan": 0}
    upload = Classifier._upload
    extract, scan = encode.extract_metamers, pipeline.search_scan

    def recorded(self, codes, reads, batch):
        blocks = upload(self, codes, reads, batch)
        seen.append((self._cut_blocks(reads.lens), len(blocks),
                     blocks[0].codes.data_ptr() == reads.codes.ctypes.data))
        return blocks

    def count(key, fn):
        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return counted

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Classifier, "_upload", recorded)
        mp.setattr(encode, "extract_metamers", count("extract", extract))
        mp.setattr(pipeline, "search_scan", count("scan", scan))
        assert port_main(["classify", str(tmp_path / "p_1.fna"),
                          str(tmp_path / "p_2.fna"), db, str(tmp_path / "o"),
                          "pe", "--seq-mode", "2", "--batch-reads", "16",
                          "--device", "cpu"]) == 0
    assert seen == [(None, 1, True), (None, 1, True)]
    assert calls == {"extract": 2, "scan": 2}


@pytest.mark.parametrize("seed", range(6))
def test_the_cutter(seed):
    """Every row in exactly one block, longest first; a block within the
    limit unless it is one row; one length, or a batch within the limit,
    is one block."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    lens = rng.integers(0, 3000, n).astype(np.int32)
    lens[rng.integers(0, n)] = int(rng.integers(0, 40_000))
    limit = int(rng.integers(500, 20_000))
    blocks = length_blocks(lens, limit)
    if n * int(lens.max()) <= limit or lens.min() == lens.max():
        assert blocks is None
        return
    order = np.concatenate(blocks)
    assert np.array_equal(np.sort(order), np.arange(n))
    assert np.all(np.diff(lens[order].astype(np.int64)) <= 0)
    for b in blocks:
        assert len(b) == 1 or len(b) * int(lens[b].max()) <= limit
    assert length_blocks(np.full(50, 999, np.int32), 10) is None
    assert length_blocks(lens[:1], 1) is None


def test_the_cutter_on_lognormal_lengths():
    """16,384 reads of a lognormal 3 kb mean (sd 2 kb, 500-30,000 bp) at
    2^22 padded bases a block: at most 1.25 times the bases padded, where
    one matrix pads ~8-10 times."""
    mean, sd = 3000.0, 2000.0
    s2 = np.log1p((sd / mean) ** 2)
    for seed in range(3):
        x = np.random.default_rng(seed).lognormal(
            np.log(mean) - s2 / 2, np.sqrt(s2), 16384)
        lens = np.clip(np.rint(x), 500, 30000).astype(np.int32)
        blocks = length_blocks(lens)
        padded = sum(len(b) * int(lens[b].max()) for b in blocks)
        assert padded <= 1.25 * lens.sum()
        assert lens.size * int(lens.max()) > 5 * lens.sum()


def test_counters_and_ranges_equal_the_shapes(world):
    """``build.launches``' shape counters move by each K1 block's rows x
    width and bases, each K3 call's rows and each K4 call's groups and
    paths; one ``metabuli.block`` range a block (its profiler range:
    ``StageTimer.span``)."""
    root, db, q, lens = world
    shapes = {"k1": [], "k3": [], "k4": []}
    extract = encode.extract_metamers
    chain = device_taxonomer.chain_matches
    combine = device_taxonomer.combine_paths

    def k1(codes, lens_, **kw):
        shapes["k1"].append((codes.numel(), int(lens_.sum())))
        return extract(codes, lens_, **kw)

    def k3(qid, *a, **kw):
        shapes["k3"].append(qid.numel())
        return chain(qid, *a, **kw)

    def k4(sp, group_start, read_lens):
        shapes["k4"].append((group_start.numel() - 1, sp.read.numel()))
        return combine(sp, group_start, read_lens)

    keys = ("extract_metamers.padded_bases", "extract_metamers.bases",
            "chain_matches.matches", "combine_paths.groups",
            "combine_paths.paths")
    clf = Classifier(db, ClassifyParams(seq_mode=3, batch_reads=16),
                     device="cpu")
    before = {k: build.launches[k] for k in keys}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(encode, "extract_metamers", k1)
        mp.setattr(device_taxonomer, "chain_matches", k3)
        mp.setattr(device_taxonomer, "combine_paths", k4)
        mp.setattr(Classifier, "_cut_blocks",
                   lambda self, ln: length_blocks(ln, LIMIT))
        ranges = []
        open_range = port_classifier._open_range
        mp.setattr(port_classifier, "_open_range", lambda name, args: (
            ranges.append((name, args)), open_range(name, args))[1])
        s = clf.classify_file(q, None, os.path.join(root, "cnt"), "c")
    got = {k: build.launches[k] - before[k] for k in keys}
    assert s["batches"] == 3 and len(shapes["k1"]) > 3
    assert got == {
        "extract_metamers.padded_bases": sum(p for p, _ in shapes["k1"]),
        "extract_metamers.bases": sum(lens),
        "chain_matches.matches": sum(shapes["k3"]),
        "combine_paths.groups": sum(g for g, _ in shapes["k4"]),
        "combine_paths.paths": sum(p for _, p in shapes["k4"])}
    assert sum(b for _, b in shapes["k1"]) == sum(lens)
    assert min(got.values()) > 0
    # one range a block, with its batch's id
    blocks = [args for name, args in ranges if name == "metabuli.block"]
    assert len(blocks) == len(shapes["k1"])
    assert sorted(set(blocks)) == [(0,), (1,), (2,)]
