"""Kernels K1-K4 against their plain PyTorch versions on the card.

Needs a CUDA device (and nvcc for the build); skipped elsewhere. Inputs
come from a small seeded world; tolerance is zero: integers equal and
float32 scores bitwise equal."""

import numpy as np
import pytest
import torch

from metabuli_tpu_torch.classify import device_chain, device_combine, pipeline
from metabuli_tpu_torch.classify.device_compact import compact_paths
from metabuli_tpu_torch.classify.pipeline import (_search_groups,
                                                  build_dev_index,
                                                  classify_core,
                                                  search_scan,
                                                  search_scan_plain)
from metabuli_tpu_torch.csrc import build
from metabuli_tpu_torch.ops import encode
from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded

pytestmark = pytest.mark.gpu

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _needs_cuda():
    # decided per test, not at import: every xdist worker must collect
    # the same tests
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on a CUDA device")


@pytest.fixture(scope="module")
def world():
    """8 genomes sharing a wobble-diverged core (deep AA groups) and
    reads with substitutions and reverse complements."""
    rng = np.random.default_rng(4)
    core = rng.choice(ACGT, 1500)
    genomes = []
    for g in range(8):
        c = core.copy()
        w = np.arange(2, len(c), 3)
        m = w[rng.random(len(w)) < 0.2]
        c[m] = ACGT[(np.searchsorted(ACGT, c[m]) + rng.integers(1, 4, len(m))) % 4]
        genomes.append(bytes(np.concatenate([c, rng.choice(ACGT, 3000)])))
    codes, lens = encode_seqs_padded(genomes)
    mm = encode.extract_metamers_plain(torch.from_numpy(codes),
                                       torch.from_numpy(lens))
    vals, taxs = [], []
    for g in range(8):
        v = mm.value[g][mm.valid[g]].numpy().view(np.uint64)
        v = np.unique(v)
        vals.append(v)
        taxs.append(np.full(len(v), 3 + g, np.int32))
    values = np.concatenate(vals)
    taxids = np.concatenate(taxs)
    o = np.argsort(values, kind="stable")
    reads = []
    for i in range(192):
        g = genomes[i % 8]
        st = int(rng.integers(0, len(g) - 150))
        r = bytearray(g[st:st + 150])
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 150))] = ACGT[int(rng.integers(0, 4))]
        if i % 2:
            r = bytearray(bytes(r).translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1])
        reads.append(bytes(r))
    return values[o], taxids[o], reads


def _batch(reads, dev):
    codes, lens = encode_seqs_padded(reads)
    n = len(reads)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.arange(n, dtype=torch.int32, device=dev))


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("syncmer", [False, True])
def test_k1_extract_matches_plain(world, syncmer):
    codes, lens, _, _ = _batch(world[2], "cuda")
    before = build.launches["extract_metamers"]
    got = encode.extract_metamers(codes, lens, syncmer=syncmer)
    assert build.launches["extract_metamers"] == before + 1
    want = encode.extract_metamers_plain(codes, lens, syncmer=syncmer)
    torch.cuda.synchronize()
    _eq(got, want)
    assert int(got.valid.sum()) > 0


@pytest.mark.parametrize("cap", [3, 4096])
def test_k2_search_scan_matches_plain(world, cap):
    values, taxids, reads = world
    index = build_dev_index(values, taxids, device="cuda")
    codes, lens, _, _ = _batch(reads, "cuda")
    mm = encode.extract_metamers(codes, lens)
    args = (index, mm.value.reshape(-1), mm.valid.reshape(-1),
            mm.dna48.reshape(-1), mm.value.shape[2], cap)
    got = search_scan(*args)
    want = search_scan_plain(*args)
    torch.cuda.synchronize()
    _eq(got[:3], want[:3])
    assert got.n_over_cap == want.n_over_cap
    assert got.row.numel() > 0


def test_k3_k4_match_plain(world):
    values, taxids, reads = world
    dev = "cuda"
    index = build_dev_index(values, taxids, device=dev)
    t2s = torch.arange(64, dtype=torch.int32, device=dev)
    m, _ = classify_core(index, t2s, *_batch(reads, dev), cap=4096)
    frame = m.packed & 7
    ham = (m.packed >> 3) & 0xFF
    h16 = (m.packed >> 11) & 0xFFFF
    min_depth = torch.full((64,), 4, dtype=torch.int32, device=dev)
    args = (m.qid, m.species, frame, m.pos, ham, m.dna, h16, min_depth)
    got = device_chain.chain_matches(*args, max_shift=1)
    want = device_chain.chain_matches_plain(*args, max_shift=1)
    torch.cuda.synchronize()
    _eq(got, want)
    paths, gstart = device_combine.sort_paths(
        compact_paths(got, m.qid, m.species, m.pos, h16))
    rl = torch.full((len(reads),), 147, dtype=torch.int32, device=dev)
    s_got = device_combine.combine_paths(paths, gstart, rl)
    s_want = device_combine.combine_paths_plain(paths, gstart, rl)
    torch.cuda.synchronize()
    _eq([s_got], [s_want])
    assert s_got.numel() > 0


@pytest.mark.parametrize("name", ["gather_tile_sum", "merge_join_sum",
                                  "smoke_double", "stream_sum"])
def test_probe_kernels_match_plain(name):
    from metabuli_tpu_torch.tools import probes

    g = torch.Generator(device="cuda").manual_seed(5)
    table = torch.randint(0, 1 << 31, (1 << 16,), generator=g,
                          dtype=torch.int32, device="cuda")
    slots = torch.randint(0, 1 << 16, (16 * probes.TILE_Q,), generator=g,
                          dtype=torch.int32, device="cuda")
    big = torch.randint(-(1 << 63), (1 << 63) - 1, ((1 << 20) + 3,),
                        generator=g, dtype=torch.int64, device="cuda")
    args = {"gather_tile_sum": (table, slots), "merge_join_sum": (table, slots),
            "smoke_double": (slots.view(16, -1),), "stream_sum": (big,)}[name]
    before = build.launches[name]
    got = getattr(probes, name)(*args)
    assert build.launches[name] == before + 1
    want = getattr(probes, name + "_plain")(*args)
    torch.cuda.synchronize()
    _eq([got], [want])


def _window_index(sizes, rng):
    """A table whose groups (one amino-acid key each) hold ``sizes`` rows,
    among 4,000 one-row groups; returns (index, keys of the sized groups,
    all keys)."""
    keys = np.unique(rng.integers(0, 1 << 40, len(sizes) + 4000,
                                  dtype=np.uint64))
    rng.shuffle(keys)
    sized, filler = keys[:len(sizes)], keys[len(sizes):]
    vals = [filler << np.uint64(24)
            | rng.integers(0, 1 << 24, len(filler), dtype=np.uint64)]
    for key, n in zip(sized, sizes):
        dna = rng.choice(1 << 24, n, replace=False).astype(np.uint64)
        vals.append((key << np.uint64(24)) | dna)
    values = np.sort(np.concatenate(vals))
    taxids = rng.integers(1, 50, len(values)).astype(np.int32)
    return build_dev_index(values, taxids, device="cuda"), sized, keys


@pytest.mark.parametrize("stash", [0, None, 1024])
@pytest.mark.parametrize("cap", [32, 1 << 20])
def test_k2_windows_of_every_depth_match_plain(cap, stash, monkeypatch):
    """Windows of 1, 31, 32, 33, 64 and 1,500 rows (around a warp, and
    deeper than 1,024), cut at a cap of 32 or whole, in warps that mix
    them with misses and invalid slots; with no stash every warp's write
    walks its windows again, with the index's default some may, with
    1,024 entries per slot none does."""
    if stash is not None:
        monkeypatch.setattr(pipeline, "stash_per_slot", lambda index: stash)
    rng = np.random.default_rng(21)
    sizes = [1, 31, 32, 33, 64, 1500]
    index, sized, keys = _window_index(sizes, rng)
    W, n_reads = 7, 48
    Q = n_reads * 6 * W
    pick = rng.random(Q)
    key = np.where(pick < 0.5, rng.choice(sized, Q),
                   np.where(pick < 0.8, rng.choice(keys, Q),
                            rng.integers(0, 1 << 40, Q, dtype=np.uint64)))
    value = (key << np.uint64(24)) | rng.integers(0, 1 << 24, Q,
                                                  dtype=np.uint64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    q_value = t(value.view(np.int64))
    q_valid = t(rng.random(Q) < 0.9)
    # half the queries carry a table row's codons (Hamming 0 rows exist)
    own = index.d48[t(rng.integers(0, index.n, Q))]
    noise = t(rng.integers(0, 1 << 48, Q, dtype=np.int64))
    q_dna48 = torch.where(t(rng.random(Q) < 0.5), own, noise)
    args = (index, q_value, q_valid, q_dna48, W, cap)
    before = build.launches["search_scan"]
    got = search_scan(*args)
    assert build.launches["search_scan"] == before + 1
    want = search_scan_plain(*args)
    torch.cuda.synchronize()
    _eq(got[:3], want[:3])
    assert got.n_over_cap == want.n_over_cap
    assert (got.n_over_cap > 0) == (cap == 32)
    if stash is not None:
        assert (got.n_rewalk > 0) == (stash == 0)
    gs, ge, hit = _search_groups(index, q_value, q_valid)
    assert int((ge - gs)[hit].max()) == 1500


def _chain_columns(rng, dev, ties=False):
    """Sorted match columns: one block of ~700 rows (past the window of
    block heads a warp takes) with a 40-row and a 70-row group (wider than
    a warp's tile), one of ~300 rows on a reverse frame with a 33-row
    group, and 300 short blocks. Codon words follow a codon stream, so
    neighbouring groups connect, with mutated variants that do not.
    ``ties``: also a 600-row block of one-row groups, and every match
    scores the same (h16 = 0), so predecessors tie."""
    cols = {k: [] for k in ("qid", "species", "frame", "pos", "ham", "dna",
                            "h16")}

    def block(qid, sp, frame, n_groups, wide=(), narrow=False):
        codons = rng.integers(0, 8, n_groups * 3 + 8)
        q = 0
        for g in range(n_groups):
            q += 1 if rng.random() < 0.85 else int(rng.integers(2, 4))
            c = codons[q:q + 8]
            word = (sum(int(c[k]) << (3 * (7 - k)) for k in range(8))
                    if frame < 3 else
                    sum(int(c[k]) << (3 * k) for k in range(8)))
            width = (wide[g] if g in wide else
                     1 if narrow else int(rng.integers(1, 4)))
            for v in range(width):
                d = word if v == 0 else word ^ (1 << int(rng.integers(0, 24)))
                h16 = int(rng.integers(0, 1 << 16))
                ham = sum((h16 >> (2 * k)) & 3 for k in range(8))
                for k, x in zip(cols, (qid, sp, frame, 3 * q, ham, d, h16)):
                    cols[k].append(x)

    block(0, 3, 1, 300, wide={40: 40, 120: 70})
    block(0, 5, 4, 150, wide={10: 33})
    for b in range(300):
        block(1 + b // 3, 2 + b % 3, int(rng.integers(0, 6)),
              int(rng.integers(1, 6)))
    if ties:
        block(200, 4, 2, 600, narrow=True)
        cols["h16"] = [0] * len(cols["h16"])
        cols["ham"] = [0] * len(cols["ham"])
    t = {k: torch.tensor(v, dtype=torch.int32, device=dev)
         for k, v in cols.items()}
    return t, torch.tensor(rng.integers(1, 5, 8), dtype=torch.int32,
                           device=dev)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("max_shift", [1, 2])
def test_k3_wide_groups_and_long_blocks_match_plain(max_shift, ties):
    """``ties``: every match scores the same, so a row's connectable
    predecessors tie and the first must win, and a 600-row block of
    one-row groups chains across many of a warp's tiles."""
    c, min_depth = _chain_columns(np.random.default_rng(8), "cuda", ties=ties)
    args = (c["qid"], c["species"], c["frame"], c["pos"], c["ham"],
            c["dna"], c["h16"], min_depth)
    before = build.launches["chain_matches"]
    got = device_chain.chain_matches(*args, max_shift=max_shift)
    assert build.launches["chain_matches"] == before + 1
    want = device_chain.chain_matches_plain(*args, max_shift=max_shift)
    torch.cuda.synchronize()
    _eq(got, want)
    assert int(got.emit.sum()) > 0 and int(got.depth.max()) > 8
