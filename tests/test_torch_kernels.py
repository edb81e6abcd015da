"""Kernels K1-K4 against their plain PyTorch versions on the card.

Needs a CUDA device (and nvcc for the build); skipped elsewhere. Inputs
come from a small seeded world; tolerance is zero: integers equal and
float32 scores bitwise equal."""

import numpy as np
import pytest
import torch

from metabuli_tpu_torch.classify import device_chain, device_combine, pipeline
from metabuli_tpu_torch.classify.device_compact import FlatPaths, compact_paths
from metabuli_tpu_torch.classify.pipeline import (_search_groups,
                                                  build_dev_index,
                                                  classify_core,
                                                  search_scan,
                                                  search_scan_plain)
from metabuli_tpu_torch.csrc import build
from metabuli_tpu_torch.ops import encode
from metabuli_tpu_torch.ops.genetic_code import encode_seqs_padded
from test_torch_synthetic import synthetic_paths

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


def _lookup_case(case, g):
    """(table, slots) on the card for P1 and P2: a 2^16-slot table and
    16 tiles of queries in a named distribution (as in
    test_torch_probes.py), or the reference size (2^23 slots, 2,097,152
    queries); ``wide_<distribution>``: 2,097,152 queries on 2^25 + 2^11
    slots (128 MiB), one table tile more than P2's partition counts in
    shared memory (LOCAL_TILES in csrc/probes.cu), so that its count and
    scatter take their global-atomic branch."""
    from metabuli_tpu_torch.tools import probes

    T = probes.TILE_T
    wide = case.startswith("wide_")
    case = case.removeprefix("wide_")
    n_slots, n = ((1 << 23, 2_097_152) if case == "reference" else
                  ((1 << 25) + T, 2_097_152) if wide else
                  (1 << 16, 16 * 1024))
    table = torch.randint(0, 1 << 31, (n_slots,), generator=g,
                          dtype=torch.int32, device="cuda")
    r = lambda lo, hi, m=n: torch.randint(lo, hi, (m,), generator=g,
                                         dtype=torch.int32, device="cuda")
    slots = {
        "reference": lambda: r(0, n_slots),
        "uniform": lambda: r(0, n_slots),
        "one_tile": lambda: r(3 * T, 4 * T),
        "first_last": lambda: r(0, 2) * (table.numel() - 1),
        "ascending": lambda: torch.sort(r(0, n_slots)).values,
        "gap_tile": lambda: r(0, T) + 2 * T * r(0, 2),
        "n_plus_3": lambda: r(0, n_slots, n + 3),
        "view": lambda: r(0, n_slots, n + 1)[1:],
    }[case]()
    return table, slots


@pytest.mark.parametrize("name,case", [
    (name, case) for name in ("gather_tile_sum", "merge_join_sum")
    for case in ("reference", "one_tile", "first_last", "ascending",
                 "gap_tile", "view")] + [("merge_join_sum", "n_plus_3")]
    + [("merge_join_sum", "wide_" + case)
       for case in ("one_tile", "first_last", "uniform")])
def test_p1_p2_inputs_match_plain(name, case):
    """P1 and P2 on skewed slot distributions, a ``slots`` view one word
    into its buffer (not 16-byte aligned), a query count 3 past whole
    tiles (P2), the reference size, and P2 past the tiles its partition
    counts in shared memory (``wide_*``); zero tolerance."""
    from metabuli_tpu_torch.tools import probes

    table, slots = _lookup_case(case, torch.Generator(
        device="cuda").manual_seed(6))
    if case == "view":
        assert slots.data_ptr() % 16
    before = build.launches[name]
    got = getattr(probes, name)(table, slots)
    assert build.launches[name] == before + 1
    want = getattr(probes, name + "_plain")(table, slots)
    torch.cuda.synchronize()
    _eq([got], [want])


def test_p1_p2_twice_with_other_inputs_and_sizes():
    """Calls in a row on other inputs and other sizes (P2's counts kept
    on the card must be zero again after each call), an unaligned table
    view for P2 (its word-by-word tile copy), and P1 twice on other
    inputs, against the plain version."""
    from metabuli_tpu_torch.tools import probes

    g = torch.Generator(device="cuda").manual_seed(8)
    inputs = [_lookup_case(c, g) for c in ("one_tile", "ascending",
                                           "n_plus_3", "one_tile")]
    buf = torch.randint(0, 1 << 31, ((1 << 16) + 1,), generator=g,
                        dtype=torch.int32, device="cuda")
    inputs.append((buf[1:], inputs[1][1]))
    assert inputs[-1][0].data_ptr() % 16
    for table, slots in inputs:
        got = probes.merge_join_sum(table, slots)
        _eq([got], [probes.merge_join_sum_plain(table, slots)])
    for table, slots in inputs[:2]:
        got = probes.gather_tile_sum(table, slots)
        _eq([got], [probes.gather_tile_sum_plain(table, slots)])
    torch.cuda.synchronize()


# P3's vector path takes 4 words a thread, 256 threads a CTA; P4's CTAs
# take the table in chunks of 8,192 words (32 KiB, one stage of the ring)
P4_STEP = 4 * 2048


@pytest.mark.parametrize("n", [0, 1, 3, 4, 1023, 1024, 1025, 1 << 20,
                               "view"])
def test_p3_smoke_double_sizes_match_plain(n):
    """Word counts around the 16-byte vectors and one CTA, 1 M words, and
    a view one word into its buffer (not 16-byte aligned: the scalar
    path)."""
    from metabuli_tpu_torch.tools import probes

    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randint(-(1 << 31), (1 << 31) - 1,
                      (1025 if n == "view" else n,), generator=g,
                      dtype=torch.int32, device="cuda")
    if n == "view":
        x = x.view(-1)[1:]
        assert x.data_ptr() % 16
    before = build.launches["smoke_double"]
    got = probes.smoke_double(x)
    assert build.launches["smoke_double"] == before + (x.numel() > 0)
    want = probes.smoke_double_plain(x)
    torch.cuda.synchronize()
    _eq([got], [want])
    with pytest.raises(TypeError):
        probes.smoke_double(x.long())


@pytest.mark.parametrize("words", [0, 1, 3, 4, 5, P4_STEP - 1, P4_STEP + 1,
                                   "waves", "rows_2_26"])
def test_p4_stream_sum_sizes_match_plain(words):
    """0-5 words (none, tail words only, or one vector and a tail), one chunk
    +- 1 (a short last chunk, or one CTA and a second), 24 chunks a CTA
    plus a tail (each CTA's ring wrapping round its 4 stages several
    times), and a 2^26-row int64 table."""
    from metabuli_tpu_torch.tools import probes

    g = torch.Generator(device="cuda").manual_seed(11)
    if words == "rows_2_26":
        tab = torch.randint(-(1 << 63), (1 << 63) - 1, (1 << 26,),
                            generator=g, dtype=torch.int64, device="cuda")
    else:
        n = (24 * torch.cuda.get_device_properties(0).multi_processor_count
             * P4_STEP + 5) if words == "waves" else words
        tab = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                            dtype=torch.int32, device="cuda")
    before = build.launches["stream_sum"]
    got = probes.stream_sum(tab)
    assert build.launches["stream_sum"] == before + 1
    want = probes.stream_sum_plain(tab)
    torch.cuda.synchronize()
    _eq([got], [want])


def test_p4_stream_sum_twice_and_on_a_side_stream():
    """Two calls in a row each find their ticket at 0; a call inside
    ``torch.cuda.stream(s)`` runs on s and agrees."""
    from metabuli_tpu_torch.tools import probes

    g = torch.Generator(device="cuda").manual_seed(12)
    a, b = (torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                          dtype=torch.int32, device="cuda")
            for n in (P4_STEP * 300 + 3, P4_STEP * 7 + 2))
    got = [probes.stream_sum(a), probes.stream_sum(b), probes.stream_sum(a)]
    want = [probes.stream_sum_plain(t) for t in (a, b, a)]
    torch.cuda.synchronize()
    _eq(got, want)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        on_s = probes.stream_sum(b)
    torch.cuda.current_stream().wait_stream(s)
    _eq([on_s], [want[1]])
    with pytest.raises(ValueError):  # not 16-byte aligned
        probes.stream_sum(a[1:])


def test_raw_stream_is_the_current_stream():
    """``build.stream`` reads PyTorch's current stream through a private
    call: it must equal ``current_stream(dev).cuda_stream`` on the
    default stream and inside ``torch.cuda.stream(s)``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    assert build.stream(dev) == torch.cuda.current_stream(dev).cuda_stream
    assert build.stream(dev.index) == build.stream(dev)
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        assert build.stream(dev) == s.cuda_stream
        assert build.stream(torch.device("cuda")) == s.cuda_stream
    assert build.stream(dev) != s.cuda_stream


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


def _k1_rows(kind, rng):
    """Rows for K1: short rows (24-26 bases: 0-1 windows; 151) with N and
    IUPAC bases, or rows around one and two CTA chunks of 256 windows
    (791 bases give exactly 256 windows, 794 give 257; 1,562 give 513),
    or a ~5,000-base row among 150-base reads."""
    iupac = np.frombuffer(b"NRYSWKMBDHVX", np.uint8)

    def row(n, n_rate=0.01):
        r = rng.choice(ACGT, n)
        m = rng.random(n) < n_rate
        r[m] = rng.choice(iupac, int(m.sum()))
        return bytes(r)

    return {"short": [row(n) for n in (24, 25, 26, 151, 151)],
            "chunk_edge": [row(n) for n in (791, 792, 793, 794, 150)],
            "two_chunks": [row(n) for n in (1559, 1560, 1561, 1562, 150)],
            "long_row": [row(150) for _ in range(6)] + [row(5003)]}[kind]


@pytest.mark.parametrize("syncmer,smer_len", [(False, 5), (True, 3),
                                              (True, 5), (True, 6), (True, 7)])
@pytest.mark.parametrize("kind", ["short", "chunk_edge", "two_chunks",
                                  "long_row"])
def test_k1_row_lengths_and_syncmers_match_plain(kind, syncmer, smer_len):
    rows = _k1_rows(kind, np.random.default_rng(len(kind)))
    codes, lens = encode_seqs_padded(rows)
    codes = torch.from_numpy(codes).to("cuda")
    lens = torch.from_numpy(lens).to("cuda")
    kw = dict(syncmer=syncmer, smer_len=smer_len)
    before = build.launches["extract_metamers"]
    got = encode.extract_metamers(codes, lens, **kw)
    assert build.launches["extract_metamers"] == before + 1
    want = encode.extract_metamers_plain(codes, lens, **kw)
    torch.cuda.synchronize()
    _eq(got, want)
    assert int(got.valid.sum()) > 0


@pytest.mark.parametrize("case", ["sizes", "ties", "dense", "accepted"])
def test_k4_group_sizes_and_overlaps_match_plain(case):
    """Groups of 1, 31, 32, 33, 65, 70 and 100 paths; ``accepted``:
    groups with 40 and 260 accepted paths and paths that meet them."""
    rng = np.random.default_rng(17)
    sizes = {"sizes": [1, 31, 32, 33, 70, 2, 5, 100, 3, 40],
             "ties": [1, 31, 32, 33, 70, 2, 5, 100, 3, 40],
             "dense": [1, 31, 32, 33, 65, 100] * 2,
             "accepted": [40, 260, 40, 33]}[case]
    paths, rl = synthetic_paths(
        rng, sizes, ties=case == "ties", span=150 if case == "dense" else 300,
        disjoint=(0, 1, 2) if case == "accepted" else ())
    sp, gstart = device_combine.sort_paths(
        FlatPaths(*(x.to("cuda") for x in paths)))
    rl = rl.to("cuda")
    before = build.launches["combine_paths"]
    got = device_combine.combine_paths(sp, gstart, rl)
    assert build.launches["combine_paths"] == before + 1
    want = device_combine.combine_paths_plain(sp, gstart, rl)
    torch.cuda.synchronize()
    _eq([got], [want])
    assert float(got.max()) < 1.0 and got.numel() == len(sizes)


def test_k1_row_of_65536_chunks_matches_plain():
    """A 30 Mb sequence in the build's length bucket (50,331,648 bases,
    16,777,207 windows): 65,536 chunks of 256 windows, one past what a
    2-D grid's y extent held."""
    n, bucket = 30_000_000, 384 << 17
    rng = np.random.default_rng(30)
    codes, lens = encode_seqs_padded([bytes(rng.choice(ACGT, n))],
                                     max_len=bucket)
    assert codes.shape == (1, bucket)
    assert -(-encode.max_windows(bucket) // 256) == 65_536
    codes = torch.from_numpy(codes).to("cuda")
    lens = torch.from_numpy(lens).to("cuda")
    before = build.launches["extract_metamers"]
    got = encode.extract_metamers(codes, lens)
    assert build.launches["extract_metamers"] == before + 1
    want = encode.extract_metamers_plain(codes, lens)
    torch.cuda.synchronize()
    _eq(got, want)
    assert int(got.valid[0, :, (n - 2) // 3 - 8].sum()) > 0
    assert not bool(got.valid[0, :, (n - 2) // 3:].any())


def test_k1_single_frame_rows_with_padding_rows_match_plain():
    """The build's gene-block batches: short single-frame rows whose lens
    cover floor(L/3) codons, padded to a power of two with lens-0 rows of
    invalid codes; and the builder's gathered metamers on the card equal
    its own on the CPU."""
    from metabuli_tpu_torch.db.build import IndexBuilder, SeqTask
    from metabuli_tpu_torch.params import BuildParams

    rng = np.random.default_rng(6)
    seqs = [bytes(rng.choice(ACGT, int(n)))
            for n in rng.integers(24, 1100, 37)]
    bucket = 1536
    codes, _ = encode_seqs_padded(seqs, max_len=bucket)
    real = np.array([len(s) for s in seqs], np.int64)
    lens = (3 * (real // 3) + 2).astype(np.int32)
    codes = np.concatenate([codes, np.full((64 - len(seqs), bucket), 7,
                                           np.uint8)])
    lens = np.concatenate([lens, np.zeros(64 - len(seqs), np.int32)])
    codes = torch.from_numpy(codes).to("cuda")
    lens = torch.from_numpy(lens).to("cuda")
    got = encode.extract_metamers(codes, lens)
    want = encode.extract_metamers_plain(codes, lens)
    torch.cuda.synchronize()
    _eq(got, want)
    assert not bool(got.valid[len(seqs):].any())

    tasks = [SeqTask(s, 1, 1, single_frame=True) for s in seqs]
    out = {}
    for dev in ("cuda", "cpu"):
        # extraction alone reads no taxonomy
        b = IndexBuilder(BuildParams(), None, device=dev)
        b.add_sequences(tasks)
        out[dev] = np.concatenate(b._values)
    assert np.array_equal(out["cuda"], out["cpu"]) and len(out["cpu"]) > 0


def _wobble(seq, rate, rng):
    c = seq.copy()
    w = np.arange(2, len(c), 3)
    m = w[rng.random(len(w)) < rate]
    c[m] = ACGT[(np.searchsorted(ACGT, c[m]) + rng.integers(1, 4, len(m))) % 4]
    return c


def _long_read_columns(syncmer, smer_len, dev):
    """Sorted match columns of 8 reads of 4,500 bases (45 substitutions
    each) against 4 species that each hold 6 wobble-diverged copies of
    one 5 kb core and 3 kb of their own; half the reads come from a fresh
    copy of the core. A read meets several copies of a species at one
    position, so (read, species, frame) blocks run to ~1,600 rows of
    quotient groups up to 6 rows wide, and a (read, species) group holds
    hundreds of paths."""
    rng = np.random.default_rng(10)
    core = rng.choice(ACGT, 5000)
    genomes = [np.concatenate([_wobble(core, 0.1, rng) for _ in range(6)]
                              + [rng.choice(ACGT, 3000)]) for _ in range(4)]
    codes, lens = encode_seqs_padded([bytes(g) for g in genomes])
    kw = dict(syncmer=syncmer, smer_len=smer_len)
    mm = encode.extract_metamers_plain(torch.from_numpy(codes),
                                       torch.from_numpy(lens), **kw)
    vals, taxs = [], []
    for g in range(len(genomes)):
        v = np.unique(mm.value[g][mm.valid[g]].numpy().view(np.uint64))
        vals.append(v)
        taxs.append(np.full(len(v), 3 + g, np.int32))
    values, taxids = np.concatenate(vals), np.concatenate(taxs)
    o = np.argsort(values, kind="stable")
    reads = []
    for i in range(8):
        src = _wobble(core, 0.1, rng) if i % 2 == 0 else genomes[i % 4]
        st = int(rng.integers(0, len(src) - 4500))
        r = bytearray(bytes(src[st:st + 4500]))
        for _ in range(45):
            r[int(rng.integers(0, 4500))] = ACGT[int(rng.integers(0, 4))]
        reads.append(bytes(r))
    index = build_dev_index(values[o], taxids[o], device=dev)
    t2s = torch.arange(64, dtype=torch.int32, device=dev)
    m, _ = classify_core(index, t2s, *_batch(reads, dev), cap=4096, **kw)
    return m


@pytest.mark.parametrize("syncmer,smer_len", [(False, 5), (True, 7),
                                              (True, 6), (True, 5)])
def test_k3_k4_long_read_columns_match_plain(syncmer, smer_len):
    """K3 and K4 on long-read columns, with the codon shifts of syncmers
    (max_shift 8 - smer_len: 1 to 3): blocks of 800-1,600 rows holding
    quotient groups of up to 6 rows, and groups of 200+ paths; each
    kernel launches once."""
    dev = "cuda"
    m = _long_read_columns(syncmer, smer_len, dev)
    frame = m.packed & 7
    ham = (m.packed >> 3) & 0xFF
    h16 = (m.packed >> 11) & 0xFFFF
    block = (m.qid.long() << 40) | (m.species.long() << 8) | frame.long()
    group = (block << 16) | torch.div(m.pos, 3, rounding_mode="floor").long()
    rows = lambda k: int(torch.unique_consecutive(
        k, return_counts=True)[1].max())
    assert rows(block) >= 800 and rows(group) >= 5
    min_depth = torch.full((64,), 4, dtype=torch.int32, device=dev)
    args = (m.qid, m.species, frame, m.pos, ham, m.dna, h16, min_depth)
    kw = dict(max_shift=8 - smer_len if syncmer else 1)
    before = build.launches["chain_matches"]
    got = device_chain.chain_matches(*args, **kw)
    assert build.launches["chain_matches"] == before + 1
    want = device_chain.chain_matches_plain(*args, **kw)
    torch.cuda.synchronize()
    _eq(got, want)
    paths, gstart = device_combine.sort_paths(
        compact_paths(got, m.qid, m.species, m.pos, h16))
    assert int((gstart[1:] - gstart[:-1]).max()) >= 200
    rl = torch.full((8,), 4497, dtype=torch.int32, device=dev)
    before = build.launches["combine_paths"]
    s_got = device_combine.combine_paths(paths, gstart, rl)
    assert build.launches["combine_paths"] == before + 1
    s_want = device_combine.combine_paths_plain(paths, gstart, rl)
    torch.cuda.synchronize()
    _eq([s_got], [s_want])
    assert float(s_got.max()) > 0.5
