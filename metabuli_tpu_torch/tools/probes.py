"""Device-cost probes P1-P4 (``csrc/probes.cu``), the counterparts of the
Pallas kernels in ``tools_profiling/``.

    python -m metabuli_tpu_torch.tools.probes

Not on the classify path: each probe measures one memory pattern the
search could be built on. On a CUDA device the command builds the kernels,
checks each against its plain PyTorch version at the reference scripts'
sizes, and prints one JSON line of records. For each probe, and for the
one PyTorch call that computes the same function where there is one
(``library_*``):

    ms         one call between two CUDA events, median of 5 after a
               warm-up: the host's enqueue of the call and its device time
    loop_ms    1,000 back-to-back calls between one pair of events, over
               1,000, median of 5: the steady cost of a call
    launch_ms  the device time of every kernel the call launches (their
               launches alone), from a torch.profiler trace

beside ``plain_ms`` (the plain version's ``ms``) and ``bound_ms``. P1 and
P2 take ``ms`` and ``launch_ms`` with the card's L2 evicted before each
call (``"l2": "cold"``), as a caller with a DB-sized table finds it; their
``loop_ms`` stays warm. Each wrapper takes its plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import json
import re
import sys

import torch

from ..csrc import build

TILE_Q = 1024  # queries per P1 tile (pallas_probe_prototype.py:37)
TILE_T = 2048  # table slots per P2 tile (:38)

# probe -> (source, the Pallas kernel it replaces)
PROBES = {
    "gather_tile_sum": ("metabuli_tpu_torch/csrc/probes.cu",
                        "tools_profiling/pallas_probe_prototype.py:87"),
    "merge_join_sum": ("metabuli_tpu_torch/csrc/probes.cu",
                       "tools_profiling/pallas_probe_prototype.py:148"),
    "smoke_double": ("metabuli_tpu_torch/csrc/probes.cu",
                     "tools_profiling/profile_tier_slices.py:107"),
    "stream_sum": ("metabuli_tpu_torch/csrc/probes.cu",
                   "tools_profiling/profile_tier_slices.py:129"),
}


# probe -> every CUDA function one call launches, as the profiler names
# them
FUNCTIONS = {"gather_tile_sum": ["gather_tile_sum_kernel"],
             "merge_join_sum": ["partition_count_kernel",
                                "partition_scan_kernel",
                                "partition_scatter_kernel",
                                "merge_join_kernel"],
             "smoke_double": ["double_kernel"],
             "stream_sum": ["stream_sum_kernel"]}


def _check_i32(name: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 tensors expected, got {t.dtype}")


# ------------------------------------------------------------------ P1
def gather_tile_sum_plain(table: torch.Tensor, slots: torch.Tensor
                          ) -> torch.Tensor:
    """[N // TILE_Q, 1] int32: per tile of TILE_Q queries, the sum of the
    low 16 bits of ``table[slot]``."""
    lo = table[slots.long()] & 0xFFFF
    return lo.view(-1, TILE_Q).sum(1, dtype=torch.int32)[:, None]


def gather_tile_sum(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """P1 (``pallas_dma``): one random load per query. A thread loads its
    16 slots (16-byte vectors; a ``slots`` view that does not start
    16-byte aligned takes the kernel's word-by-word path), then issues its
    16 gathers back to back through L2 only; warp-shuffle tile sums.
    ``slots`` lie in [0, len(table)); len(slots) % TILE_Q == 0."""
    if slots.numel() % TILE_Q:
        raise ValueError(f"gather_tile_sum: {slots.numel()} queries are not "
                         f"whole tiles of {TILE_Q}")
    if table.is_cpu:
        _check_i32("gather_tile_sum", table, slots)
        return gather_tile_sum_plain(table, slots)
    dev = build.require_cuda("gather_tile_sum", table, slots,
                             dtype=torch.int32)
    n_tiles = slots.numel() // TILE_Q
    out = torch.empty((n_tiles, 1), dtype=torch.int32, device=table.device)
    if n_tiles:
        rc = build.get_lib().mtb_probe_gather_sum(
            table.data_ptr(), table.numel(), slots.data_ptr(), n_tiles,
            out.data_ptr(), build.stream(dev))
        build.check(rc, "gather_tile_sum")
        build.launches["gather_tile_sum"] += 1
    return out


# ------------------------------------------------------------------ P2
# device index -> the partition's per-tile counts, zero between calls (the
# scan kernel zeroes what it read); grown when a call has more tiles
_COUNTS: dict = {}


def merge_join_sum_plain(table: torch.Tensor, slots: torch.Tensor
                         ) -> torch.Tensor:
    """[len(table) // TILE_T, 1] int64: per table tile of TILE_T slots,
    the exact sum of the low 16 bits of ``table[slot]`` over the queries
    whose slot lies in that tile."""
    s = slots.long()
    out = torch.zeros(table.numel() // TILE_T, dtype=torch.int64,
                      device=table.device)
    out.index_add_(0, s // TILE_T, (table[s] & 0xFFFF).long())
    return out[:, None]


def merge_join_sum(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """P2 (``pallas_lut``): the queries partitioned by table tile in one
    radix pass (a histogram, one CTA's exclusive scan, a scatter; order
    within a tile free), then a CTA per tile and per further 1,024 of its
    queries copies the tile into shared memory by TMA while it loads its
    queries, and looks them up there; the CTAs of one tile meet by atomic
    adds, so a skewed input is spread over CTAs. A ``table`` not 16-byte
    aligned is copied word by word. len(table) % TILE_T == 0.

    Keeps its per-tile counts on the card between calls (zero after
    each), so two calls on one device must not overlap on two streams."""
    if table.numel() % TILE_T:
        raise ValueError(f"merge_join_sum: {table.numel()} slots are not "
                         f"whole tiles of {TILE_T}")
    if table.is_cpu:
        _check_i32("merge_join_sum", table, slots)
        return merge_join_sum_plain(table, slots)
    dev = build.require_cuda("merge_join_sum", table, slots,
                             dtype=torch.int32)
    n_tiles, n = table.numel() // TILE_T, slots.numel()
    if n >= 1 << 31:
        raise ValueError(f"merge_join_sum: {n} queries; int32 positions "
                         f"take fewer than 2^31")
    if n_tiles == 0 or n == 0:
        return torch.zeros((n_tiles, 1), dtype=torch.int64,
                           device=table.device)
    counts = _COUNTS.get(dev)
    if counts is None or counts.numel() < n_tiles:
        counts = _COUNTS[dev] = torch.zeros(n_tiles, dtype=torch.int32,
                                            device=table.device)
    n4 = (n + 3) // 4 * 4
    # part (16-byte aligned) | cursor | extra: the scratch of one call
    scratch = torch.empty(n4 + 2 * n_tiles + 1, dtype=torch.int32,
                          device=table.device)
    out = torch.empty((n_tiles, 1), dtype=torch.int64, device=table.device)
    p = scratch.data_ptr()
    rc = build.get_lib().mtb_probe_merge_join_sum(
        table.data_ptr(), table.numel(), slots.data_ptr(), n,
        counts.data_ptr(), p + 4 * n4, p + 4 * (n4 + n_tiles), p,
        out.data_ptr(), build.stream(dev))
    if rc:
        del _COUNTS[dev]  # a launch that did not run may leave them nonzero
    build.check(rc, "merge_join_sum")
    build.launches["merge_join_sum"] += 1
    return out


# ------------------------------------------------------------------ P3
def smoke_double_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def smoke_double(x: torch.Tensor) -> torch.Tensor:
    """P3 (``psmoke``): x * 2 (int32, wrapping). A 16-byte vector a
    thread; the n % 4 tail and an unaligned view take the kernel's scalar
    path."""
    if x.is_cpu:
        _check_i32("smoke_double", x)
        return smoke_double_plain(x)
    dev = build.require_cuda("smoke_double", x, dtype=torch.int32)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        rc = build.get_lib().mtb_probe_double(x.data_ptr(), n,
                                              out.data_ptr(),
                                              build.stream(dev))
        build.check(rc, "smoke_double")
        build.launches["smoke_double"] += 1
    return out


# ------------------------------------------------------------------ P4
def _check_table(table: torch.Tensor) -> None:
    if table.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"stream_sum: int32 or int64 table, got {table.dtype}")


def _words(table: torch.Tensor) -> torch.Tensor:
    _check_table(table)
    return table.reshape(-1).view(torch.int32)


def stream_sum_plain(table: torch.Tensor) -> torch.Tensor:
    """[1, 1] int32: every 32-bit word of ``table`` summed mod 2^32."""
    s = int(_words(table).sum(dtype=torch.int64)) % (1 << 32)
    return torch.tensor([[s - (1 << 32) if s >= 1 << 31 else s]],
                        dtype=torch.int32, device=table.device)


def stream_sum(table: torch.Tensor) -> torch.Tensor:
    """P4 (``stream_sum``): the table streamed once by one CTA per SM,
    TMA bulk copies into a ring in shared memory, the CTAs' sums met
    through a last-CTA ticket kept on the card. The table must start
    16-byte aligned, and two calls must not overlap on two streams (the
    ticket is one per device)."""
    if table.is_cpu:
        return stream_sum_plain(table)
    _check_table(table)
    dev = build.require_cuda("stream_sum", table)
    if table.data_ptr() % 16:
        raise ValueError("stream_sum: the table must be 16-byte aligned")
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    rc = build.get_lib().mtb_probe_stream_sum(
        table.data_ptr(), table.numel() * table.element_size() // 4,
        out.data_ptr(), build.stream(dev))
    build.check(rc, "stream_sum")
    build.launches["stream_sum"] += 1
    return out


# ---------------------------------------------------------------- runner
# the kernel that evicts the L2 before a cold call (csrc/probes.cu); never
# counted in a probe's or a library call's device time
EVICT_FUNCTION = "l2_evict_kernel"


def l2_evictor(device):
    """A function that evicts the card's L2 cache: one kernel reads a
    zeroed buffer of twice ``L2_cache_size`` (read, not written, so no
    dirty line is left for the next call to write back). Not counted in
    ``build.launches``: it is part of the measurement, not of a probe."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    l2 = torch.cuda.get_device_properties(index).L2_cache_size
    buf = torch.zeros(2 * l2 // 4 + 4, dtype=torch.int32, device=device)
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    lib = build.get_lib()

    def evict():
        build.check(lib.mtb_l2_evict(buf.data_ptr(), buf.numel() // 4,
                                     sink.data_ptr(), build.stream(index)),
                    "l2_evict")
    return evict


def median_ms(fn, runs: int = 5, before=None) -> float:
    """One call between two CUDA events, median over ``runs`` after one
    warm-up. With the card idle before the call, this holds the host's
    enqueue of the call as well as its device time. ``before`` (such as
    an L2 eviction) runs and finishes before each call, outside the
    events."""
    times = []
    for i in range(runs + 1):
        if before is not None:
            before()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if i:
            times.append(a.elapsed_time(b))
    return float(sorted(times)[len(times) // 2])


def loop_ms(fn, calls: int = 1000, runs: int = 5) -> float:
    """``calls`` back-to-back calls between one pair of CUDA events, over
    ``calls``, median over ``runs`` after a warm-up: the steady cost of a
    call, the larger of its device time and its host time. Nothing runs
    between the calls, so a working set that fits the L2 stays there."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(sorted(times)[len(times) // 2])


def _trace(fn, functions, runs: int):
    """One torch.profiler trace of ``runs`` calls: {function: [ms of each
    launch]} and the names of every kernel the trace holds. The eviction
    kernel, memsets and copies are never counted."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    times = {f: [] for f in functions or ()}
    seen = set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.name.startswith(("Memset", "Memcpy")) or \
                re.search(rf"(^|::){EVICT_FUNCTION}\b", e.name):
            continue
        seen.add(e.name)
        if functions is None:
            match = e.name
        else:
            match = next((f for f in functions
                          if re.search(rf"(^|::){f}\b", e.name)), None)
            if match is None:
                continue
        times.setdefault(match, []).append(e.time_range.elapsed_us() / 1e3)
    return times, seen


class LostLaunches(RuntimeError):
    """Every trace device_ms took lost launches of a function."""


def device_ms(fn, functions=None, runs: int = 5, at_least: float = 0.0,
              tries: int = 5, before=None):
    """Device time of the kernels ``fn`` launches (their launches alone,
    not the host's glue), from a torch.profiler trace of ``runs`` calls
    after a warm-up, ``before`` (an L2 eviction) ahead of each call.
    ``functions``: the CUDA function names to count, every kernel one
    call launches; None counts every kernel in the trace but the eviction
    (memsets and copies excluded), for a library call. Per function, the
    median of its launches times its launches a call; the call's time is
    their sum. Returns (ms a call, {function: ms a call}).

    A trace can come back holding none or only some of the launches, or
    kernel times below what the card could do (under ``at_least``, the
    call's bound_ms), while CUDA events time the same calls normally (seen
    on an H100). A trace in which a function's launches are not a whole
    multiple of ``runs``, or whose time is under ``at_least``, is taken
    again, up to ``tries`` traces in all, and then this raises:
    LostLaunches when every trace lost launches (seen on an H100, with an
    eviction before each call, for a 2^28-slot P1: 4 of its 5 launches in
    5 traces in a row), else RuntimeError."""
    call = fn if before is None else lambda: (before(), fn())
    call()
    torch.cuda.synchronize()
    lost = True
    for i in range(tries):
        times, seen = _trace(call, functions, runs)
        if times and all(t and len(t) % runs == 0 for t in times.values()):
            # per function: its median launch times its launches a call
            parts = {f: sorted(t)[len(t) // 2] * len(t) / runs
                     for f, t in times.items()}
            if sum(parts.values()) >= at_least:
                return sum(parts.values()), parts
            lost = False
        print(f"device_ms: trace {i + 1} of {tries} for {functions} held "
              f"{ {f: len(t) for f, t in times.items()} } launches of "
              f"{runs} calls, or under {at_least} ms", file=sys.stderr)
    raise (LostLaunches if lost else RuntimeError)(
        f"{tries} traces without every launch of {functions} above "
        f"{at_least} ms; the last held {sorted(seen)[:8]}")


# the H100 SXM's published HBM3 rate at 700 W, bytes/s
HBM_BYTES_PER_S = 3.35e12


def bound(n_bytes: float):
    """(ms, "bytes"): the least time the card could take to move
    ``n_bytes`` (each input byte read once, each output byte written once).
    The operations term is not counted: these kernels do integer work, for
    which no per-kernel operation count has been taken from their
    instructions, so the bound is the bytes' time alone."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"


def lookup_bytes(table: torch.Tensor, slots: torch.Tensor,
                 out_bytes: int) -> int:
    """Least bytes of P1 and P2 on these inputs: every query slot read
    once, the table words the queries name (each distinct slot once: the
    rest of the table is not needed), the output written once."""
    return (slots.nbytes + 4 * int(torch.unique(slots).numel())
            + out_bytes)


def _error(fk, want) -> float:
    got = fk()
    torch.cuda.synchronize()
    return (float("inf") if got.shape != want.shape else
            float((got.long() - want.long()).abs().max()))


def measure(name, fk, fp, n_bytes, fl=None, before=None, loop=True) -> dict:
    """One probe's record: ``fk`` (its wrapper) against ``fp`` (its plain
    version), ``fl`` (the one PyTorch call that computes the same function,
    or None); ``before`` ahead of each call of ``ms`` and ``launch_ms``
    (the L2 eviction, for a cold table). ``max_abs_err`` is taken before
    and after the thousands of timed calls. A ``launch_ms`` (or
    ``library_launch_ms``) is None where every trace lost launches
    (LostLaunches), and ``launch_lost`` then says which and why."""
    want = fp()
    err = _error(fk, want)
    b_ms, b_by = bound(n_bytes)
    lost = []

    def launch(fn, functions):
        try:
            return device_ms(fn, functions, at_least=b_ms, before=before)
        except LostLaunches as e:
            lost.append(f"{'library_' * (functions is None)}launch_ms: {e}")
            return None, {}

    l_ms, parts = launch(fk, FUNCTIONS[name])
    rec = {"max_abs_err": err, "ms": median_ms(fk, before=before),
           "loop_ms": loop_ms(fk) if loop else None, "launch_ms": l_ms,
           "launch_parts_ms": parts, "plain_ms": median_ms(fp),
           "bound_ms": b_ms, "bound_by": b_by,
           "l2": "warm" if before is None else "cold",
           "library_ms": None, "library_loop_ms": None,
           "library_launch_ms": None}
    if fl is not None:
        rec.update(library_ms=median_ms(fl, before=before),
                   library_loop_ms=loop_ms(fl) if loop else None,
                   library_launch_ms=launch(fl, None)[0])
    if lost:
        rec["launch_lost"] = "; ".join(lost)
    rec["max_abs_err"] = max(err, _error(fk, want))
    return rec


def run(device, table_bits: int = 23, n_queries: int = 2_097_152,
        stream_rows: int = 1 << 28, db_bits: int = 28) -> dict:
    """Each probe against its plain version at the reference scripts'
    sizes (P1/P2: a 2^23-slot int32 table, 2,097,152 queries; P3: [8, 128];
    P4: a 2^28-row u64 table, 2 GiB). P1 and P2 are timed with the L2
    evicted before each call of ``ms`` and ``launch_ms`` (their 40 MiB fit
    the card's 50 MB L2, the tables of the callers they stand for do
    not), and again on a 2^``db_bits``-slot table (the smoke DB's rows)
    under ``at_db``; P2 also with every query in one table tile
    (``one_tile``). Returns name -> record."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(0)
    evict = l2_evictor(device)

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=g, dtype=torch.int32,
                             device=device)

    table = ints(1 << 31, 1 << table_bits)
    slots = ints(1 << table_bits, n_queries)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (8, 128), generator=g,
                      dtype=torch.int32, device=device)
    big = torch.randint(-(1 << 63), (1 << 63) - 1, (stream_rows,),
                        generator=g, dtype=torch.int64, device=device)
    words = big.view(torch.int32)

    def lookups(t, s):
        """P1 and P2 on table ``t`` and queries ``s``, the L2 cold."""
        return {
            "gather_tile_sum": measure(
                "gather_tile_sum", lambda: gather_tile_sum(t, s),
                lambda: gather_tile_sum_plain(t, s),
                lookup_bytes(t, s, 4 * (s.numel() // TILE_Q)),
                before=evict),
            "merge_join_sum": measure(
                "merge_join_sum", lambda: merge_join_sum(t, s),
                lambda: merge_join_sum_plain(t, s),
                lookup_bytes(t, s, 8 * (t.numel() // TILE_T)),
                before=evict)}

    out = lookups(table, slots)
    out["smoke_double"] = measure(
        "smoke_double", lambda: smoke_double(x),
        lambda: smoke_double_plain(x), 2 * x.nbytes,
        fl=lambda: torch.mul(x, 2))
    out["stream_sum"] = measure(
        "stream_sum", lambda: stream_sum(big), lambda: stream_sum_plain(big),
        big.nbytes, fl=lambda: words.sum(dtype=torch.int32))
    for name, (src, rep) in PROBES.items():
        out[name] = {"route": "cuda", "source": src, "replaces": rep,
                     **out[name]}
    total = int(gather_tile_sum(table, slots).sum(dtype=torch.int64))
    if total != int(merge_join_sum(table, slots).sum()):
        out["merge_join_sum"]["max_abs_err"] = float("inf")
    # skew: every query in one table tile
    one = ints(TILE_T, n_queries) + TILE_T
    out["merge_join_sum"]["one_tile"] = measure(
        "merge_join_sum", lambda: merge_join_sum(table, one),
        lambda: merge_join_sum_plain(table, one),
        lookup_bytes(table, one, 8 * (table.numel() // TILE_T)),
        before=evict)
    del big, words, table, one
    # a DB's scale, the same number of queries over the whole table: no
    # table of it fits the L2
    at_db = lookups(ints(1 << 31, 1 << db_bits),
                    ints(1 << db_bits, n_queries))
    for name, rec in at_db.items():
        out[name]["at_db"] = {"table_slots": 1 << db_bits, **rec}
        out[name]["max_abs_err"] = max(
            out[name]["max_abs_err"], rec["max_abs_err"],
            out[name].get("one_tile", rec)["max_abs_err"])
    p1_ms = out["gather_tile_sum"]["launch_ms"]
    out["gather_tile_sum"]["ns_per_query"] = (
        None if p1_ms is None else p1_ms * 1e6 / n_queries)
    for k in ("ms", "launch_ms", "library_ms", "library_launch_ms"):
        v = out["stream_sum"][k]
        out["stream_sum"]["gb_per_s_" + k] = (
            None if v is None else stream_rows * 8 / v / 1e6)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the probes run only on one", file=sys.stderr)
        return 1
    res = run("cuda")
    print(json.dumps({"probes": res}))
    return 0 if all(r["max_abs_err"] == 0 for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
