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
    launch_ms  the device time of the kernel alone, from a torch.profiler
               trace (for the library call, of every kernel it launches)

beside ``plain_ms`` (the plain version's ``ms``) and ``bound_ms``. Each
wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
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


# probe -> its CUDA function, as the profiler names it
FUNCTIONS = {"gather_tile_sum": "gather_tile_sum_kernel",
             "merge_join_sum": "merge_join_kernel",
             "smoke_double": "double_kernel",
             "stream_sum": "stream_sum_kernel"}


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
    """P1 (``pallas_dma``): one block per tile, one random load per
    query. ``slots`` lie in [0, len(table)); len(slots) % TILE_Q == 0."""
    _check_i32("gather_tile_sum", table, slots)
    if slots.numel() % TILE_Q:
        raise ValueError(f"gather_tile_sum: {slots.numel()} queries are not "
                         f"whole tiles of {TILE_Q}")
    if table.device.type == "cpu":
        return gather_tile_sum_plain(table, slots)
    build.require_cuda("gather_tile_sum", table, slots)
    n_tiles = slots.numel() // TILE_Q
    out = torch.empty((n_tiles, 1), dtype=torch.int32, device=table.device)
    if n_tiles == 0:
        return out
    rc = build.get_lib().mtb_probe_gather_sum(
        table.data_ptr(), table.numel(), slots.data_ptr(), n_tiles, TILE_Q,
        out.data_ptr(), build.stream(table.device))
    build.check(rc, "gather_tile_sum")
    build.launches["gather_tile_sum"] += 1
    return out


# ------------------------------------------------------------------ P2
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
    """P2 (``pallas_lut``): sort the queries by slot, then one block per
    table tile stages the tile in shared memory and looks up its window of
    sorted queries there. len(table) % TILE_T == 0."""
    _check_i32("merge_join_sum", table, slots)
    if table.numel() % TILE_T:
        raise ValueError(f"merge_join_sum: {table.numel()} slots are not "
                         f"whole tiles of {TILE_T}")
    if table.device.type == "cpu":
        return merge_join_sum_plain(table, slots)
    build.require_cuda("merge_join_sum", table, slots)
    dev = table.device
    n_tiles = table.numel() // TILE_T
    out = torch.empty((n_tiles, 1), dtype=torch.int64, device=dev)
    if n_tiles == 0:
        return out
    ss = torch.sort(slots).values
    starts = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev) * TILE_T
    bounds = torch.searchsorted(ss, starts).to(torch.int32)
    rc = build.get_lib().mtb_probe_merge_join(
        table.data_ptr(), ss.data_ptr(), bounds.data_ptr(), n_tiles, TILE_T,
        out.data_ptr(), build.stream(dev))
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
def median_ms(fn, runs: int = 5) -> float:
    """One call between two CUDA events, median over ``runs`` after one
    warm-up. With the card idle before the call, this holds the host's
    enqueue of the call as well as its device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(sorted(times)[len(times) // 2])


def loop_ms(fn, calls: int = 1000, runs: int = 5) -> float:
    """``calls`` back-to-back calls between one pair of CUDA events, over
    ``calls``, median over ``runs`` after a warm-up: the steady cost of a
    call, the larger of its device time and its host time."""
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
    launch]} and the names of every kernel the trace holds."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    times = {f: [] for f in functions or ()}
    seen = set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.name.startswith(("Memset", "Memcpy")):
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


def device_ms(fn, functions=None, runs: int = 5, at_least: float = 0.0,
              tries: int = 5):
    """Device time of the kernels ``fn`` launches (their launches alone,
    not the host's glue), from a torch.profiler trace of ``runs`` calls
    after a warm-up. ``functions``: the CUDA function names to count
    (each call launches each once); None counts every kernel in the trace
    (memsets and copies excluded), for a library call. Per function, the
    median of its launches times its launches a call. Returns (ms a call,
    {function: ms a call}).

    A trace can come back holding none or only some of the launches, or
    kernel times below what the card could do (under ``at_least``, the
    call's bound_ms), while CUDA events time the same calls normally (seen
    on an H100); a trace whose count of launches of a function is not a
    whole multiple of ``runs``, or whose time is under ``at_least``, is
    taken again, up to ``tries`` traces in all, and then this raises."""
    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        times, seen = _trace(fn, functions, runs)
        if times and all(t and len(t) % runs == 0 for t in times.values()):
            # per function: its median launch times its launches a call
            parts = {f: sorted(t)[len(t) // 2] * len(t) / runs
                     for f, t in times.items()}
            if sum(parts.values()) >= at_least:
                return sum(parts.values()), parts
        print(f"device_ms: trace {i + 1} of {tries} for {functions} held "
              f"{ {f: len(t) for f, t in times.items()} } launches of "
              f"{runs} calls, or under {at_least} ms", file=sys.stderr)
    raise RuntimeError(f"{tries} traces without every launch of "
                       f"{functions} above {at_least} ms; the last held "
                       f"{sorted(seen)[:8]}")


# the H100 SXM's published HBM3 rate at 700 W, bytes/s
HBM_BYTES_PER_S = 3.35e12


def bound(n_bytes: float):
    """(ms, "bytes"): the least time the card could take to move
    ``n_bytes`` (each input byte read once, each output byte written once).
    The operations term is not counted: these kernels do integer work, for
    which no per-kernel operation count has been taken from their
    instructions, so the bound is the bytes' time alone."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"


def run(device, table_bits: int = 23, n_queries: int = 2_097_152,
        stream_rows: int = 1 << 28) -> dict:
    """Each probe against its plain version at the reference scripts'
    sizes (P1/P2: a 2^23-slot int32 table, 2,097,152 queries; P3: [8, 128];
    P4: a 2^28-row u64 table, 2 GiB). Returns name -> record."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(0)
    table = torch.randint(0, 1 << 31, (1 << table_bits,), generator=g,
                          dtype=torch.int32, device=device)
    slots = torch.randint(0, 1 << table_bits, (n_queries,), generator=g,
                          dtype=torch.int32, device=device)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (8, 128), generator=g,
                      dtype=torch.int32, device=device)
    big = torch.randint(-(1 << 63), (1 << 63) - 1, (stream_rows,),
                        generator=g, dtype=torch.int64, device=device)
    words = big.view(torch.int32)
    # name -> (kernel, plain version, the one PyTorch call that computes
    # the same function or None, least bytes: each input read once, each
    # output written once)
    cases = {
        "gather_tile_sum": (lambda: gather_tile_sum(table, slots),
                            lambda: gather_tile_sum_plain(table, slots),
                            None, table.nbytes + slots.nbytes),
        "merge_join_sum": (lambda: merge_join_sum(table, slots),
                           lambda: merge_join_sum_plain(table, slots),
                           None, table.nbytes + slots.nbytes),
        "smoke_double": (lambda: smoke_double(x),
                         lambda: smoke_double_plain(x),
                         lambda: torch.mul(x, 2), 2 * x.nbytes),
        "stream_sum": (lambda: stream_sum(big),
                       lambda: stream_sum_plain(big),
                       lambda: words.sum(dtype=torch.int32), big.nbytes),
    }
    def error(fk, want):
        got = fk()
        torch.cuda.synchronize()
        return (float("inf") if got.shape != want.shape else
                float((got.long() - want.long()).abs().max()))

    out = {}
    for name, (fk, fp, fl, n_bytes) in cases.items():
        want = fp()
        err = error(fk, want)
        src, rep = PROBES[name]
        b_ms, b_by = bound(n_bytes)
        out[name] = {"route": "cuda", "source": src, "replaces": rep,
                     "max_abs_err": err, "ms": median_ms(fk),
                     "loop_ms": loop_ms(fk),
                     "launch_ms": device_ms(fk, [FUNCTIONS[name]],
                                            at_least=b_ms)[0],
                     "plain_ms": median_ms(fp), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "library_loop_ms": None, "library_launch_ms": None}
        if fl is not None:
            out[name].update(library_ms=median_ms(fl),
                             library_loop_ms=loop_ms(fl),
                             library_launch_ms=device_ms(
                                 fl, at_least=b_ms)[0])
        # and once more after the thousands of timed calls
        out[name]["max_abs_err"] = max(err, error(fk, want))
    total = int(gather_tile_sum(table, slots).sum(dtype=torch.int64))
    if total != int(merge_join_sum(table, slots).sum()):
        out["merge_join_sum"]["max_abs_err"] = float("inf")
    out["gather_tile_sum"]["ns_per_query"] = (
        out["gather_tile_sum"]["ms"] * 1e6 / n_queries)
    for k in ("ms", "launch_ms", "library_ms", "library_launch_ms"):
        out["stream_sum"]["gb_per_s_" + k] = (
            big.nbytes / out["stream_sum"][k] / 1e6)
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
