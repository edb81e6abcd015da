"""Reduction of a profiler trace of the window: device busy time as the
union of kernel and copy intervals, idle gaps named by what the host was
doing, device time by operation, kernel counts. Pure functions of
(name, start s, end s) intervals, so a test can feed them a synthetic
trace."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# the program's hand kernels by the names of their CUDA functions (K2 is
# a count launch and, when it keeps anything, a write launch)
KERNELS = {
    "K1": ("extract_kernel",),
    "K2": ("count_kernel", "write_kernel"),
    "K3": ("chain_kernel",),
    "K4": ("combine_kernel",),
}
# the program's launch counter of each kernel (one a wrapper call)
COUNTERS = {"K1": "extract_metamers", "K2": "search_scan",
            "K3": "chain_matches", "K4": "combine_paths"}
# the launch each wrapper call makes once
FIRST = {"K1": "extract_kernel", "K2": "count_kernel", "K3": "chain_kernel",
         "K4": "combine_kernel"}


@dataclass
class Trace:
    """A traced window: its span, the device operations and the host's
    spans and operations inside it, seconds on one clock."""

    window: tuple[float, float]
    device: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)    # harness spans
    ops: list = field(default_factory=list)     # host operations

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def clip(intervals, window):
    a, b = window
    return [(n, max(s, a), min(e, b)) for n, s, e in intervals
            if e > a and s < b]


def merge(intervals) -> list[tuple[float, float]]:
    """The union of intervals as sorted disjoint (start, end) spans."""
    out: list[list[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    return sum(e - s for s, e in merge(clip(tr.device, tr.window)))


def idle_pct(tr: Trace) -> float | None:
    if tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - busy_s(tr)) / tr.window_s


def gaps(tr: Trace) -> list[tuple[float, float]]:
    """The window's spans with no device operation."""
    out, t = [], tr.window[0]
    for s, e in merge(clip(tr.device, tr.window)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if tr.window[1] > t:
        out.append((t, tr.window[1]))
    return out


def _innermost(spans, t: float) -> str | None:
    best = None
    for n, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (n, e - s)
    return best[0] if best else None


def idle_gaps(tr: Trace, n: int = 10) -> list[list]:
    """The ``n`` longest idle gaps, each named by the harness span and the
    innermost host operation at its middle, or else by the host
    operations that ended last before it and began first after it."""
    top = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:n]
    out = []
    for s, e in top:
        mid = (s + e) / 2
        span = _innermost(tr.host, mid) or "window"
        op = _innermost(tr.ops, mid)
        if op is None:
            before = max((o for o in tr.ops if o[2] <= mid),
                         key=lambda o: o[2], default=None)
            after = min((o for o in tr.ops if o[1] >= mid),
                        key=lambda o: o[1], default=None)
            named = []
            if before is not None:
                named.append(f"after {before[0]}")
            if after is not None:
                named.append(f"before {after[0]}")
            op = " .. ".join(named) or None
        out.append([f"{span}: {op}" if op else span, e - s])
    return out


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespace of
    its file, template and arguments; a copy or fill as the profiler
    names it."""
    if not name:
        return "(unnamed)"
    if name.startswith(("Memcpy", "Memset")):
        return name
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()


def device_ops(tr: Trace, n: int = 10) -> list[list]:
    """The ``n`` device operations that took the most time in the
    window, summed by name."""
    tot: dict[str, float] = {}
    for name, s, e in clip(tr.device, tr.window):
        k = short_name(name)
        tot[k] = tot.get(k, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def _matches(name: str, funcs) -> bool:
    return any(re.search(rf"\b{f}\b", name) for f in funcs)


def kernel_s(tr: Trace, kernel: str) -> float:
    """Device seconds of one of the program's kernels in the window."""
    return sum(e - s for n, s, e in clip(tr.device, tr.window)
               if _matches(n, KERNELS[kernel]))


def kernel_count(tr: Trace, func: str) -> int:
    return sum(1 for n, s, e in clip(tr.device, tr.window)
               if _matches(n, (func,)))


def launches_agree(tr: Trace, launches: dict) -> bool:
    """Whether the trace holds every launch the program counted of K1-K4
    (their first kernel, once a call), and holds any."""
    seen = 0
    for k, counter in COUNTERS.items():
        got = kernel_count(tr, FIRST[k])
        if got != launches.get(counter, 0):
            return False
        seen += got
    return seen > 0


def kernels(tr: Trace) -> int:
    """Device kernels (not copies or fills) in the window."""
    return sum(1 for n, s, e in clip(tr.device, tr.window)
               if not n.lower().startswith(("memcpy", "memset")))


def from_profiler(prof, window_name: str = "window",
                  spans=("classify_file",)) -> Trace | None:
    """The Trace of a ``torch.profiler.profile`` run whose window was
    marked by ``record_function(window_name)``."""
    events = prof.profiler.kineto_results.events()
    marks = {window_name, *spans}
    rows = []
    for ev in events:
        try:
            s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        except AttributeError:
            s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        # a record_function range is also drawn on the device's timeline
        # over the kernels it launched: a mark, not an operation
        mark = ev.name() in marks or getattr(
            ev, "is_user_annotation", lambda: False)()
        rows.append((ev.name(), str(ev.device_type()), s, s + d, mark))
    win = [(s, e) for n, dt, s, e, _ in rows if n == window_name
           and dt.endswith("CPU")]
    if not win:
        return None
    tr = Trace(window=win[0])
    for n, dt, s, e, mark in rows:
        if dt.endswith("CUDA"):
            if not mark:
                tr.device.append((n, s, e))
        elif n in spans:
            tr.host.append((n, s, e))
        elif n != window_name:
            tr.ops.append((n, s, e))
    return tr
