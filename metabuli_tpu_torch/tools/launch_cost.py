"""Host cost of each step of a kernel wrapper's launch path, on the card.

    python -m metabuli_tpu_torch.tools.launch_cost

The steps are those of the P3 wrapper (``tools.probes.smoke_double``) on
its [8, 128] int32 input, each timed alone with the host clock (no CUDA
events) over 10,000 calls, beside the whole wrapper and
``torch.mul(x, 2)``. Prints one JSON line: ns a call per step, median of
3 rounds after a warm-up round, the card's name and power limit. A step
that this checkout's helpers do not offer is recorded as null. The steps
that launch a kernel (``ctypes_launch``, ``wrapper``, ``torch_mul``) time
the host's enqueue, as long as the card keeps up with it. ``empty`` is the
cost of the timing loop itself, held in every other number.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from ..csrc import build
from . import probes


def _steps(x: torch.Tensor) -> dict:
    """step name -> a function doing that step alone, as the wrapper does
    it (``x`` on the card)."""
    dev = x.device
    out = torch.empty_like(x)
    lib = build.get_lib()
    st = build.stream(dev)
    fn = lib.mtb_probe_double
    # the same function through a handle that drops the interpreter lock
    # around each call (ctypes.CDLL), beside the build's own handle
    cdll = ctypes.CDLL(build.SO).mtb_probe_double
    cdll.argtypes, cdll.restype = fn.argtypes, fn.restype
    xp, n, op = x.data_ptr(), x.numel(), out.data_ptr()
    counts = build.launches

    def count():
        counts["smoke_double"] += 1

    return {
        "empty": lambda: None,
        "device_type": lambda: x.device.type == "cpu",
        "is_cpu": lambda: x.is_cpu,
        "check_i32": lambda: probes._check_i32("smoke_double", x),
        "require_cuda": lambda: build.require_cuda("smoke_double", x),
        "require_cuda_dtype": lambda: build.require_cuda(
            "smoke_double", x, dtype=torch.int32),
        "empty_like": lambda: torch.empty_like(x),
        "get_lib": build.get_lib,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "build_stream": lambda: build.stream(dev),
        "data_ptr_numel": lambda: (x.data_ptr(), x.numel(), out.data_ptr()),
        "ctypes_launch": lambda: fn(xp, n, op, st),
        "ctypes_launch_cdll": lambda: cdll(xp, n, op, st),
        "check": lambda: build.check(0, "smoke_double"),
        "count": count,
        "wrapper": lambda: probes.smoke_double(x),
        "torch_mul": lambda: torch.mul(x, 2),
    }


CALLS = 10_000
ROUNDS = 3


def measure() -> dict:
    """ns a call of each step (None where this checkout lacks it)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (8, 128), generator=g,
                      dtype=torch.int32, device="cuda")
    res = {}
    for name, f in _steps(x).items():
        try:
            f()
        except (TypeError, AttributeError):
            res[name] = None
            continue
        times = []
        for _ in range(ROUNDS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                f()
            times.append((time.perf_counter() - t0) / CALLS * 1e9)
        torch.cuda.synchronize()
        res[name] = sorted(times[1:])[ROUNDS // 2]
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the launch path is measured only on one",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "calls": CALLS, "ns": measure()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
