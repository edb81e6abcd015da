"""Probes P1-P4 (``metabuli_tpu_torch.tools.probes``): the plain versions
against the JAX expressions the profiling scripts hold their Pallas kernels
to (``tools_profiling/pallas_probe_prototype.py``'s ``xla_gather``, and
``profile_tier_slices.py``'s ``x * 2`` and int32 word sum), jit on the CPU,
at small sizes. Tolerance is zero: every output is an integer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metabuli_tpu_torch.tools import probes


def _table_slots(seed, table_bits=14, n=8 * probes.TILE_Q):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 31, size=1 << table_bits, dtype=np.int32)
    slots = rng.integers(0, 1 << table_bits, size=n).astype(np.int32)
    return table, slots


def _case(case, n=8 * probes.TILE_Q, table_bits=14):
    """(table, slots) of a named slot distribution, from a numpy seed: an
    int is a uniform seed; ``one_tile``: every query in table tile 3;
    ``first_last``: only the first and the last slot; ``ascending``:
    uniform slots sorted; ``gap_tile``: tiles 0 and 2 only, tile 1 (and
    the rest) empty; ``n_plus_3``: uniform, 3 queries past whole tiles of
    queries (P2 only: P1 takes whole tiles)."""
    if isinstance(case, int):
        return _table_slots(case, table_bits, n)
    rng = np.random.default_rng(sum(map(ord, case)))
    table = rng.integers(0, 1 << 31, size=1 << table_bits, dtype=np.int32)
    T = probes.TILE_T
    slots = {
        "one_tile": lambda: rng.integers(3 * T, 4 * T, size=n),
        "first_last": lambda: rng.choice([0, table.size - 1], size=n),
        "ascending": lambda: np.sort(rng.integers(0, table.size, size=n)),
        "gap_tile": lambda: rng.integers(0, T, size=n)
        + 2 * T * rng.integers(0, 2, size=n),
        "n_plus_3": lambda: rng.integers(0, table.size, size=n + 3),
    }[case]()
    return table, slots.astype(np.int32)


CASES = [0, 1, "one_tile", "first_last", "ascending", "gap_tile"]


@jax.jit
def _xla_gather_sum(t, s):
    # the prototype's baseline (pallas_probe_prototype.py:64-65)
    return jnp.sum((t[s] & 0xFFFF).astype(jnp.int64))


@pytest.mark.parametrize("seed", CASES)
def test_p1_gather_tile_sum_matches_jax(seed):
    table, slots = _case(seed)
    got = probes.gather_tile_sum(torch.from_numpy(table),
                                 torch.from_numpy(slots))
    assert got.shape == (slots.size // probes.TILE_Q, 1)
    assert got.dtype == torch.int32
    tiles = jax.jit(lambda t, s: jnp.sum(
        (t[s] & 0xFFFF).reshape(-1, probes.TILE_Q), axis=1))(table, slots)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(tiles))
    assert int(got.sum(dtype=torch.int64)) == int(_xla_gather_sum(table, slots))


@pytest.mark.parametrize("seed", CASES + ["n_plus_3"])
def test_p2_merge_join_sum_matches_jax(seed):
    table, slots = _case(seed)
    got = probes.merge_join_sum(torch.from_numpy(table),
                                torch.from_numpy(slots))
    n_tiles = table.size // probes.TILE_T
    assert got.shape == (n_tiles, 1) and got.dtype == torch.int64
    per_tile = jax.jit(lambda t, s: jax.ops.segment_sum(
        (t[s] & 0xFFFF).astype(jnp.int64), s // probes.TILE_T,
        num_segments=n_tiles))(table, slots)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(per_tile))
    # the merge join sums what the gather sums
    assert int(got.sum()) == int(_xla_gather_sum(table, slots))


def test_p3_smoke_double_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, size=(8, 128), dtype=np.int32)
    got = probes.smoke_double(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.jit(lambda v: v * 2)(x)))


@pytest.mark.parametrize("n", [0, 1, 3, 5, 1023, 1025, "view"])
def test_p3_smoke_double_odd_and_empty_match_jax(n):
    """Word counts around the kernel's 16-byte vectors, none, and a view
    that starts one word into its buffer."""
    rng = np.random.default_rng(7)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, size=1025 if n == "view"
                     else n, dtype=np.int32)
    t = torch.from_numpy(x)
    if n == "view":
        t, x = t[1:], x[1:]
    got = probes.smoke_double(t)
    assert got.shape == t.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.jit(lambda v: v * 2)(x)))


@pytest.mark.parametrize("words", [0, 1, 3, 5, 8191, 8193])
def test_p4_stream_sum_odd_and_empty_int32_match_jax(words):
    """int32 tables of word counts that leave 1-3 tail words past the
    16-byte vectors, around one 8,192-word chunk of the kernel's ring, and
    none."""
    rng = np.random.default_rng(words)
    tab = rng.integers(-(1 << 31), (1 << 31) - 1, size=words, dtype=np.int32)
    got = probes.stream_sum(torch.from_numpy(tab))
    assert got.shape == (1, 1) and got.dtype == torch.int32
    want = jax.jit(lambda t: jnp.sum(t, dtype=jnp.int32))(tab)
    assert int(got[0, 0]) == int(want)


@pytest.mark.parametrize("rows", [1, 1 << 12, (1 << 12) + 3])
def test_p4_stream_sum_matches_jax(rows):
    rng = np.random.default_rng(rows)
    tab = rng.integers(0, np.iinfo(np.uint64).max, size=rows, dtype=np.uint64,
                       endpoint=True)
    got = probes.stream_sum(torch.from_numpy(tab.view(np.int64)))
    assert got.shape == (1, 1) and got.dtype == torch.int32
    # int32 accumulation wraps mod 2^32, as the probe's int32 output does
    want = jax.jit(lambda t: jnp.sum(
        jax.lax.bitcast_convert_type(t, jnp.int32), dtype=jnp.int32))(tab)
    assert int(got[0, 0]) == int(want)


def test_probes_reject_partial_tiles_and_wrong_dtypes():
    table, slots = _table_slots(0)
    with pytest.raises(ValueError):
        probes.gather_tile_sum(torch.from_numpy(table),
                               torch.from_numpy(slots[:-1]))
    with pytest.raises(ValueError):
        probes.merge_join_sum(torch.from_numpy(table[:-1]),
                              torch.from_numpy(slots))
    with pytest.raises(TypeError):
        probes.smoke_double(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        probes.stream_sum(torch.zeros(4, dtype=torch.int16))


def test_launch_helpers_refuse_cpu_tensors_and_runners_need_a_card():
    """The shared launch path's check raises for CPU tensors; the probe
    runner exits 1 without a card (the tests run on the CPU)."""
    from metabuli_tpu_torch.csrc import build

    with pytest.raises(ValueError):
        build.require_cuda("x", torch.zeros(4, dtype=torch.int32),
                           dtype=torch.int32)
    if not torch.cuda.is_available():
        assert probes.main() == 1


def test_device_ms_traces_again_when_a_trace_lost_launches(monkeypatch):
    """A trace holding only some launches of 5 calls, or none, or times
    under the call's bound is taken again; after 5 such traces device_ms
    raises. The traces are stand-ins: the profiler's CUDA activity needs a
    card."""
    traces = iter([({"k": [1.0, 1.0]}, {"k"}), ({"k": []}, set()),
                   ({"k": [0.5] * 5}, {"k"})]
                  + [({"k": [0.01] * 5}, {"k"})] * 5)
    monkeypatch.setattr(probes, "_trace", lambda fn, f, runs: next(traces))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert probes.device_ms(lambda: None, ["k"], at_least=0.1) == (
        0.5, {"k": 0.5})
    with pytest.raises(RuntimeError):
        probes.device_ms(lambda: None, ["k"], at_least=0.1)


def test_device_ms_takes_whole_traces_only_and_measure_records_lost(
        monkeypatch):
    """Every function's launches in a trace must be a whole multiple of
    the calls: a trace that lost one launch of 5 is taken again. When all
    5 traces lost launches, device_ms raises LostLaunches, and a probe's
    record holds launch_ms None and says why (launch_lost). Stand-in
    traces and timers: they need a card."""
    lost = ({"k": [0.4, 0.5, 0.6, 0.5]}, {"k"})
    traces = iter([lost, ({"k": [0.5] * 5}, {"k"}),
                   ({"lib": [0.2] * 4}, {"lib"}),
                   ({"lib": [0.2] * 10}, {"lib"})] + [lost] * 5)
    monkeypatch.setattr(probes, "_trace", lambda fn, f, runs: next(traces))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert probes.device_ms(lambda: None, ["k"]) == (0.5, {"k": 0.5})
    assert probes.device_ms(lambda: None) == (0.4, {"lib": 0.4})
    monkeypatch.setitem(probes.FUNCTIONS, "k", ["k"])
    for timer in ("median_ms", "loop_ms"):
        monkeypatch.setattr(probes, timer, lambda fn, **kw: 1.0)
    one = torch.ones((1, 1), dtype=torch.int32)
    rec = probes.measure("k", lambda: one, lambda: one, 4)
    assert rec["launch_ms"] is None and rec["launch_parts_ms"] == {}
    assert "launch_ms" in rec["launch_lost"] and rec["max_abs_err"] == 0
    assert rec["ms"] == 1.0 and next(traces, None) is None
    traces = iter([lost] * 5)
    with pytest.raises(probes.LostLaunches):
        probes.device_ms(lambda: None, ["k"])


class _Event:
    def __init__(self, name, us):
        self.name, self.us = name, us
        self.device_type = torch.autograd.DeviceType.CUDA
        self.time_range = self

    def elapsed_us(self):
        return self.us


def test_device_ms_sums_every_function_and_not_the_eviction(monkeypatch):
    """P2's call launches four kernels: launch_ms is the sum of all of
    them; the L2 eviction launched before each call counts neither in a
    named probe's time nor in a library call's (functions=None). The
    profiler is a stand-in: its CUDA activity needs a card."""
    runs = 2
    names = {"ns::partition_count_kernel(int)": 4.0,
             "ns::partition_scan_kernel(int)": 2.0,
             "ns::partition_scatter_kernel(int)": 6.0,
             "ns::merge_join_kernel(int)": 8.0,
             f"ns::{probes.EVICT_FUNCTION}(int4 const*)": 30.0}
    calls = []

    class _Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def events(self):
            return [_Event(k, v) for k, v in names.items()] * runs

    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ms, parts = probes.device_ms(lambda: calls.append("call"),
                                 probes.FUNCTIONS["merge_join_sum"],
                                 runs=runs,
                                 before=lambda: calls.append("evict"))
    assert ms == pytest.approx(0.020)
    assert set(parts) == set(probes.FUNCTIONS["merge_join_sum"])
    # the warm-up and each traced call come after their eviction
    assert calls == ["evict", "call"] * (runs + 1)
    ms_all, parts_all = probes.device_ms(lambda: None, runs=runs)
    assert ms_all == pytest.approx(0.020)
    assert not any(probes.EVICT_FUNCTION in k for k in parts_all)
