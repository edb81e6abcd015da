"""K3's (``csrc/chain.cu``) share of its memory roofline: the least time,
``least_bytes`` of the window's K3 calls at the card's HBM bandwidth,
over K3's device time in the profiler trace. The calls' rows come from
the program's counter ``chain_matches.matches`` (the M of each call); a
program without it gives nothing."""

from harness import trace

# a match's columns K3 reads: qid, species, frame, pos, hamming, dna, h16
IN_BYTES = 7 * 4
# a row's outputs K3 writes: score, path start, hamming, depth, start
# h16 (4 B each) and the emit flag (1 B)
OUT_BYTES = 5 * 4 + 1


def least_bytes(matches: int) -> int:
    """The least bytes K3 moves over ``matches`` rows: each match's seven
    int32 columns read once, each row's outputs written once (the
    species' minimum depth, a small table, not counted)."""
    return (IN_BYTES + OUT_BYTES) * matches


def read(ctx):
    matches = ctx.launches.get("chain_matches.matches")
    if ctx.trace is None or not ctx.trace_complete or not matches:
        return None
    k3 = trace.kernel_s(ctx.trace, "K3")
    if k3 <= 0:
        return None
    return 100.0 * least_bytes(matches) / ctx.peaks["hbm_bytes_per_s"] / k3
