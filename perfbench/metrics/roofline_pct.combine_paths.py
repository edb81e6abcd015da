"""K4's (``csrc/combine.cu``) share of its memory roofline: the least
time, ``least_bytes`` of the window's K4 calls at the card's HBM
bandwidth, over K4's device time in the profiler trace. The calls' groups
and paths come from the program's counters ``combine_paths.groups`` and
``combine_paths.paths`` (G and the paths of each call); a program without
them gives nothing."""

from harness import trace

# a path's columns every combination reads: start, end, score
PATH_BYTES = 3 * 4
# a group's: its bound in group_start, its head path's read, that read's
# length, the species score written
GROUP_BYTES = 4 * 4


def least_bytes(groups: int, paths: int) -> int:
    """The least bytes K4 moves over ``groups`` (read, species) groups of
    ``paths`` paths: each path's extent and score read once, each group's
    bound, read and read length read once and its score written once
    (group_start's closing bound aside). A path's start and end codon
    words are read only where it overlaps an accepted path, which the
    data decides: not counted."""
    return PATH_BYTES * paths + GROUP_BYTES * groups


def read(ctx):
    groups = ctx.launches.get("combine_paths.groups")
    paths = ctx.launches.get("combine_paths.paths")
    if ctx.trace is None or not ctx.trace_complete or not groups:
        return None
    k4 = trace.kernel_s(ctx.trace, "K4")
    if k4 <= 0:
        return None
    return (100.0 * least_bytes(groups, paths or 0)
            / ctx.peaks["hbm_bytes_per_s"] / k4)
