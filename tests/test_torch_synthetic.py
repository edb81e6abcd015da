"""Synthetic path groups for kernel K4 (``combine_paths``), shared by the
CPU test against JAX (test_torch_taxonomer.py) and the card's test against
the plain version (test_torch_kernels.py), and a CPU check of the
generator itself."""

import numpy as np
import torch

from metabuli_tpu_torch.classify.device_combine import (combine_paths_plain,
                                                        sort_paths)
from metabuli_tpu_torch.classify.device_compact import FlatPaths


def synthetic_paths(rng, sizes, disjoint=(), ties=False, span=300):
    """Unsorted ``FlatPaths`` (CPU) and read lengths: group g (read g // 3,
    species 2 + g % 3) holds ``sizes[g]`` paths 24-111 bases long inside
    ``span`` bases, so they nest and chain (a path is trimmed by several
    accepted ones in turn). A group in ``disjoint`` holds that many
    disjoint 24-base paths, all accepted, then up to 24 lower-scored paths
    anywhere among them, which meet accepted extents early and late in
    the accepted order. ``ties``: every path scores the same. Read lengths
    keep every species score below 1."""
    rows = []
    for g, n in enumerate(sizes):
        read, sp = g // 3, 2 + g % 3
        for i in range(n):
            if g in disjoint:
                start, length, score = 30 * i, 24, 0.5
            else:
                start = int(rng.integers(0, span - 24))
                length = 24 + 3 * int(rng.integers(
                    0, min(30, (span - start - 24) // 3) + 1))
                score = (20.0 if ties else
                         3.0 * (1 + (length - 24) // 3) + 8
                         + int(rng.integers(0, 40)) * 0.5)
            rows.append((read, sp, start, start + length - 1, score,
                         0 if g in disjoint else int(rng.integers(0, 12)),
                         int(rng.integers(0, 1 << 16)),
                         int(rng.integers(0, 1 << 16))))
        for _ in range(min(n // 2, 24) if g in disjoint else 0):
            start = int(rng.integers(0, 30 * n))
            rows.append((read, sp, start, start + 23 + 3 * int(
                rng.integers(0, 4)), 0.25 + int(rng.integers(0, 8)) * 0.03125,
                0, int(rng.integers(0, 1 << 16)),
                int(rng.integers(0, 1 << 16))))
    rng.shuffle(rows)
    a = np.array([(r[0], r[1], r[2], r[3], r[5], r[6], r[7]) for r in rows],
                 np.int32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    paths = FlatPaths(
        t(a[:, 0]), t(a[:, 1]), t(a[:, 2]), t(a[:, 3]),
        t(np.array([r[4] for r in rows], np.float32)), t(a[:, 4]),
        t(a[:, 5]), t(a[:, 6]))
    read_lens = rng.integers(2000, 4000, len(sizes) // 3 + 1)
    return paths, t(read_lens.astype(np.int32))


def test_synthetic_groups_have_their_sizes_and_accept_disjoint_paths():
    """Each group holds its paths (a disjoint group also its extra ones),
    the disjoint group's 24-base paths come first in the sorted order and
    do not overlap, and every species score is finite and below 1."""
    sizes = [1, 31, 40, 70]
    paths, rl = synthetic_paths(np.random.default_rng(5), sizes,
                                disjoint=(2,))
    sp, gstart = sort_paths(paths)
    assert np.diff(gstart.numpy()).tolist() == [1, 31, 40 + 20, 70]
    s = int(gstart[2])
    start, end = sp.start[s:s + 40].numpy(), sp.end[s:s + 40].numpy()
    assert (end - start == 23).all() and (start[:-1] > end[1:]).all()
    got = combine_paths_plain(sp, gstart, rl)
    assert torch.isfinite(got).all() and float(got.max()) < 1.0
