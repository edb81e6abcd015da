"""Path combination (kernel K4) and its plain PyTorch version.

``combineMatchPaths`` (`Taxonomer.cpp:410-468`) as the reference package
runs it (``metabuli_tpu.classify.device_combine``): the paths of one
(read, species) are taken in (score desc, hamming asc, start desc) order
and accepted greedily unless they overlap an accepted path entirely or by
>= 24 bases; a smaller overlap trims the incoming path and its score by
the boundary match's per-codon terms (`trimMatchPath`, `:475-485`). The
species score is min(1, sum of accepted scores / read length).

The reference package holds at most ``p_max`` paths per group on the
device and re-combines larger groups on the host; here every group is
combined whole.
"""

from __future__ import annotations

import torch

from ..csrc import build
from .device_compact import FlatPaths
from .pipeline import sort_by_keys


def sort_paths(paths: FlatPaths):
    """Paths in (read, species, score desc, ham asc, start desc) order,
    and the [G + 1] group boundaries of the sorted rows."""
    i64 = lambda x: x.to(torch.int64)
    # pre-trim scores are > 0, so their IEEE bits order like the floats
    score_bits = i64(paths.score.view(torch.int32))
    keys = [(i64(paths.read) << 32) | i64(paths.species),
            0x7FFFFFFF - score_bits,
            (i64(paths.ham) << 32) | (0x7FFFFFFF - i64(paths.start))]
    sp = FlatPaths(*sort_by_keys(keys, paths))
    n = sp.read.numel()
    new_g = torch.ones(n, dtype=torch.bool, device=sp.read.device)
    if n:
        new_g[1:] = (sp.read[1:] != sp.read[:-1]) | \
            (sp.species[1:] != sp.species[:-1])
    heads = torch.nonzero(new_g).squeeze(1)
    group_start = torch.cat([heads, heads.new_full((1,), n)])
    return sp, group_start.to(torch.int32)


def _part_table(h16, from_right: bool):
    """[P, 9] float32: getRight/LeftPartScore (`Match.h:46-86`) over 0..8
    codons, each column the previous one plus the next codon's term (the
    reference's order of float32 additions)."""
    s = torch.zeros(h16.shape, dtype=torch.float32, device=h16.device)
    cols = [s]
    for i in range(8):
        h = (h16 >> (2 * i)) & 3 if from_right else (h16 >> (14 - 2 * i)) & 3
        s = s + torch.where(h == 0, 3.0, 2.0 - 0.5 * h.to(torch.float32))
        cols.append(s)
    return torch.stack(cols, 1)


def combine_paths_plain(sp: FlatPaths, group_start: torch.Tensor,
                        read_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the greedy runs over path rank p, every group
    in parallel, with a [P, G] table of accepted extents."""
    return combine_trims_plain(sp, group_start, read_lens)[0]


def combine_trims_plain(sp: FlatPaths, group_start: torch.Tensor,
                        read_lens: torch.Tensor):
    """``combine_paths_plain``'s scores, and the number of (path, side)
    pairs trimmed at least once: the boundary-codon words (``sh16`` or
    ``eh16``) the greedy must read, which a bound on K4's bytes counts.

    For path rank p, the accepted extents of its group that meet the
    path's own extent are taken in the order they were accepted: a trim
    only shrinks the path, so an extent it does not meet never matters,
    and the loop runs over the most such extents of any group (a few),
    not over every accepted one (hundreds in a long read's groups)."""
    dev = sp.read.device
    G = group_start.numel() - 1
    n_trimmed = torch.zeros((), dtype=torch.int64, device=dev)
    if G == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev), n_trimmed
    gs = group_start[:-1].to(torch.int64)
    run = group_start[1:].to(torch.int64) - gs
    P = int(run.max())
    acc_start = torch.zeros((P, G), dtype=torch.int32, device=dev)
    acc_end = torch.full((P, G), -(2**30), dtype=torch.int32, device=dev)
    acc_n = torch.zeros(G, dtype=torch.int64, device=dev)
    total = torch.zeros(G, dtype=torch.float32, device=dev)
    last = sp.read.numel() - 1
    left_tab = _part_table(sp.sh16, False)
    right_tab = _part_table(sp.eh16, True)
    slots = torch.arange(P, device=dev)[:, None]
    n_acc = 0  # the most any group has accepted
    for p in range(P):
        occ = p < run
        r = torch.clamp(gs + p, max=last)
        start, end, score = sp.start[r], sp.end[r], sp.score[r]
        left, right_part = left_tab[r], right_tab[r]
        rejected = ~occ
        trim_left = trim_right = torch.zeros_like(occ)
        # the accepted extents that meet the path, in accepted order
        a_s_all, a_e_all = acc_start[:n_acc], acc_end[:n_acc]
        meet = (occ & (slots[:n_acc] < acc_n) & (end >= a_s_all)
                & (a_e_all >= start))
        n_meet = meet.sum(0)
        K = int(n_meet.max()) if n_acc else 0
        first = torch.argsort((~meet).to(torch.int8), dim=0, stable=True)[:K]
        for k in range(K):
            has_j = k < n_meet
            a_s = a_s_all.gather(0, first[k:k + 1])[0]
            a_e = a_e_all.gather(0, first[k:k + 1])[0]
            disjoint = (end < a_s) | (a_e < start)
            ov = torch.minimum(end, a_e) - torch.maximum(start, a_s) + 1
            full = ov == end - start + 1
            overlap = has_j & ~rejected & ~disjoint
            reject = overlap & (full | (ov >= 24))
            trim = overlap & ~full & (ov < 24)
            right = start < a_s
            rng = torch.clamp(torch.div(ov, 3, rounding_mode="floor"),
                              0, 8)[:, None]
            part = torch.where(right, right_part.gather(1, rng)[:, 0],
                               left.gather(1, rng)[:, 0])
            t_score = score - part - torch.remainder(ov, 3).to(torch.float32)
            score = torch.where(trim, t_score, score)
            start = torch.where(trim & ~right, a_e + 1, start)
            end = torch.where(trim & right, a_s - 1, end)
            rejected = rejected | reject
            trim_left = trim_left | (trim & ~right)
            trim_right = trim_right | (trim & right)
        n_trimmed = n_trimmed + trim_left.sum() + trim_right.sum()
        accept = ~rejected
        at = torch.nonzero(accept).squeeze(1)
        acc_start[acc_n[at], at] = start[at]
        acc_end[acc_n[at], at] = end[at]
        acc_n = acc_n + accept.to(torch.int64)
        n_acc = min(n_acc + 1, P) if at.numel() else n_acc
        total = total + torch.where(accept, score, 0.0)
    rl = read_lens[torch.clamp(sp.read[gs].to(torch.int64), 0,
                               read_lens.numel() - 1)]
    return torch.clamp(total / torch.clamp(rl, min=1).to(torch.float32),
                       max=1.0), n_trimmed


def combine_paths(sp: FlatPaths, group_start: torch.Tensor,
                  read_lens: torch.Tensor) -> torch.Tensor:
    """Kernel K4 wrapper (a thread per group): [G] float32 species
    scores. CPU tensors take the plain version. Either way the call's
    groups and paths count in ``build.launches["combine_paths.groups"]``
    and ``["combine_paths.paths"]``."""
    build.launches["combine_paths.groups"] += max(0, group_start.numel() - 1)
    build.launches["combine_paths.paths"] += sp.read.numel()
    if sp.read.device.type == "cpu":
        return combine_paths_plain(sp, group_start, read_lens)
    build.require_cuda("combine_paths", *sp, group_start, read_lens)
    if sp.score.dtype != torch.float32 or {
            t.dtype for t in (*sp[:4], *sp[5:], group_start, read_lens)
    } != {torch.int32}:
        raise TypeError("combine_paths: float32 path scores, every other "
                        "column, group_start and read_lens int32")
    dev = sp.read.device
    G = group_start.numel() - 1
    if G <= 0:
        return torch.empty(0, dtype=torch.float32, device=dev)
    # one allocation: the [G] scores, then, 8-byte aligned, a row per path
    # for the accepted extents of the path's group
    off = G + (G & 1)
    buf = torch.empty(off + 2 * sp.read.numel(), dtype=torch.int32,
                      device=dev)
    out = buf[:G].view(torch.float32)
    rc = build.get_lib().mtb_combine_paths(
        G, group_start.data_ptr(), sp.read.data_ptr(), sp.start.data_ptr(),
        sp.end.data_ptr(), sp.score.data_ptr(), sp.sh16.data_ptr(),
        sp.eh16.data_ptr(), read_lens.data_ptr(), read_lens.numel(),
        sp.read.numel(), buf.data_ptr() + 4 * off, out.data_ptr(),
        build.stream(dev))
    build.check(rc, "combine_paths")
    build.launches["combine_paths"] += 1
    return out
