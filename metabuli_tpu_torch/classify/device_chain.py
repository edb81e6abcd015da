"""Match chaining (kernel K3) and its plain PyTorch version.

The chain DP of ``getMatchPaths`` (`Taxonomer.cpp:487-648`) as the
reference package runs it (``metabuli_tpu.classify.device_chain``): matches
sorted by (read, species, frame, pos) form blocks of one (read, species,
frame); inside a block, matches with the same position quotient pos // 3
form a group. Walking the groups in order, a match of the current group
connects to a match of the previous group iff the quotient shift is in
[1, maxCodonShift] and their 24-bit codon words overlap (isConsecutive2,
operands swapped on reverse frames); it extends the best-scoring
connectable predecessor (first wins ties, score must be > 0). A previous
match that connects to nothing ends a path, emitted at depth >= the
species' minConsCnt; the last group is emitted likewise when the block
has at least two groups.

Every match carries exactly one path state (its own, or the extension
through it), and each state is emitted at most once, so the result is
per row: the path ending at that row and an emit flag. Paths in row order
are then block-major, and within a block in (group, slot) order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..csrc import build
from .device_redundancy import seg_broadcast

NEG = -1e30


class ChainResult(NamedTuple):
    """Per match row: the path that ends there, and whether it is emitted."""

    emit: torch.Tensor    # [M] bool
    score: torch.Tensor   # [M] float32
    start: torch.Tensor   # [M] int32 query coordinate of the first match
    ham: torch.Tensor     # [M] int32
    depth: torch.Tensor   # [M] int32
    sh16: torch.Tensor    # [M] int32 h16 of the path's first match


def _h(h16, i):
    return (h16 >> (2 * i)) & 3


def _term(h):
    """Match::getScore per codon (`Match.h:32-44`), float32."""
    return torch.where(h == 0, 3.0, 2.0 - 0.5 * h.to(torch.float32))


def _match_score(h16: torch.Tensor) -> torch.Tensor:
    s = torch.zeros(h16.shape, dtype=torch.float32, device=h16.device)
    for i in range(8):
        s = s + _term(_h(h16, i))
    return s


def _increment(h16: torch.Tensor, shift: torch.Tensor):
    """(score, hamming) over the low ``shift`` codons (`Taxonomer.cpp:650-669`)."""
    s = torch.zeros(h16.shape, dtype=torch.float32, device=h16.device)
    hd = torch.zeros(h16.shape, dtype=torch.int32, device=h16.device)
    for i in range(8):
        h = _h(h16, i)
        use = i < shift
        s = s + torch.where(use, _term(h), 0.0)
        hd = hd + torch.where(use, h, 0)
    return s, hd


def _blocks(qid, species, frame):
    n = qid.numel()
    new_block = torch.ones(n, dtype=torch.bool, device=qid.device)
    if n:
        new_block[1:] = ((qid[1:] != qid[:-1]) | (species[1:] != species[:-1])
                         | (frame[1:] != frame[:-1]))
    return new_block


def chain_matches_plain(qid, species, frame, pos, ham, dna, h16,
                        min_depth_of_species, *, max_shift: int,
                        kmer_format: int = 2) -> ChainResult:
    """Plain version of K3: one pass over the columns of a dense
    [column, slot, block] grid, every block in parallel, as the reference
    package's scan does, but with the grid sized to fit every block."""
    dev = qid.device
    M = qid.numel()
    i32 = torch.int32
    if M == 0:
        z = torch.zeros(0, dtype=i32, device=dev)
        return ChainResult(z.bool(), z.float(), z, z, z, z)
    idx = torch.arange(M, device=dev)
    new_block = _blocks(qid, species, frame)
    bid = torch.cumsum(new_block.long(), 0) - 1
    q = torch.div(pos.long(), 3, rounding_mode="floor")
    col = q - seg_broadcast(new_block, q)
    cell_new = torch.ones(M, dtype=torch.bool, device=dev)
    cell_new[1:] = (bid[1:] != bid[:-1]) | (col[1:] != col[:-1])
    slot = idx - torch.cummax(torch.where(cell_new, idx, 0), 0)[0]
    NB = int(bid[-1]) + 1
    w = int(col.max()) + 1
    k = int(slot.max()) + 1

    def grid(x, fill):
        g = torch.full((w, k, NB), fill, dtype=x.dtype, device=dev)
        g[col, slot, bid] = x
        return g

    occ_g = grid(torch.ones(M, dtype=torch.bool, device=dev), False)
    dna_g = grid(dna, 0)
    h16_g = grid(h16, 0)
    ham_g = grid(ham, 0)
    pos_g = grid(pos, 0)
    heads = torch.nonzero(new_block).squeeze(1)
    q0 = q[heads]
    forward = frame[heads] < 3
    if kmer_format != 2:  # old format: isConsecutive (roles swapped)
        forward = ~forward
    n_sp = min_depth_of_species.numel()
    bmin = min_depth_of_species[torch.clamp(species[heads].long(), max=n_sp - 1)]

    # carried state of each block's previous non-empty group
    n_groups = torch.zeros(NB, dtype=i32, device=dev)
    last_q = torch.zeros(NB, dtype=torch.int64, device=dev)
    last_c = torch.zeros(NB, dtype=torch.int64, device=dev)
    occ = torch.zeros((k, NB), dtype=torch.bool, device=dev)
    c_dna = torch.zeros((k, NB), dtype=i32, device=dev)
    p_score = torch.zeros((k, NB), dtype=torch.float32, device=dev)
    p_start = torch.zeros((k, NB), dtype=i32, device=dev)
    p_ham = torch.zeros((k, NB), dtype=i32, device=dev)
    p_depth = torch.zeros((k, NB), dtype=i32, device=dev)
    p_sh16 = torch.zeros((k, NB), dtype=i32, device=dev)
    # per cell outputs: the path state set at its column, emit flag
    g_score = torch.zeros((w, k, NB), dtype=torch.float32, device=dev)
    g_start = torch.zeros((w, k, NB), dtype=i32, device=dev)
    g_ham = torch.zeros((w, k, NB), dtype=i32, device=dev)
    g_depth = torch.zeros((w, k, NB), dtype=i32, device=dev)
    g_sh16 = torch.zeros((w, k, NB), dtype=i32, device=dev)
    g_emit = torch.zeros((w, k, NB), dtype=torch.bool, device=dev)
    blocks = torch.arange(NB, device=dev)
    for c in range(w):
        occ_c = occ_g[c]
        dna_c = dna_g[c]
        h16_c = h16_g[c]
        has_cur = occ_c.any(0)
        cur_q = q0 + c
        shift = torch.where(n_groups > 0, cur_q - last_q, 1 << 30)
        connectable = has_cur & (shift >= 1) & (shift <= max_shift)
        sh = torch.clamp(shift, 1, 8)
        mask_bits = (1 << (24 - 3 * sh)) - 1
        sh3 = 3 * sh
        prev = c_dna[:, None, :].long()      # [k_i, 1, NB]
        cur = dna_c[None, :, :].long()       # [1, k_j, NB]
        c_fwd = (prev & mask_bits) == (cur >> sh3)
        c_rev = (cur & mask_bits) == (prev >> sh3)
        conn = (torch.where(forward, c_fwd, c_rev) & occ[:, None, :]
                & occ_c[None, :, :] & connectable)
        inc_s, inc_h = _increment(h16_c, sh[None, :])
        # best predecessor: first maximum among connectable scores
        cand = torch.where(conn, p_score[:, None, :], NEG)
        best = torch.argmax(cand, dim=0)     # [k_j, NB]
        has_pred = torch.gather(cand, 0, best[None])[0] > 0.0

        def pick(x):
            return torch.gather(x, 0, best)

        new_score = torch.where(has_pred, pick(p_score) + inc_s,
                                _match_score(h16_c))
        new_start = torch.where(has_pred, pick(p_start), pos_g[c])
        new_ham = torch.where(has_pred, pick(p_ham) + inc_h, ham_g[c])
        new_depth = torch.where(has_pred, pick(p_depth) + sh.to(i32), 1)
        new_sh16 = torch.where(has_pred, pick(p_sh16), h16_c)
        # previous group's paths that connect to nothing end here
        emit = occ & has_cur & ~conn.any(1) & (p_depth >= bmin)
        sel = has_cur
        if bool(sel.any()):
            b = blocks[sel]
            g_emit[last_c[sel], :, b] = emit[:, sel].T
        g_score[c], g_start[c], g_ham[c] = new_score, new_start, new_ham
        g_depth[c], g_sh16[c] = new_depth, new_sh16
        pick_new = lambda new, old: torch.where(sel[None, :], new, old)
        occ = pick_new(occ_c, occ)
        c_dna = pick_new(dna_c, c_dna)
        p_score = pick_new(new_score, p_score)
        p_start = pick_new(new_start, p_start)
        p_ham = pick_new(new_ham, p_ham)
        p_depth = pick_new(new_depth, p_depth)
        p_sh16 = pick_new(new_sh16, p_sh16)
        n_groups = n_groups + sel.to(i32)
        last_q = torch.where(sel, cur_q, last_q)
        last_c = torch.where(sel, torch.full_like(last_c, c), last_c)
    # the last group ends every path still open, given >= 2 groups
    f_emit = occ & (p_depth >= bmin) & (n_groups >= 2)[None, :]
    g_emit[last_c, :, blocks] = f_emit.T
    at = (col, slot, bid)
    return ChainResult(g_emit[at], g_score[at], g_start[at], g_ham[at],
                       g_depth[at], g_sh16[at])


def chain_matches(qid, species, frame, pos, ham, dna, h16,
                  min_depth_of_species, *, max_shift: int,
                  kmer_format: int = 2) -> ChainResult:
    """Kernel K3 wrapper (a warp walks the blocks that start in its window
    of rows in tiles of 32, a lane per row; the kernel finds the blocks
    itself, so there is no host sync). CPU tensors take the plain
    version. Either way the call's rows count in
    ``build.launches["chain_matches.matches"]``."""
    build.launches["chain_matches.matches"] += qid.numel()
    if qid.device.type == "cpu":
        return chain_matches_plain(qid, species, frame, pos, ham, dna, h16,
                                   min_depth_of_species, max_shift=max_shift,
                                   kmer_format=kmer_format)
    cols = [t.to(torch.int32).contiguous()
            for t in (qid, species, frame, pos, ham, dna, h16)]
    qid, species, frame, pos, ham, dna, h16 = cols
    md = min_depth_of_species.to(torch.int32).contiguous()
    build.require_cuda("chain_matches", *cols, md)
    dev = qid.device
    M = qid.numel()
    if M >= 1 << 31:
        raise ValueError(f"chain_matches: {M} rows, the kernel takes < 2^31")
    # the kernel writes every row of every output (one allocation for the
    # five 32-bit columns)
    emit = torch.empty(M, dtype=torch.bool, device=dev)
    cols32 = torch.empty((5, M), dtype=torch.int32, device=dev)
    score = cols32[0].view(torch.float32)
    start, p_ham, depth, sh16 = cols32[1:]
    if M == 0:
        return ChainResult(emit, score, start, p_ham, depth, sh16)
    rc = build.get_lib().mtb_chain_matches(
        M, qid.data_ptr(), species.data_ptr(), frame.data_ptr(),
        pos.data_ptr(), ham.data_ptr(), dna.data_ptr(), h16.data_ptr(),
        md.data_ptr(), md.numel(), max_shift, kmer_format,
        score.data_ptr(), start.data_ptr(), p_ham.data_ptr(),
        depth.data_ptr(), sh16.data_ptr(), emit.data_ptr(),
        build.stream(dev))
    build.check(rc, "chain_matches")
    build.launches["chain_matches"] += 1
    return ChainResult(emit, score, start, p_ham, depth, sh16)
