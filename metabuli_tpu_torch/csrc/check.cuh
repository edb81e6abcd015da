// Bounds checks of the checked build (METABULI_TPU_CUDA_CHECKED=1,
// csrc/build.py: -DMTB_CHECKED -lineinfo, into
// _build/libmetabuli_cuda_checked.so).
//
// MTB_CHECK(cond, idx, limit) stands before a global load or store whose
// address comes from data the kernel read. In the checked build a failed
// check prints the kernel's source line, the index and its limit, then
// traps: the launch fails, and the caller's next synchronisation reports
// it. Without -DMTB_CHECKED the macro is empty and its arguments are not
// evaluated, so the normal library's code, registers and shared memory are
// those of the sources without the checks (chip_smoke.py's resources
// phase reads them from ptxas).
//
// A memory checker (compute-sanitizer) does not run on the card's machine;
// this is what stands in for it there, beside each kernel's edge-shape
// tests against its plain version (tests/test_torch_kernels.py).
//
// Checked accesses, by kernel; an affine index inside a bound the kernel
// already tests needs none. Each limit is a length the wrapper passes
// from its tensors (an element count, not one worked out from the grid or
// from the index itself), so a view or an allocation too short traps:
//   extract_kernel (K1, extract.cu): the row's 4-byte base words (the
//     chunk's span, rounded to words, must start inside codes), the slot
//     written (against the outputs' elements).
//   count_kernel / write_kernel (K2, K11, search_scan.cu): the bucket's
//     prefix entries or record (from the key's prefix bits, against the
//     prefix or record tensor's length), each lower
//     bound step's grest entry and the group's gstart / gend, every window
//     row of the table word (from gstart and the window's length), the
//     stash slot (from the pool's cursor), the write launch's warp counts,
//     its stash entries and its output offsets (from the count scan).
//   chain_kernel (K3, chain.cu): min_depth[species], and every row read
//     or written by index rather than by lane: rows past a tile's first
//     32, the carried group's, the tile's group runs.
//   combine_kernel (K4, combine.cu): the group's path range (group_start),
//     its accepted-extent rows, the read id and read_lens[read].
//   aa_kmers_kernel, aa_kmers_dna_warp_kernel, aa_kmers_dna_kernel (K12,
//     aa_kmers.cu): each item's row span of codes, the row's length against
//     the row (it sets which bases are read), every output tile's offsets
//     (the chunk kernel's against the outputs' elements).
//   gather_tile_sum_kernel (P1, probes.cu): none; its one data-addressed
//     load, the table slot, is predicated on the slot lying in the table.
//   partition_*_kernel, merge_join_kernel (P2): the tile a slot falls in,
//     the partitioned copy's positions (from the cursors), a join CTA's
//     tile and query range, each query's slot within its staged tile.
//   double_kernel (P3), stream_sum_kernel (P4), l2_evict_kernel: P4's
//     bulk copies against the vector count and its partial-sum slot; P3's
//     and the evict's indices are affine and bounded by their tests.

#pragma once

#ifdef MTB_CHECKED
#include <cstdio>
#define MTB_CHECK(cond, idx, limit)                                         \
  do {                                                                      \
    if (!(cond)) {                                                          \
      printf("MTB_CHECK failed: %s:%d in %s: index %lld, limit %lld (%s)\n", \
             __FILE__, __LINE__, __func__, (long long)(idx),                \
             (long long)(limit), #cond);                                    \
      __trap();                                                             \
    }                                                                       \
  } while (0)
#else
#define MTB_CHECK(cond, idx, limit) \
  do {                              \
  } while (0)
#endif

// idx in [0, limit)
#define MTB_CHECK_INDEX(idx, limit) \
  MTB_CHECK((idx) >= 0 && (idx) < (limit), idx, limit)
