// K4: path combination, one thread per (read, species) group.
//
// Replaces the XLA block metabuli_tpu/classify/device_combine.py::
// combine_paths (:66-269): there, each group's paths are gathered into a
// [p_max, G] grid and two nested fori loops run the greedy acceptance for
// every group at once; groups with more than p_max paths ship to the host
// for an exact re-combine. Here every group is combined whole on the card.
//
// Rules (combineMatchPaths, Taxonomer.cpp:410-468): a path that overlaps an
// accepted one entirely, or by >= 24 bases, is rejected; a smaller overlap
// trims the path's extent and its score by the boundary match's per-codon
// terms and by ov % 3; the group score is min(1, sum of accepted scores /
// read length). Float32 operations keep the reference order, and the
// library is built with -fmad=false.
//
// Bound on the card: latency, not bytes (the smoke batch's paths are
// 3.6 MB, of which the greedy needs 1.6 MB; it has 18,130 groups of 6.25
// paths on average, at most 18). The greedy is sequential over a group's
// paths, so a thread walks its group, keeping the accepted extents in the
// group's own rows of a buffer the wrapper allocates with the output
// (int2 rows, one per path: a group never accepts more paths than it
// has), and a warp lasts as long as its largest group.
// Measured on the smoke batch (PERF.md, Findings): 8 or 32 lanes a
// group (shuffled row tiles, a ballot over the accepted extents) were
// slower, and the accepted extents in shared memory were no faster.

#include <cstdint>
#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float part_score(int h16, int rng, bool right) {
  float s = 0.0f;
  for (int i = 0; i < rng; ++i) {
    int h = right ? (h16 >> (2 * i)) & 3 : (h16 >> (14 - 2 * i)) & 3;
    s = s + (h == 0 ? 3.0f : 2.0f - 0.5f * (float)h);
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
combine_kernel(int n_groups, const int32_t* __restrict__ gstart,
               const int32_t* __restrict__ read,
               const int32_t* __restrict__ start,
               const int32_t* __restrict__ end,
               const float* __restrict__ score,
               const int32_t* __restrict__ sh16,
               const int32_t* __restrict__ eh16,
               const int32_t* __restrict__ read_lens, int n_reads,
               int n_paths, int2* __restrict__ accepted,
               float* __restrict__ out) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_groups) return;
  const int s = gstart[g], e = gstart[g + 1];
  // the group's paths, and so its rows of accepted extents
  MTB_CHECK(0 <= s && s <= e && e <= n_paths, e, n_paths);
  int2* const acc = accepted + s;  // the group's rows
  int n_acc = 0;
  float total = 0.0f;
  for (int p = s; p < e; ++p) {
    int cs = start[p], ce = end[p];
    float sc = score[p];
    bool rejected = false;
    for (int j = 0; j < n_acc; ++j) {
      const int2 a = acc[j];
      if (ce < a.x || a.y < cs) continue;
      const int ov = min(ce, a.y) - max(cs, a.x) + 1;
      if (ov == ce - cs + 1 || ov >= 24) {
        rejected = true;
        break;
      }
      const int rng = min(ov / 3, 8);
      const bool right = cs < a.x;
      const float part = right ? part_score(eh16[p], rng, true)
                               : part_score(sh16[p], rng, false);
      sc = sc - part - (float)(ov % 3);
      if (right) ce = a.x - 1; else cs = a.y + 1;
    }
    if (!rejected) {
      acc[n_acc++] = make_int2(cs, ce);
      total = total + sc;
    }
  }
  MTB_CHECK_INDEX(s, n_paths);  // the group's head path
  int r = read[s];
  r = r < 0 ? 0 : (r > n_reads - 1 ? n_reads - 1 : r);
  MTB_CHECK_INDEX(r, n_reads);
  const int rl = read_lens[r] > 1 ? read_lens[r] : 1;
  const float v = total / (float)rl;
  out[g] = v < 1.0f ? v : 1.0f;
}

}  // namespace

extern "C" int mtb_combine_paths(int n_groups, const int32_t* group_start,
                                 const int32_t* read, const int32_t* start,
                                 const int32_t* end, const float* score,
                                 const int32_t* sh16, const int32_t* eh16,
                                 const int32_t* read_lens, int n_reads,
                                 int n_paths, int2* accepted, float* out,
                                 cudaStream_t stream) {
  const int blocks = (n_groups + THREADS - 1) / THREADS;
  combine_kernel<<<blocks, THREADS, 0, stream>>>(
      n_groups, group_start, read, start, end, score, sh16, eh16, read_lens,
      n_reads, n_paths, accepted, out);
  return (int)cudaGetLastError();
}
