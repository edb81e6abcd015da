// K2: fused group search + candidate scan; a warp owns 32 query slots.
//
// Replaces the XLA blocks of metabuli_tpu/classify/pipeline.py::
// _classify_core: search_groups (:607-656), tier (:673-696) with
// hamming_dna48_split (:109-140), the direct-probe flow (:712-970) and the
// classic flow (:971-1108). There every query gathers a fixed-width
// candidate window (two tiers, a deep tier, fixed budgets, a retry ladder
// on overflow); here every window is scanned whole, however deep, and the
// output is sized exactly by a count launch and a scan over warps.
//
// Design. Each lane searches its own slot's group (a lower bound in the
// bucket's grest run). The warp then treats its 32 windows as one flat list
// of (slot, row) pairs, in slot order, and strides over it 32 pairs at a
// time: a lane finds the slot that owns its pair by a 5-step search over the
// warp's inclusive window prefix (shuffles), so neighbouring lanes load
// neighbouring d48 rows (coalesced 8-byte loads) and a warp costs
// ceil(sum of its windows / 32) steps, not 32 x its deepest window. Per slot
// minima go through a shared-memory atomicMin, kept counts through
// __ballot_sync + __popc. The count launch also stashes each warp's kept
// pairs (row, and lane | payload), in flat order, in a shared pool: the
// warp reserves as many entries as its windows have rows with one atomicAdd
// and writes the kept ones compactly. The write launch copies a stashed
// warp's pairs to its output base (coalesced, no table access); a warp
// that found the pool full walks its windows again, with the same walk
// (walk_kept) as the count launch, and is counted. Either way each kept
// pair lands at the warp's output base + the kept pairs before it, so the
// output is in (slot, row) order: the stable compaction the reference
// package gets from its partition sort (pipeline.py:1110-1117).
//
// Bound on the card: bytes. Least bytes for one call, each needed byte once
// (chip_smoke.py computes them from the batch's counts): 17 B per query slot
// (value, valid, dna48), 12 B per valid slot (two prefix entries and the
// grest entry found), 8 B per hit slot (gstart, gend), 8 B per window row
// (d48) and 12 B per kept row out (row, slot, payload). What holds the count
// launch far above that bound is the number of scattered accesses, not
// their bytes: a valid slot touches about five 32-byte sectors spread over
// the whole index (prefix, grest, gstart, gend, d48), so fewer sectors per
// slot (one record per group) is the next step for this kernel.
//
// K11, the reduced alphabet (--reduced-aa 1), is the same design with
// Reduced = true (mtb_search_count_reduced, mtb_search_write_reduced):
// the amino-acid key is value >> 32 (permuted mod 2^32), the query word is
// value's low 32 bits (8 codon numbers of 4 bits), the candidate word the
// row's 32-bit codon-number word (the high half of its taxdna), and the
// distance is metabuli_tpu/ops/hamming.py:119 hamming_all_reduced: per
// codon a look-up of the 16x16 distance table, staged in shared memory
// (lanes index it divergently, which a __constant__ table would
// serialise), summed, and ORed into the 16-bit words with the reference's
// spill quirk kept (a distance of 4 spills into the next codon's lane).
//
// What bounds K11 on this card: not its bytes but the chain of dependent
// scattered loads a query slot waits on. Over the standard layout a slot
// read prefix[bucket] and prefix[bucket + 1], then the lower bound's grest
// entries, then on a hit gstart and gend (two more arrays, two more
// sectors), then its window's rows at an 8-byte stride (taxdna, half of
// every sector the taxid): about 2 DRAM round trips for a miss in a
// non-empty bucket and 4 for a hit before its first row, times 2 M slots
// a batch. The reduced index therefore has a layout of its own
// (classify/pipeline.py::bucket_records):
//   * one 16-byte record per bucket (int4, one load): the bucket's group
//     count above its first group's rest bits, that group's gstart and
//     gend, and the bucket's first group. It decides a miss in an empty
//     or one-group bucket, and a hit on the first group, which is most
//     hits at ~2 buckets a group; a larger key in a bucket of several
//     groups goes on with the lower bound over grest (from the record's
//     first group + 1, to first + count, or the next record's first where
//     the count is at its cap), then gstart and gend as before;
//   * a dense int32 column of the rows' codon words (tword), so a window
//     of n rows reads 4n contiguous bytes.
// A hit then waits on two round trips before its rows, a miss on one.
// The two launches, the stash, the one read-back and the (slot, row)
// output order are K2's.
//
// Old-format DBs (kmer_format 1) pack a metamer's codons little-endian
// (extract.cu), so a dna48 word holds slot j at bits 6j, not 6(7-j): the
// per-codon counts of the h16 word take the other frame orientation,
// (frame < 3) != old_format, as in metabuli_tpu/classify/pipeline.py:660-663
// and chain.cu's reading of them. K11 takes the same flag.
//
// Launches: mtb_search_count writes per slot (window start, length, Hamming
// cutoff), per warp (kept pairs into acc[w], the over-cap slots added to
// acc[n_warps], the warps that found the pool full to acc[n_warps + 1],
// the stash entry or -1) and the stash; the caller scans acc (torch.cumsum)
// and reads back its last three entries, the one host read-back (output
// total, then n_over_cap and the walked-again warps after it);
// mtb_search_write writes the kept pairs at the scanned offsets.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr uint64_t kPermMult = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMask40 = (1ull << 40) - 1;

// per-codon mismatch counts of two dna48 words; returns the sum and
// sets h16 (codon i at bits 2i for forward frames, 2(7-i) for reverse)
__device__ __forceinline__ int hamming48(uint64_t q, uint64_t t, bool fwd,
                                         int* h16) {
  uint64_t x = q ^ t;
  uint64_t m = (x | (x >> 1)) & 0x555555555555ull;
  int packed = 0;
  for (int i = 0; i < 8; ++i) {
    int lane = (int)((m >> (6 * i)) & 0x15);
    int vi = (lane & 1) + ((lane >> 2) & 1) + ((lane >> 4) & 1);
    packed |= vi << (2 * (fwd ? i : 7 - i));
  }
  *h16 = packed;
  return __popcll(m);
}

// K11: the reduced-alphabet distance of two words of 8 4-bit codon numbers
// through the 16x16 table ``lut``; h16 as hamming48's, cut to 16 bits
__device__ __forceinline__ int hamming_reduced(uint32_t q, uint32_t t,
                                               bool fwd,
                                               const uint8_t* lut,
                                               int* h16) {
  int sum = 0, packed = 0;
  for (int i = 0; i < 8; ++i) {
    int d = lut[(q >> (4 * i) & 15) << 4 | (t >> (4 * i) & 15)];
    sum += d;
    packed |= d << (2 * (fwd ? i : 7 - i));
  }
  *h16 = packed & 0xFFFF;
  return sum;
}

// the table word a row is scored on: its dna48 (standard) or its codon
// numbers, tword (reduced)
template <bool Reduced>
using Word = std::conditional_t<Reduced, uint32_t, int64_t>;

// the scan's table word of a row and its distance to the query word
template <bool Reduced>
__device__ __forceinline__ int distance(uint64_t q,
                                        const Word<Reduced>* __restrict__ table,
                                        int32_t row, bool fwd,
                                        const uint8_t* lut, int* h16) {
  if constexpr (Reduced)
    return hamming_reduced((uint32_t)q, table[row], fwd, lut, h16);
  else
    return hamming48(q, (uint64_t)table[row], fwd, h16);
}

__device__ __forceinline__ long long warp_inclusive_sum(long long x,
                                                        int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The warp's 32 windows as one flat (slot, row) list. Pair f belongs to the
// first lane whose inclusive window prefix exceeds f.
struct FlatWindows {
  long long incl;   // this lane's inclusive prefix of window lengths
  long long total;  // pairs in the warp

  __device__ __forceinline__ int owner(long long f) const {
    int j = 0;
    for (int step = 16; step; step >>= 1) {
      long long v = __shfl_sync(kFull, incl, j + step - 1);
      if (v <= f) j += step;
    }
    return j;
  }
};

struct Pair {
  bool live;      // f < total
  int j;          // owning lane
  int32_t row;    // table row
  int frame;
  int h, h16;     // Hamming sum and per-codon counts
};

// pair f0 + lane of the flat list: its owner, table row and Hamming
template <bool Reduced>
__device__ __forceinline__ Pair pair_at(const FlatWindows& fw, long long f0,
                                        int lane, int len, int32_t gs,
                                        uint64_t q, int frame,
                                        const Word<Reduced>* __restrict__ d48,
                                        const uint8_t* lut, bool old_format) {
  Pair p;
  long long f = f0 + lane;
  p.live = f < fw.total;
  p.j = fw.owner(f);
  long long first = __shfl_sync(kFull, fw.incl - len, p.j);
  int32_t gj = __shfl_sync(kFull, gs, p.j);
  unsigned long long qj = __shfl_sync(kFull, (unsigned long long)q, p.j);
  p.frame = __shfl_sync(kFull, frame, p.j);
  p.row = gj + (int32_t)(f - first);
  p.h = 0;
  p.h16 = 0;
  if (p.live)
    p.h = distance<Reduced>(qj, d48, p.row, (p.frame < 3) != old_format,
                            lut, &p.h16);
  return p;
}

// The warp's kept pairs (Hamming within their slot's cutoff c), in flat
// order: calls put(p, at) for each, at = its rank among the warp's kept
// pairs; returns how many were kept. The count launch stashes them with it,
// the write launch's second walk writes them out.
template <bool Reduced, class Put>
__device__ __forceinline__ long long walk_kept(
    const FlatWindows& fw, int lane, int len, int32_t gs, uint64_t q,
    int frame, int c, const Word<Reduced>* __restrict__ d48,
    const uint8_t* lut, bool old_format, Put put) {
  long long kept = 0;
  unsigned lt = (1u << lane) - 1;
  for (long long f0 = 0; f0 < fw.total; f0 += 32) {
    Pair p = pair_at<Reduced>(fw, f0, lane, len, gs, q, frame, d48, lut,
                              old_format);
    int cj = __shfl_sync(kFull, c, p.j);
    bool keep = p.live && p.h <= cj;
    unsigned b = __ballot_sync(kFull, keep);
    if (keep) put(p, kept + __popc(b & lt));
    kept += __popc(b);
  }
  return kept;
}

// the shared copy of K11's 16x16 table (reduced only), filled by the CTA
template <bool Reduced>
__device__ __forceinline__ void stage_lut(uint8_t* s_lut,
                                          const int32_t* __restrict__ lut) {
  if (!Reduced) return;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_lut[i] = (uint8_t)lut[i];
  __syncthreads();
}

// K11's search of one valid slot's key: its bucket's record, then, for a
// larger key in a bucket of several groups, the lower bound over the other
// groups' grest. Returns whether the key has a group; sets its rows.
__device__ __forceinline__ bool find_reduced(
    uint64_t value, const int4* __restrict__ rec,
    const int32_t* __restrict__ grest, const int32_t* __restrict__ gstart,
    const int32_t* __restrict__ gend, int prefix_bits, int32_t* gs,
    int32_t* n_rows) {
  const int rb = 32 - prefix_bits;  // 1 <= prefix_bits <= 31
  const uint32_t pi = (uint32_t)((value >> 32) * kPermMult);
  const uint32_t rest_mask = (uint32_t)((1ull << rb) - 1);
  const int32_t rest = (int32_t)(pi & rest_mask);
  const uint32_t bucket = (uint32_t)((uint64_t)pi >> rb);
  const int4 r = rec[bucket];
  const uint32_t n = (uint32_t)((uint64_t)(uint32_t)r.x >> rb);
  const int32_t rest0 = (int32_t)((uint32_t)r.x & rest_mask);
  if (n == 0 || rest < rest0) return false;
  if (rest == rest0) {
    *gs = r.y;
    *n_rows = r.z - r.y;
    return true;
  }
  int32_t lo = r.w + 1;
  const int32_t end = n == (uint32_t)((1ull << prefix_bits) - 1)
                          ? rec[bucket + 1].w
                          : r.w + (int32_t)n;
  int32_t hi = end;
  while (lo < hi) {
    int32_t mid = (lo + hi) >> 1;
    if (grest[mid] < rest) lo = mid + 1; else hi = mid;
  }
  if (lo < end && grest[lo] == rest) {
    *gs = gstart[lo];
    *n_rows = gend[lo] - *gs;
    return true;
  }
  return false;
}

// count launch; for Reduced, qd48 is value itself (the query word is its
// low half), d48 is tword and rec replaces prefix
template <bool Reduced>
__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ value, const bool* __restrict__ valid,
             const int64_t* __restrict__ qd48, int64_t Q, int W,
             const int32_t* __restrict__ grest,
             const int32_t* __restrict__ gstart,
             const int32_t* __restrict__ gend,
             const int32_t* __restrict__ prefix,
             const int4* __restrict__ rec,
             const Word<Reduced>* __restrict__ d48, int prefix_bits, int cap,
             int32_t* __restrict__ start, int32_t* __restrict__ wlen,
             int32_t* __restrict__ cut, int64_t* __restrict__ acc,
             int2* __restrict__ stash, int64_t stash_cap,
             unsigned long long* __restrict__ stash_top,
             int64_t* __restrict__ wstash,
             const int32_t* __restrict__ lut, bool old_format) {
  __shared__ int s_min[kThreads];
  __shared__ uint8_t s_lut[Reduced ? 256 : 1];
  stage_lut<Reduced>(s_lut, lut);
  int lane = threadIdx.x & 31;
  int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t s0 = s - lane;
  if (s0 >= Q) return;  // the whole warp lies past the last slot

  // 1. one lane per slot: lower bound of the key among its bucket's groups
  int32_t gs = 0;
  int len = 0;
  bool over = false;
  uint64_t q = 0;
  int frame = 0;
  if (s < Q) {
    q = Reduced ? (uint64_t)qd48[s] & 0xFFFFFFFFull : (uint64_t)qd48[s];
    frame = (int)((s / W) % 6);
    if (valid[s]) {
      if constexpr (Reduced) {
        int32_t n;
        if (find_reduced((uint64_t)value[s], rec, grest, gstart, gend,
                         prefix_bits, &gs, &n)) {
          over = n > cap;
          len = over ? cap : n;
        }
      } else {
        // the amino-acid key: 40 bits at 24
        int rb = 40 - prefix_bits;
        uint64_t pi = (((uint64_t)value[s] >> 24) * kPermMult) & kMask40;
        int32_t rest = (int32_t)(pi & ((1ull << rb) - 1));
        int64_t bucket = (int64_t)(pi >> rb);
        int32_t lo = prefix[bucket], hi = prefix[bucket + 1];
        int32_t end = hi;
        while (lo < hi) {
          int32_t mid = (lo + hi) >> 1;
          if (grest[mid] < rest) lo = mid + 1; else hi = mid;
        }
        if (lo < end && grest[lo] == rest) {
          gs = gstart[lo];
          int32_t n = gend[lo] - gs;
          over = n > cap;
          len = over ? cap : n;
        }
      }
    }
  }

  // 2. the warp's windows as one flat list: per slot minimum Hamming
  FlatWindows fw;
  fw.incl = warp_inclusive_sum(len, lane);
  fw.total = __shfl_sync(kFull, fw.incl, 31);
  int* wmin = s_min + (threadIdx.x - lane);
  wmin[lane] = 255;
  __syncwarp();
  for (long long f0 = 0; f0 < fw.total; f0 += 32) {
    Pair p = pair_at<Reduced>(fw, f0, lane, len, gs, q, frame, d48, s_lut,
                              old_format);
    if (p.live) atomicMin(&wmin[p.j], p.h);
  }
  __syncwarp();
  int best = wmin[lane];
  int c = 2 * best < 7 ? 2 * best : 7;

  // 3. kept pairs: Hamming within the slot's cutoff, stashed as (row,
  // lane << 22 | payload) if the pool has room for all the warp's rows
  long long base = -1;
  if (lane == 0 && fw.total > 0) {
    unsigned long long at =
        atomicAdd(stash_top, (unsigned long long)fw.total);
    if (at + fw.total <= (unsigned long long)stash_cap) base = (long long)at;
  }
  base = __shfl_sync(kFull, base, 0);
  long long kept = walk_kept<Reduced>(
      fw, lane, len, gs, q, frame, c, d48, s_lut, old_format,
      [&](const Pair& p, long long at) {
        if (base >= 0)
          stash[base + at] = make_int2(
              p.row, (p.j << 22) | (p.h16 << 6) | (p.h << 3) | p.frame);
      });
  if (s < Q && base < 0) {  // what the write launch's second walk reads
    start[s] = gs;
    wlen[s] = len;
    cut[s] = c;
  }
  int n_over = __popc(__ballot_sync(kFull, over));
  if (lane == 0) {
    int64_t w = s0 >> 5, n_warps = (Q + 31) >> 5;
    acc[w] = kept;
    wstash[w] = base;
    if (n_over) atomicAdd((unsigned long long*)(acc + n_warps),
                          (unsigned long long)n_over);
    if (base < 0 && fw.total > 0)  // the write launch walks it again
      atomicAdd((unsigned long long*)(acc + n_warps + 1), 1ull);
  }
}

template <bool Reduced>
__global__ void __launch_bounds__(kThreads)
write_kernel(const int64_t* __restrict__ qd48, int64_t Q, int W,
             const Word<Reduced>* __restrict__ d48,
             const int32_t* __restrict__ start,
             const int32_t* __restrict__ wlen,
             const int32_t* __restrict__ cut,
             const int64_t* __restrict__ scan,
             const int2* __restrict__ stash,
             const int64_t* __restrict__ wstash,
             int32_t* __restrict__ out_row, int32_t* __restrict__ out_slot,
             int32_t* __restrict__ out_pay,
             const int32_t* __restrict__ lut, bool old_format) {
  __shared__ uint8_t s_lut[Reduced ? 256 : 1];
  stage_lut<Reduced>(s_lut, lut);
  int lane = threadIdx.x & 31;
  int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t s0 = s - lane;
  if (s0 >= Q) return;
  int64_t w = s0 >> 5;
  long long o = w ? scan[w - 1] : 0;  // kept pairs of earlier warps
  long long n_keep = scan[w] - o;
  if (wstash[w] >= 0) {  // the count launch stashed them
    const int2* mine = stash + wstash[w];
    for (long long i = lane; i < n_keep; i += 32) {
      int2 v = mine[i];
      out_row[o + i] = v.x;
      out_slot[o + i] = (int32_t)(s0 + (v.y >> 22));
      out_pay[o + i] = v.y & 0x3FFFFF;
    }
    return;
  }
  int32_t gs = 0;
  int len = 0, c = 0, frame = 0;
  uint64_t q = 0;
  if (s < Q) {
    gs = start[s];
    len = wlen[s];
    c = cut[s];
    q = Reduced ? (uint64_t)qd48[s] & 0xFFFFFFFFull : (uint64_t)qd48[s];
    frame = (int)((s / W) % 6);
  }
  FlatWindows fw;
  fw.incl = warp_inclusive_sum(len, lane);
  fw.total = __shfl_sync(kFull, fw.incl, 31);
  walk_kept<Reduced>(fw, lane, len, gs, q, frame, c, d48, s_lut, old_format,
            [&](const Pair& p, long long at) {
              out_row[o + at] = p.row;
              out_slot[o + at] = (int32_t)(s0 + p.j);
              out_pay[o + at] = (p.h16 << 6) | (p.h << 3) | p.frame;
            });
}

template <bool Reduced>
int count(const int64_t* value, const bool* valid, const int64_t* qd48,
          int64_t Q, int W, const int32_t* grest, const int32_t* gstart,
          const int32_t* gend, const int32_t* prefix, const int4* rec,
          const Word<Reduced>* d48, int prefix_bits, int cap, int32_t* start,
          int32_t* wlen, int32_t* cut, int64_t* acc, int2* stash,
          int64_t stash_cap, unsigned long long* stash_top, int64_t* wstash,
          const int32_t* lut, int kmer_format, cudaStream_t stream) {
  if (kmer_format != 1 && kmer_format != 2) return (int)cudaErrorInvalidValue;
  if (Reduced && (prefix_bits < 1 || prefix_bits > 31))
    return (int)cudaErrorInvalidValue;
  int64_t blocks = (Q + kThreads - 1) / kThreads;
  count_kernel<Reduced><<<(unsigned)blocks, kThreads, 0, stream>>>(
      value, valid, qd48, Q, W, grest, gstart, gend, prefix, rec, d48,
      prefix_bits, cap, start, wlen, cut, acc, stash, stash_cap, stash_top,
      wstash, lut, kmer_format == 1);
  return (int)cudaGetLastError();
}

template <bool Reduced>
int write(const int64_t* qd48, int64_t Q, int W, const Word<Reduced>* d48,
          const int32_t* start, const int32_t* wlen, const int32_t* cut,
          const int64_t* scan, const int2* stash, const int64_t* wstash,
          int32_t* out_row, int32_t* out_slot, int32_t* out_pay,
          const int32_t* lut, int kmer_format, cudaStream_t stream) {
  if (kmer_format != 1 && kmer_format != 2) return (int)cudaErrorInvalidValue;
  int64_t blocks = (Q + kThreads - 1) / kThreads;
  write_kernel<Reduced><<<(unsigned)blocks, kThreads, 0, stream>>>(
      qd48, Q, W, d48, start, wlen, cut, scan, stash, wstash, out_row,
      out_slot, out_pay, lut, kmer_format == 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mtb_search_count(const int64_t* value, const bool* valid,
                                const int64_t* qd48, int64_t Q, int W,
                                const int32_t* grest, const int32_t* gstart,
                                const int32_t* gend, const int32_t* prefix,
                                const int64_t* d48, int prefix_bits, int cap,
                                int32_t* start, int32_t* wlen, int32_t* cut,
                                int64_t* acc, int2* stash, int64_t stash_cap,
                                unsigned long long* stash_top, int64_t* wstash,
                                int kmer_format, cudaStream_t stream) {
  return count<false>(value, valid, qd48, Q, W, grest, gstart, gend, prefix,
                      nullptr, d48, prefix_bits, cap, start, wlen, cut, acc,
                      stash, stash_cap, stash_top, wstash, nullptr,
                      kmer_format, stream);
}

extern "C" int mtb_search_write(const int64_t* qd48, int64_t Q, int W,
                                const int64_t* d48, const int32_t* start,
                                const int32_t* wlen, const int32_t* cut,
                                const int64_t* scan, const int2* stash,
                                const int64_t* wstash, int32_t* out_row,
                                int32_t* out_slot, int32_t* out_pay,
                                int kmer_format, cudaStream_t stream) {
  return write<false>(qd48, Q, W, d48, start, wlen, cut, scan, stash, wstash,
                      out_row, out_slot, out_pay, nullptr, kmer_format,
                      stream);
}

// K11: value stands in for qd48, the bucket records (int32 [2^prefix_bits
// + 1, 4], 16-byte aligned) for prefix, tword for d48; lut is the 16x16
// int32 distance table
extern "C" int mtb_search_count_reduced(
    const int64_t* value, const bool* valid, const int64_t* qword, int64_t Q,
    int W, const int32_t* grest, const int32_t* gstart, const int32_t* gend,
    const int4* rec, const uint32_t* tword, int prefix_bits, int cap,
    int32_t* start, int32_t* wlen, int32_t* cut, int64_t* acc, int2* stash,
    int64_t stash_cap, unsigned long long* stash_top, int64_t* wstash,
    const int32_t* lut, int kmer_format, cudaStream_t stream) {
  return count<true>(value, valid, qword, Q, W, grest, gstart, gend, nullptr,
                     rec, tword, prefix_bits, cap, start, wlen, cut, acc,
                     stash, stash_cap, stash_top, wstash, lut, kmer_format,
                     stream);
}

extern "C" int mtb_search_write_reduced(
    const int64_t* qword, int64_t Q, int W, const uint32_t* tword,
    const int32_t* start, const int32_t* wlen, const int32_t* cut,
    const int64_t* scan, const int2* stash, const int64_t* wstash,
    int32_t* out_row, int32_t* out_slot, int32_t* out_pay, const int32_t* lut,
    int kmer_format, cudaStream_t stream) {
  return write<true>(qword, Q, W, tword, start, wlen, cut, scan, stash,
                     wstash, out_row, out_slot, out_pay, lut, kmer_format,
                     stream);
}
