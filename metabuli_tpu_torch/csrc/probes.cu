// P1-P4: the device-cost probes of tools_profiling/, on the card.
//
// Not on the classify path. Each measures one memory pattern the search
// could be built on, so that the GPU's costs can be set beside the
// reference package's TPU record:
//
//   P1 gather_tile_sum  (pallas_probe_prototype.py:87 pallas_dma): one
//      random 4-byte load per query from a table; the low 16 bits of the
//      loaded values summed per tile of queries. There the kernel issued one
//      async DMA per query; here each thread loads its queries directly, so
//      the probe measures the card's random-load rate. Bound: the bytes the
//      queries need (their slots, each distinct table word once), though
//      each random word costs a whole sector. Design: a thread first loads
//      its 16 slots as 16-byte vectors, then issues its 16 gathers back
//      to back, so that 16 loads a thread are in flight; tile sums by warp
//      shuffles, with one step through shared memory for a tile's two
//      warps. The gathers go through L2 only (ld.global.cg): a random
//      word has nothing to reuse in L1. On the H100 every shape swept
//      (4-32 queries a thread, 256-1024 threads a CTA) and the parent's
//      loop ran at one rate of random loads, L2-warm or cold alike;
//      ld.global.nc.L1::no_allocate ran 1.6x slower than .cg or plain .nc
//      (PERF.md, Findings), so one shape is built.
//   P2 merge_join_sum   (pallas_probe_prototype.py:148 pallas_lut): the
//      same sums per table tile, by a merge join: the queries grouped by
//      tile, each table tile copied into shared memory and its queries
//      looked up there. There the queries were sorted inside the jit and
//      the in-tile lookup was two one-hot MXU contractions in float32 over
//      a fixed window of queries per tile (the prototype's own note:
//      timing was the point); here each tile's true queries are summed
//      exactly in int64, so the total equals P1's. The join needs the
//      queries grouped by tile, not sorted, so one radix pass by
//      slot >> 11 takes the place of a sort: a histogram (per-CTA counts
//      in shared memory), one CTA's exclusive scan, a scatter that stages
//      each CTA's 16,384 queries grouped by tile in shared memory and
//      writes them out in runs. Then a CTA per tile, and one per further
//      JOIN_MAXQ queries of a tile, copies the 8 KiB tile by one TMA bulk
//      copy while its threads load their queries, so skew cannot
//      serialise on one CTA (the CTAs of a tile meet by atomic adds).
//      Bound: as P1's; the join also streams every table tile that holds
//      a query, the table itself at a DB's scale.
//   P3 smoke_double     (profile_tier_slices.py:107 psmoke): x * 2, the
//      smallest kernel that proves a build and a launch. 8 KiB at the
//      reference's [8, 128] is far below what the card moves in the time
//      of a launch, so the launch path bounds it: one CTA of 256 threads,
//      a 16-byte vector a thread (one load and one store each), no loop.
//      The n % 4 tail words and a pointer that is not 16-byte aligned (a
//      view such as x.view(-1)[1:]) take the kernel's scalar path, with
//      neighbouring threads on neighbouring words.
//   P4 stream_sum       (profile_tier_slices.py:129 stream_sum): every
//      32-bit word of a table summed mod 2^32. There each grid step
//      overwrote the one output with its own tile's sum (a bandwidth
//      probe); here every word counts. Bound: HBM read bandwidth, 2 GiB
//      at 3.35 TB/s = 0.6410 ms for the 2^28-row table. Design: TMA bulk
//      copies. One CTA per SM, all resident in one wave; in each, one
//      thread issues 1-D cp.async.bulk copies of 32 KiB chunks into a
//      4-stage ring in shared memory, completed on mbarriers, while 8
//      warps sum the stage that has arrived and release it on a second
//      mbarrier. Up to 128 KiB a SM is in flight with no registers spent
//      on it, and each CTA reads whole 32 KiB runs of the table. A warp
//      sum by shuffles and a CTA sum in shared memory follow; the CTAs'
//      sums meet through per-CTA partials and a last-CTA-done ticket
//      kept on the card (sum_ticket, sum_partial): the ticket starts at
//      0 when the module loads and atomicInc wraps it back to 0 as the
//      last CTA takes it, so no call zeroes anything (no memset, no
//      scratch allocation in the ms that a call costs). The ticket is
//      shared by every call on a device, so two calls must not overlap:
//      P4 is a probe that tools/probes.py, chip_smoke.py and the tests
//      call one at a time on the caller's current stream, and calls on
//      one stream run in order; no caller runs two streams at once.
//      The copies go through TMA rather than through registers because a
//      one-wave grid-stride kernel with 16-byte loads (8 a thread, L1
//      no-allocate) measured about 1 % slower on the H100.

// Integer sums only: addition mod 2^32 (or exact in int64) is associative,
// so block order and atomics do not change a result.

#include <cstdint>
#include <cuda_runtime.h>

#include "check.cuh"

namespace {

// sum over the block; the result is valid in thread 0
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_sums[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

constexpr int DOUBLE_THREADS = 256;

__device__ __forceinline__ int32_t twice(int32_t v) {
  return (int32_t)((uint32_t)v << 1);  // wraps like torch
}

// a thread per 16-byte vector of x: threads [0, n / 4) on the vector path
// when x and out are both 16-byte aligned; otherwise, and for the n % 4
// tail, word i of thread t's scalar share is t + i * (threads in the grid)
__global__ void __launch_bounds__(DOUBLE_THREADS)
double_kernel(const int32_t* __restrict__ x, int64_t n,
              int32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * DOUBLE_THREADS + threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    const int64_t n_vec = n >> 2;
    if (t < n_vec) {
      int4 v = reinterpret_cast<const int4*>(x)[t];
      v.x = twice(v.x);
      v.y = twice(v.y);
      v.z = twice(v.z);
      v.w = twice(v.w);
      reinterpret_cast<int4*>(out)[t] = v;
    }
    if (t < n - 4 * n_vec) out[4 * n_vec + t] = twice(x[4 * n_vec + t]);
    return;
  }
  const int64_t stride = (int64_t)gridDim.x * DOUBLE_THREADS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t j = t + i * stride;
    if (j < n) out[j] = twice(x[j]);
  }
}

// P4: one CTA per SM (the ring takes 128 KiB of shared memory); warp 0's
// lane 0 copies, warps 1-8 sum
constexpr int SUM_STAGES = 4;
constexpr int SUM_CHUNK_VEC = 2048;  // 16-byte vectors a stage: 32 KiB
constexpr int SUM_CONSUMERS = 256;
constexpr int SUM_THREADS = SUM_CONSUMERS + 32;
constexpr int SUM_SMEM = SUM_STAGES * SUM_CHUNK_VEC * 16;

__device__ __forceinline__ uint32_t words_sum(int4 v) {
  return (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

constexpr int SUM_MAX_CTAS = 1024;
__device__ unsigned sum_ticket;  // 0 between calls
__device__ uint32_t sum_partial[SUM_MAX_CTAS];

// Every CTA writes its sum to sum_partial[blockIdx.x]; the CTA that takes
// the last ticket (and wraps it to 0) sums the partials into *out.
__device__ void finish_sum(uint32_t acc, int32_t* out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    MTB_CHECK_INDEX((int)blockIdx.x, SUM_MAX_CTAS);
    sum_partial[blockIdx.x] = acc;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicInc(&sum_ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  uint32_t s = 0;
  for (unsigned j = threadIdx.x; j < gridDim.x; j += blockDim.x)
    s += __ldcg(sum_partial + j);  // from L2: other SMs wrote them
  s = block_sum(s);
  if (threadIdx.x == 0) *out = (int32_t)s;
}

// Chunk c holds vectors [c * SUM_CHUNK_VEC, min((c + 1) * SUM_CHUNK_VEC,
// n_vec)); CTA b takes chunks b, b + grid, ..., its k-th into stage
// k % SUM_STAGES. full[s] completes when a stage's bytes have landed,
// empty[s] when the 8 consumer warps have summed it; then the n % 4 tail
// words in CTA 0.
__global__ void __launch_bounds__(SUM_THREADS)
stream_sum_kernel(const int4* __restrict__ vec, int64_t n_vec,
                  const int32_t* __restrict__ words, int64_t n,
                  int32_t* __restrict__ out) {
  extern __shared__ __align__(128) int4 ring[];
  __shared__ __align__(8) uint64_t full[SUM_STAGES], empty[SUM_STAGES];
  const int64_t n_chunks = (n_vec + SUM_CHUNK_VEC - 1) / SUM_CHUNK_VEC;
  const int64_t mine = n_chunks > blockIdx.x
      ? (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SUM_STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_addr(&empty[s])), "r"(SUM_CONSUMERS / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t acc = 0;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      for (int64_t k = 0; k < mine; ++k) {
        const int s = (int)(k % SUM_STAGES);
        if (k >= SUM_STAGES)  // the consumers released this stage's last use
          mbar_wait(smem_addr(&empty[s]), (uint32_t)((k / SUM_STAGES - 1) & 1));
        const int64_t v0 = (blockIdx.x + k * gridDim.x) * SUM_CHUNK_VEC;
        const uint32_t bytes =
            (uint32_t)(min((int64_t)SUM_CHUNK_VEC, n_vec - v0) * 16);
        MTB_CHECK(v0 + bytes / 16 <= n_vec, v0 + bytes / 16, n_vec);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_addr(&full[s])), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            :: "r"(smem_addr(ring + s * SUM_CHUNK_VEC)), "l"(vec + v0),
               "r"(bytes), "r"(smem_addr(&full[s])) : "memory");
      }
    }
    __syncwarp();  // lane 0 rejoins its warp before the block sum
  } else {
    const int ct = threadIdx.x - 32;
    for (int64_t k = 0; k < mine; ++k) {
      const int s = (int)(k % SUM_STAGES);
      mbar_wait(smem_addr(&full[s]), (uint32_t)((k / SUM_STAGES) & 1));
      const int64_t v0 = (blockIdx.x + k * gridDim.x) * SUM_CHUNK_VEC;
      const int cnt = (int)min((int64_t)SUM_CHUNK_VEC, n_vec - v0);
      const int4* st = ring + s * SUM_CHUNK_VEC;
#pragma unroll 8
      for (int j = ct; j < cnt; j += SUM_CONSUMERS) acc += words_sum(st[j]);
      __syncwarp();
      if ((ct & 31) == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(smem_addr(&empty[s])) : "memory");
    }
    if (blockIdx.x == 0 && ct < n - 4 * n_vec)
      acc += (uint32_t)words[4 * n_vec + ct];
  }
  finish_sum(block_sum(acc), out);
}

// ---------------------------------------------------------------- P1
constexpr int TILE_Q = 1024;  // queries a tile (tools/probes.py TILE_Q)

constexpr int GATHER_QPT = 16;  // queries a thread
constexpr int GATHER_TPT = TILE_Q / GATHER_QPT;  // threads a tile: 2 warps
constexpr int GATHER_THREADS = 256;  // a CTA: 4 tiles

// One 4-byte table load through L2 only (ld.global.cg), predicated on
// ``valid`` so that a slot outside the table is never read (0 then).
__device__ __forceinline__ uint32_t gather_word(const int32_t* p, bool valid) {
  uint32_t v;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n mov.u32 %0, 0;\n"
      " @q ld.global.cg.b32 %0, [%1];\n}\n"
      : "=r"(v) : "l"(p), "r"((uint32_t)valid));
  return v;
}

// Thread lt of a tile loads its GATHER_QPT slots first (16-byte vectors
// lt + GATHER_TPT * j when the slots start 16-byte aligned, else words
// lt + GATHER_TPT * j: both coalesced), then issues all its gathers back
// to back, then sums: a warp sum by shuffles, then one step through
// shared memory for the tile's two warps.
__global__ void __launch_bounds__(GATHER_THREADS)
gather_tile_sum_kernel(const int32_t* __restrict__ table, int64_t n_table,
                       const int32_t* __restrict__ slots, int64_t n_tiles,
                       int32_t* __restrict__ out) {
  constexpr int QPT = GATHER_QPT, TPT = GATHER_TPT;
  const int lt = threadIdx.x % TPT;
  const int64_t tile = (int64_t)blockIdx.x * (GATHER_THREADS / TPT) +
                       threadIdx.x / TPT;
  uint32_t acc = 0;
  if (tile < n_tiles) {
    const int32_t* s = slots + tile * TILE_Q;
    int32_t q[QPT];
    if ((reinterpret_cast<uintptr_t>(slots) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < QPT / 4; ++j) {
        const int4 v = reinterpret_cast<const int4*>(s)[lt + TPT * j];
        q[4 * j] = v.x;
        q[4 * j + 1] = v.y;
        q[4 * j + 2] = v.z;
        q[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < QPT; ++j) q[j] = s[lt + TPT * j];
    }
    uint32_t w[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      // a slot outside the table is the caller's fault; never read there
      const bool ok = q[j] >= 0 && q[j] < n_table;
      w[j] = gather_word(table + (ok ? q[j] : 0), ok);
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc += w[j] & 0xFFFF;
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ uint32_t warp_sums[GATHER_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (lt == 0 && tile < n_tiles) {
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < TPT / 32; ++k) sum += warp_sums[(threadIdx.x >> 5) + k];
    out[tile] = (int32_t)sum;
  }
}

// ---------------------------------------------------------------- P2
constexpr int TILE_T = 2048;       // table slots a tile (tools/probes.py)
constexpr int TILE_SHIFT = 11;     // slot >> TILE_SHIFT: its tile
constexpr int JOIN_MAXQ = 1024;    // queries a join CTA takes at most
constexpr int JOIN_THREADS = 128;  // JOIN_MAXQ / 4 / JOIN_THREADS vectors each
constexpr int PART_THREADS = 1024;
constexpr int LOCAL_TILES = 16384;  // tiles a CTA counts in shared memory
constexpr int SCAN_K = 16;          // counts a scan thread takes a round
constexpr int SCAN_ROUND = PART_THREADS * SCAN_K;
constexpr int SCATTER_CHUNK = 16384;  // queries a scatter CTA stages a round

__device__ __forceinline__ bool in_table(int32_t slot, int64_t n_table) {
  return slot >= 0 && slot < n_table;
}

// Adds 1 a lane to c[key] (shared or global memory). A warp whose active
// lanes all hold one key (a skewed input) adds their number in one atomic;
// other lanes add alone. With RETURN, each lane's position: the old value
// plus its rank among the lanes that added together.
template <bool RETURN>
__device__ __forceinline__ uint32_t add_one(uint32_t* c, int key) {
  const unsigned active = __activemask();
  const int lane = threadIdx.x & 31, first = __ffs(active) - 1;
  if (__all_sync(active, key == __shfl_sync(active, key, first))) {
    uint32_t base = 0;
    if (lane == first) base = atomicAdd(c + key, (uint32_t)__popc(active));
    if (!RETURN) return 0;
    return __shfl_sync(active, base, first) +
           __popc(active & ((1u << lane) - 1));
  }
  return atomicAdd(c + key, 1u);
}

// Calls f(slot) for each slot in [0, n) on the grid's threads, each thread
// the same slots on every call: 16-byte vectors when slots start 16-byte
// aligned, the n % 4 tail and an unaligned start word by word.
template <typename F>
__device__ __forceinline__ void for_each_slot(const int32_t* __restrict__ slots,
                                              int64_t n, F f) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(slots) & 15) == 0) {
    const int4* v4 = reinterpret_cast<const int4*>(slots);
    for (int64_t i = t; i < n / 4; i += stride) {
      const int4 v = v4[i];
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    }
    done = n / 4 * 4;
  }
  for (int64_t i = done + t; i < n; i += stride) f(slots[i]);
}

// (a) histogram: queries per table tile, into counts (zero on entry: the
// scan leaves them so). A CTA counts its slots in shared memory when the
// tiles fit there, then adds its nonzero counts to the global ones; else
// each lane adds straight to them. Also zeroes out, which the join adds
// into.
__global__ void __launch_bounds__(PART_THREADS)
partition_count_kernel(const int32_t* __restrict__ slots, int64_t n,
                       int64_t n_table, int n_tiles,
                       uint32_t* __restrict__ counts,
                       unsigned long long* __restrict__ out) {
  extern __shared__ uint32_t local[];
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_tiles;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = 0;
  if (n_tiles > LOCAL_TILES) {
    for_each_slot(slots, n, [&](int32_t s) {
      if (in_table(s, n_table)) {
        MTB_CHECK_INDEX(s >> TILE_SHIFT, n_tiles);
        add_one<false>(counts, s >> TILE_SHIFT);
      }
    });
    return;
  }
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) local[i] = 0;
  __syncthreads();
  for_each_slot(slots, n, [&](int32_t s) {
    if (in_table(s, n_table)) {
      MTB_CHECK_INDEX(s >> TILE_SHIFT, n_tiles);
      add_one<false>(local, s >> TILE_SHIFT);
    }
  });
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x)
    if (local[i]) atomicAdd(counts + i, local[i]);
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// a tile's pieces past its first: one a JOIN_MAXQ queries
__device__ __forceinline__ uint32_t further_pieces(uint32_t c) {
  return c > JOIN_MAXQ ? (c - 1) / JOIN_MAXQ : 0;
}

// (b) one CTA: the exclusive scans of the counts and of each tile's pieces
// past its first (a piece: JOIN_MAXQ queries), in rounds of SCAN_ROUND
// staged in shared memory (padded: a thread's SCAN_K counts in a row, no
// bank conflicts). Writes each tile's first position in the partitioned
// copy to cursor (the scatter advances it to the tile's end), the pieces'
// scan to extra[0, n_tiles] (extra[n_tiles]: their number), and zeroes the
// counts for the next call.
__global__ void __launch_bounds__(PART_THREADS)
partition_scan_kernel(uint32_t* __restrict__ counts, int n_tiles,
                      uint32_t* __restrict__ cursor,
                      uint32_t* __restrict__ extra) {
  extern __shared__ uint32_t staged[];
  uint32_t* pieces = staged + padded(SCAN_ROUND);
  __shared__ uint32_t warp_q[32], warp_o[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t carry_q = 0, carry_o = 0;  // the same in every thread
  for (int r0 = 0; r0 < n_tiles; r0 += SCAN_ROUND) {
    const int m = min(SCAN_ROUND, n_tiles - r0);
    for (int i = threadIdx.x; i < m; i += PART_THREADS) {
      staged[padded(i)] = counts[r0 + i];
      counts[r0 + i] = 0;
    }
    __syncthreads();
    uint32_t sq = 0, so = 0;  // this thread's queries and further pieces
    for (int k = 0; k < SCAN_K; ++k) {
      const int i = threadIdx.x * SCAN_K + k;
      const uint32_t c = i < m ? staged[padded(i)] : 0;
      sq += c;
      so += further_pieces(c);
    }
    uint32_t iq = sq, io = so;  // inclusive scans over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t a = __shfl_up_sync(0xffffffffu, iq, o);
      const uint32_t b = __shfl_up_sync(0xffffffffu, io, o);
      if (lane >= o) {
        iq += a;
        io += b;
      }
    }
    if (lane == 31) {
      warp_q[w] = iq;
      warp_o[w] = io;
    }
    __syncthreads();
    uint32_t bq = 0, bo = 0, tq = 0, to = 0;
    for (int k = 0; k < PART_THREADS / 32; ++k) {
      if (k < w) {
        bq += warp_q[k];
        bo += warp_o[k];
      }
      tq += warp_q[k];
      to += warp_o[k];
    }
    uint32_t q = carry_q + bq + iq - sq, o = carry_o + bo + io - so;
    for (int k = 0; k < SCAN_K; ++k) {
      const int i = threadIdx.x * SCAN_K + k;
      if (i >= m) break;
      const uint32_t c = staged[padded(i)];
      staged[padded(i)] = q;
      pieces[padded(i)] = o;
      q += c;
      o += further_pieces(c);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += PART_THREADS) {
      cursor[r0 + i] = staged[padded(i)];
      extra[r0 + i] = pieces[padded(i)];
    }
    carry_q += tq;
    carry_o += to;
    __syncthreads();  // staged and the warp totals are read before reuse
  }
  if (threadIdx.x == 0) extra[n_tiles] = carry_o;
}

// (c) scatter: each query to its tile's run of the partitioned copy (order
// within a run is free: the join sums integers). Where the tiles fit in
// shared memory, a CTA takes SCATTER_CHUNK queries a round: it ranks each
// in its tile by shared-memory atomics, scans its counts, takes one range
// of each tile's run by one atomic add to cursor, stages its queries in
// shared memory grouped by tile, and writes them out in that order, so
// neighbouring threads write neighbouring words of a run. Else each lane
// adds to cursor itself and writes its query alone.
__global__ void __launch_bounds__(PART_THREADS)
partition_scatter_kernel(const int32_t* __restrict__ slots, int64_t n,
                         int64_t n_table, int n_tiles,
                         uint32_t* __restrict__ cursor,
                         int32_t* __restrict__ part) {
  if (n_tiles > LOCAL_TILES) {
    for_each_slot(slots, n, [&](int32_t s) {
      if (in_table(s, n_table)) {
        MTB_CHECK_INDEX(s >> TILE_SHIFT, n_tiles);
        const uint32_t at = add_one<true>(cursor, s >> TILE_SHIFT);
        MTB_CHECK_INDEX((int64_t)at, n);
        part[at] = s;
      }
    });
    return;
  }
  extern __shared__ uint32_t local[];
  uint32_t* count = local;                      // [padded(n_tiles)]
  uint32_t* base = local + padded(n_tiles);     // [padded(n_tiles)]
  int32_t* staged = reinterpret_cast<int32_t*>(base + padded(n_tiles));
  __shared__ uint32_t warp_q[32];
  constexpr int PER = SCATTER_CHUNK / PART_THREADS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per_thread = (n_tiles + PART_THREADS - 1) / PART_THREADS;
  for (int64_t c0 = (int64_t)blockIdx.x * SCATTER_CHUNK; c0 < n;
       c0 += (int64_t)gridDim.x * SCATTER_CHUNK) {
    for (int i = threadIdx.x; i < n_tiles; i += PART_THREADS) count[padded(i)] = 0;
    __syncthreads();
    int32_t q[PER];
    uint32_t rank[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int64_t i = c0 + threadIdx.x + (int64_t)k * PART_THREADS;
      q[k] = i < n ? slots[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (in_table(q[k], n_table)) {
        MTB_CHECK_INDEX(q[k] >> TILE_SHIFT, n_tiles);
        rank[k] = add_one<true>(count, padded(q[k] >> TILE_SHIFT));
      }
    __syncthreads();
    // exclusive scan of the counts: thread t takes tiles
    // [t * per_thread, (t + 1) * per_thread)
    uint32_t sum = 0;
    for (int k = 0; k < per_thread; ++k) {
      const int b = threadIdx.x * per_thread + k;
      if (b < n_tiles) sum += count[padded(b)];
    }
    uint32_t inc = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t a = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += a;
    }
    if (lane == 31) warp_q[w] = inc;
    __syncthreads();
    uint32_t start = inc - sum, total = 0;
    for (int k = 0; k < PART_THREADS / 32; ++k) {
      if (k < w) start += warp_q[k];
      total += warp_q[k];
    }
    for (int k = 0; k < per_thread; ++k) {
      const int b = threadIdx.x * per_thread + k;
      if (b >= n_tiles) break;
      const uint32_t c = count[padded(b)];
      // this CTA's range of tile b's run, less where its queries start in
      // the staged order: a staged query i goes to base[b] + i
      base[padded(b)] = (c ? atomicAdd(cursor + b, c) : 0) - start;
      count[padded(b)] = start;
      start += c;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (in_table(q[k], n_table))
        staged[count[padded(q[k] >> TILE_SHIFT)] + rank[k]] = q[k];
    __syncthreads();
    for (int i = threadIdx.x; i < (int)total; i += PART_THREADS) {
      const int32_t s = staged[i];
      MTB_CHECK_INDEX((int64_t)(uint32_t)(base[padded(s >> TILE_SHIFT)] + i),
                      n);
      part[base[padded(s >> TILE_SHIFT)] + i] = s;
    }
    __syncthreads();  // count, base and staged are read before reuse
  }
}

// (d) the join: CTA t < n_tiles takes tile t's first JOIN_MAXQ queries,
// CTA n_tiles + k the k-th further piece, of the tile t whose pieces
// [extra[t], extra[t + 1]) hold k (a binary search; CTAs past the last
// piece, and a tile with no query, return). A tile's queries are
// part[cursor[t - 1], cursor[t]) once the scatter has run. Thread 0
// starts one 8 KiB TMA bulk copy of the tile into shared memory (a table
// not 16-byte aligned is copied word by word instead) while every thread
// loads its share of the queries, 16-byte vectors in the aligned middle
// of [lo, hi); then each looks its queries up in the tile, and each warp
// adds its sum into out[tile] (zeroed by the count kernel). Up to 16 such
// CTAs are resident on an SM at once, so one tile's copy overlaps
// another's lookups; that is why there is no persistent CTA with a ring
// of stages: at 2^28 table slots this join streamed 1 GiB at 93 % of the
// HBM rate on an H100 (PERF.md, Findings).
__global__ void __launch_bounds__(JOIN_THREADS)
merge_join_kernel(const int32_t* __restrict__ table,
                  const int32_t* __restrict__ part,
                  const uint32_t* __restrict__ cursor, int n_tiles,
                  const uint32_t* __restrict__ extra, int64_t n,
                  unsigned long long* __restrict__ out) {
  __shared__ __align__(128) int32_t tile[TILE_T];
  __shared__ __align__(8) uint64_t full;
  int2 it = make_int2((int)blockIdx.x, 0);  // {tile, piece}
  if ((int)blockIdx.x >= n_tiles) {
    const uint32_t k = blockIdx.x - n_tiles;
    if (k >= extra[n_tiles]) return;
    int lo = 0, hi = n_tiles;  // extra[lo] <= k < extra[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (extra[mid] <= k) lo = mid;
      else hi = mid;
    }
    it = make_int2(lo, (int)(k - extra[lo]) + 1);
  }
  MTB_CHECK_INDEX(it.x, n_tiles);
  const uint32_t end = cursor[it.x], start = it.x ? cursor[it.x - 1] : 0;
  const int lo = (int)(start + (uint32_t)it.y * JOIN_MAXQ);
  if (lo >= (int)end) return;
  const int hi = min((int)end, lo + JOIN_MAXQ);
  MTB_CHECK(0 <= lo && hi <= n, hi, n);  // the tile's queries in part
  const int32_t* src = table + (int64_t)it.x * TILE_T;
  const bool tma = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  if (tma && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(&full)), "r"(TILE_T * 4) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(tile)), "l"(src), "r"(TILE_T * 4),
           "r"(smem_addr(&full)) : "memory");
  }
  if (!tma)
    for (int i = threadIdx.x; i < TILE_T; i += JOIN_THREADS) tile[i] = src[i];
  // this thread's queries: a scalar head and tail (< 4 each), vectors between
  constexpr int NV = JOIN_MAXQ / 4 / JOIN_THREADS;
  const int a = min((lo + 3) & ~3, hi), e = max(hi & ~3, a);
  int4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = a / 4 + (int)threadIdx.x + j * JOIN_THREADS;
    v[j] = k < e / 4 ? reinterpret_cast<const int4*>(part)[k]
                     : make_int4(-1, -1, -1, -1);
  }
  const int t = threadIdx.x, head = a - lo;  // head: threads [0, head)
  const int ht = t < head ? lo + t : t - head < hi - e ? e + t - head : -1;
  const int32_t hs = ht >= 0 ? part[ht] : -1;
  __syncthreads();  // the barrier's init, or the word-by-word tile
  if (tma) mbar_wait(smem_addr(&full), 0);
  const int32_t base = it.x * TILE_T;
  uint32_t acc = 0;
  auto look = [&](int32_t s) {
    if (s >= 0) {
      MTB_CHECK_INDEX(s - base, TILE_T);
      acc += (uint32_t)(tile[s - base] & 0xFFFF);
    }
  };
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    look(v[j].x);
    look(v[j].y);
    look(v[j].z);
    look(v[j].w);
  }
  look(hs);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0 && acc) atomicAdd(out + it.x, (unsigned long long)acc);
}

// Reads every 16-byte vector of a zeroed buffer through the L2 (ld.cg), so
// that a buffer of twice the L2's size leaves none of the lines a timed
// call will read. Loads only: written lines would be dirty, and the timed
// call would pay their write-back.
__global__ void l2_evict_kernel(const int4* __restrict__ buf, int64_t n_vec,
                                int32_t* __restrict__ sink) {
  uint32_t acc = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (int64_t)gridDim.x * blockDim.x)
    acc += words_sum(__ldcg(buf + i));
  if (acc == 0x9e3779b9u) *sink = (int32_t)acc;  // keeps the loads
}

}  // namespace

extern "C" int mtb_probe_gather_sum(const int32_t* table, int64_t n_table,
                                    const int32_t* slots, int64_t n_tiles,
                                    int32_t* out, cudaStream_t stream) {
  constexpr int64_t per_cta = GATHER_THREADS / GATHER_TPT;
  const unsigned grid = (unsigned)((n_tiles + per_cta - 1) / per_cta);
  gather_tile_sum_kernel<<<grid, GATHER_THREADS, 0, stream>>>(
      table, n_table, slots, n_tiles, out);
  return (int)cudaGetLastError();
}

// n queries (< 2^31) over n_tiles = n_table / TILE_T tiles. Scratch from
// the caller: counts[n_tiles] zero on entry (and left zero), cursor
// [n_tiles], extra[n_tiles + 1], part[n] (16-byte aligned). Four
// launches: count, scan, scatter, join.
extern "C" int mtb_probe_merge_join_sum(const int32_t* table,
                                        int64_t n_table,
                                        const int32_t* slots, int64_t n,
                                        uint32_t* counts, uint32_t* cursor,
                                        uint32_t* extra, int32_t* part,
                                        int64_t* out, cudaStream_t stream) {
  constexpr int LOCAL_SMEM = LOCAL_TILES * 4;
  constexpr int SCATTER_SMEM = (2 * (LOCAL_TILES + LOCAL_TILES / 32) +
                                SCATTER_CHUNK) * 4;
  constexpr int SCAN_SMEM = 2 * (SCAN_ROUND + SCAN_ROUND / 32) * 4;
  static int sms = 0;
  if (sms == 0) {
    int dev, count;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(partition_count_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         LOCAL_SMEM);
    cudaFuncSetAttribute(partition_scatter_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SCATTER_SMEM);
    cudaFuncSetAttribute(partition_scan_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SCAN_SMEM);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sms = count;
  }
  const int n_tiles = (int)(n_table / TILE_T);
  const bool fits = n_tiles <= LOCAL_TILES;
  const int chunks = (int)((n + SCATTER_CHUNK - 1) / SCATTER_CHUNK);
  unsigned long long* sums = reinterpret_cast<unsigned long long*>(out);
  partition_count_kernel<<<sms, PART_THREADS, fits ? n_tiles * 4 : 0,
                           stream>>>(slots, n, n_table, n_tiles, counts, sums);
  partition_scan_kernel<<<1, PART_THREADS, SCAN_SMEM, stream>>>(
      counts, n_tiles, cursor, extra);
  const int padded_tiles = n_tiles + n_tiles / 32;
  partition_scatter_kernel<<<fits ? (chunks < 2 * sms ? chunks : 2 * sms)
                                  : sms,
                             PART_THREADS,
                             fits ? (2 * padded_tiles + SCATTER_CHUNK) * 4 : 0,
                             stream>>>(slots, n, n_table, n_tiles, cursor,
                                       part);
  // every further piece holds JOIN_MAXQ queries at least
  merge_join_kernel<<<(unsigned)(n_tiles + n / JOIN_MAXQ + 1), JOIN_THREADS,
                      0, stream>>>(table, part, cursor, n_tiles, extra, n,
                                   sums);
  return (int)cudaGetLastError();
}

extern "C" int mtb_probe_double(const int32_t* x, int64_t n, int32_t* out,
                                cudaStream_t stream) {
  const int64_t threads = (n + 3) / 4;  // a thread per 4 words
  double_kernel<<<(unsigned)((threads + DOUBLE_THREADS - 1) / DOUBLE_THREADS),
                  DOUBLE_THREADS, 0, stream>>>(x, n, out);
  return (int)cudaGetLastError();
}

// `words` 16-byte aligned; calls do not overlap (see P4 above)
extern "C" int mtb_probe_stream_sum(const int32_t* words, int64_t n,
                                    int32_t* out, cudaStream_t stream) {
  static int wave = 0;  // CTAs resident at once: one a SM
  if (wave == 0) {
    int dev, sms, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(stream_sum_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SUM_SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_sum_kernel,
                                                  SUM_THREADS, SUM_SMEM);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
    wave = per_sm * sms < SUM_MAX_CTAS ? per_sm * sms : SUM_MAX_CTAS;
  }
  const int64_t n_vec = n / 4;
  int64_t blocks = (n_vec + SUM_CHUNK_VEC - 1) / SUM_CHUNK_VEC;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  stream_sum_kernel<<<(unsigned)blocks, SUM_THREADS, SUM_SMEM, stream>>>(
      reinterpret_cast<const int4*>(words), n_vec, words, n, out);
  return (int)cudaGetLastError();
}

// buf 16-byte aligned, n_vec 16-byte vectors
extern "C" int mtb_l2_evict(const int32_t* buf, int64_t n_vec, int32_t* sink,
                            cudaStream_t stream) {
  l2_evict_kernel<<<1056, 256, 0, stream>>>(
      reinterpret_cast<const int4*>(buf), n_vec, sink);
  return (int)cudaGetLastError();
}
