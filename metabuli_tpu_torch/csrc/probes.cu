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
//      the probe measures the card's random-load rate. Bound: DRAM/L2
//      sector traffic (32 B moved per 4 B used) and load latency.
//   P2 merge_join_sum   (pallas_probe_prototype.py:148 pallas_lut): the
//      same sums from slot-sorted queries. Each block streams one table
//      tile into shared memory (coalesced) and looks its queries up there.
//      There the in-tile lookup was two one-hot MXU contractions in float32
//      over a fixed window of queries per tile (the prototype's own note:
//      timing was the point); here each tile reads its true window
//      [bounds[t], bounds[t+1]) and sums exactly in int64, so the total
//      equals P1's. Bound: the table stream plus the sorted query reads.
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

// one block per tile of tile_q queries
__global__ void gather_tile_sum_kernel(const int32_t* __restrict__ table,
                                       int64_t n_table,
                                       const int32_t* __restrict__ slots,
                                       int tile_q, int32_t* __restrict__ out) {
  const int32_t* s = slots + (int64_t)blockIdx.x * tile_q;
  uint32_t acc = 0;
  for (int i = threadIdx.x; i < tile_q; i += blockDim.x) {
    int32_t slot = s[i];
    // a slot outside the table is the caller's fault; never read there
    if (slot >= 0 && slot < n_table) acc += (uint32_t)(__ldg(table + slot) & 0xFFFF);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = (int32_t)acc;
}

// one block per table tile of tile_t slots, staged in shared memory
__global__ void merge_join_kernel(const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ sorted_slots,
                                  const int32_t* __restrict__ bounds,
                                  int tile_t, int64_t* __restrict__ out) {
  extern __shared__ int32_t tile[];
  int64_t base = (int64_t)blockIdx.x * tile_t;
  for (int i = threadIdx.x; i < tile_t; i += blockDim.x)
    tile[i] = table[base + i] & 0xFFFF;
  __syncthreads();
  int64_t acc = 0;
  for (int i = bounds[blockIdx.x] + threadIdx.x; i < bounds[blockIdx.x + 1];
       i += blockDim.x) {
    int64_t local = sorted_slots[i] - base;
    if (local >= 0 && local < tile_t) acc += tile[local];
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
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

}  // namespace

extern "C" int mtb_probe_gather_sum(const int32_t* table, int64_t n_table,
                                    const int32_t* slots, int64_t n_tiles,
                                    int tile_q, int32_t* out,
                                    cudaStream_t stream) {
  gather_tile_sum_kernel<<<(unsigned)n_tiles, 256, 0, stream>>>(
      table, n_table, slots, tile_q, out);
  return (int)cudaGetLastError();
}

extern "C" int mtb_probe_merge_join(const int32_t* table,
                                    const int32_t* sorted_slots,
                                    const int32_t* bounds, int64_t n_tiles,
                                    int tile_t, int64_t* out,
                                    cudaStream_t stream) {
  merge_join_kernel<<<(unsigned)n_tiles, 256, tile_t * sizeof(int32_t),
                      stream>>>(table, sorted_slots, bounds, tile_t, out);
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
