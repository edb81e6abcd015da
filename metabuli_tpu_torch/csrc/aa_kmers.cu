// K12: amino-acid k-mer scanners: a warp per row (DNA) or per row chunk
// (protein), a rolling pack, staged 16-byte stores.
//
// Replaces the XLA blocks metabuli_tpu/ops/encode.py::extract_aa_kmers
// (:342, protein rows, optional closed syncmers) and ::extract_aa_kmers_dna
// (:377) with _translate_frames (:408, the 6-frame codon gather and
// translation under it). There every window packs k static shifted slices
// of the residue matrix, and the DNA variant first gathers each frame's
// codons into a [B, 6, A] amino-acid array in device memory.
//
// Bound on the card: the output bytes. Every slot (row, window; for DNA
// rows also frame) writes value (8 B), pos (4 B) and valid (1 B): 13 B a
// slot, against 1 B a residue or base of input, so both kernels are a
// stream of stores. What held the first design (a CTA of 256 threads per
// 256 windows of a row) far from that bound was latency per CTA, not
// bytes: a 150 bp read is 228 slots, so 8,192 reads made 8,192 CTAs that
// each waited on a byte-wide global load, two block barriers and k shared
// loads a window before three scalar stores of 2.96 KB in all. The design
// now:
//   * a warp owns a work item: a whole DNA row whose six frames fit its
//     share of shared memory (at most AMAX codons a frame, rows of up to
//     484 bases), or a protein row's chunk of TILE windows, its bytes
//     loaded with one 16-byte load a lane (SPAN bytes); a batch of more
//     items than WAVES times the CTAs the card holds at once is walked on
//     a grid-stride loop, each lane loading the next item's bytes while
//     the warp packs this one. Only __syncwarp orders a warp's phases;
//   * DNA rows: a lane translates codon p of all six frames from the 5
//     forward and 5 reverse bases around it, through the 64-entry codon
//     table staged in shared memory, into the warp's amino-acid rows;
//   * the rolling pack: a lane owns a run of RUN consecutive windows (of
//     one frame, for DNA rows); it packs the first with k shared loads and
//     each next one with one (v = (v << 5 | aa) & mask, and a k-bit mask
//     of the window's invalid residues), so its branches stay uniform
//     across the warp; protein syncmers first compute every s-mer of the
//     chunk the same way, then each window takes the first minimum of its
//     k - s + 1 s-mers (the rule of the reference, kept);
//   * the warp stages a tile of slots in shared memory, placed so that
//     each output's staged bytes agree with their device address mod 16,
//     then stores the tile with 16-byte stores, a partial chunk at either
//     end element by element: a row's value block is 16-byte aligned for
//     DNA rows (6W int64), pos and valid blocks in general are not.
// DNA rows with more codons keep the CTA-per-chunk kernel
// (aa_kmers_dna_kernel), launched beside the warp kernel only when the
// batch's padded length allows such a row; each kernel skips the other's
// rows. Every slot is written, invalid ones with the value the reference
// package computes there (the residue codes as they are; for DNA rows an
// invalid codon packs as 0), so the outputs equal the plain version
// everywhere.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 32;  // largest k

// the warp kernels
constexpr int WARPS = 4;        // warps a CTA
constexpr int RUN = 9;          // consecutive slots a lane packs
constexpr int TILE = 32 * RUN;  // slots a warp stages at once
constexpr int SPAN = 32 * 16;   // bytes a warp loads at once, 16 a lane
constexpr int AMAX = 160;       // codons a frame of a warp-path DNA row
// a warp-path row spans at most 3 AMAX + 4 bases, a protein chunk TILE +
// KMAX - 1 residues; either, 15 bytes off alignment, fits one load
static_assert(3 * AMAX + 4 + 15 <= SPAN, "DNA row span");
static_assert(TILE + KMAX - 1 + 15 <= SPAN, "protein chunk span");

// a tile of outputs, each array 16-byte aligned with room for the 16
// bytes of misalignment its device block may have
struct __align__(16) Stage {
  int64_t val[TILE + 2];
  int32_t pos[TILE + 4];
  uint8_t ok[TILE + 16];
};

// the CTA-per-chunk kernel (DNA rows past AMAX codons a frame)
constexpr int CHUNK = 256;                // windows per CTA (and frame)
constexpr int THREADS = 256;
constexpr int RES = CHUNK + KMAX - 1;     // codons a chunk
constexpr int BASES = 3 * RES + 2;        // bases a frame set spans

// the warp's bytes [p, p + n), n <= SPAN - 15: lane l loads the l-th
// 16-byte chunk from p rounded down to 16; its bytes land at raw[16 l], so
// byte i of the span sits at raw[(p & 15) + i]
__device__ __forceinline__ uint4 load_span(const uint8_t* p, int n,
                                           int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (16 * lane < (int)(a & 15) + n)
    v = __ldg(reinterpret_cast<const uint4*>(a & ~(uintptr_t)15) + lane);
  return v;
}

// where element 0 of dst's tile sits in its stage array: dst's offset from
// 16-byte alignment, in elements
template <class T>
__device__ __forceinline__ int stage_at(const T* dst) {
  return (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
}

// the warp stores n staged elements (stage[stage_at(dst) + i] -> dst[i]):
// each whole 16-byte chunk as one store, a partial chunk at either end
// element by element
template <class T>
__device__ __forceinline__ void store_tile(T* dst, const T* stage, int n,
                                           int lane) {
  constexpr int PER = 16 / (int)sizeof(T);
  const int off = stage_at(dst), end = off + n;
  T* base = dst - off;  // 16-byte aligned
  for (int c = lane; c * PER < end; c += 32) {
    const int lo = c * PER, hi = lo + PER;
    if (lo >= off && hi <= end) {
      *reinterpret_cast<uint4*>(base + lo) =
          *reinterpret_cast<const uint4*>(stage + lo);
    } else {
      for (int i = max(lo, off); i < min(hi, end); ++i) base[i] = stage[i];
    }
  }
}

// a tile's three outputs from the warp's stage, between two __syncwarp
__device__ __forceinline__ void store_stage(const Stage& st, int64_t* value,
                                            int32_t* pos, uint8_t* valid,
                                            int n, int lane) {
  __syncwarp();
  store_tile(value, st.val, n, lane);
  store_tile(pos, st.pos, n, lane);
  store_tile(valid, st.ok, n, lane);
  __syncwarp();
}

// the grid of a warp kernel: a warp per item, up to WAVES times the CTAs
// the card holds at once; past that the warps walk the items (grid-stride,
// the next item's bytes in flight). One item a warp lets the CTA
// scheduler hand work to an SM as its CTAs finish, where a grid of only
// the resident CTAs fixes each warp's share in advance.
constexpr int WAVES = 4;

template <class K>
int warp_grid(K kernel, int64_t items) {
  static int most = 0;
  if (most == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WARPS * 32, 0) !=
            cudaSuccess)
      return -1;
    most = WAVES * sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t need = (items + WARPS - 1) / WARPS;
  return (int)(need < most ? need : most);
}

// ------------------------------------------------------------ protein rows
// items: (row, chunk of TILE windows), chunk-minor
__global__ void __launch_bounds__(WARPS * 32)
aa_kmers_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ lens, int B, int L, int W,
                int chunks, int k, int syncmer, int smer_len,
                int64_t* __restrict__ value, int32_t* __restrict__ pos,
                uint8_t* __restrict__ valid) {
  __shared__ Stage s_stage[WARPS];
  __shared__ __align__(16) uint8_t s_raw[WARPS][SPAN];
  __shared__ int64_t s_smer[WARPS][TILE + KMAX];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  Stage& st = s_stage[wid];
  uint8_t* raw = s_raw[wid];
  int64_t* smer = s_smer[wid];
  const uint64_t vmask = 5 * k >= 64 ? ~0ull : (1ull << (5 * k)) - 1;
  const uint32_t kmask = k >= 32 ? ~0u : (1u << k) - 1;
  const uint64_t smask = (1ull << (5 * smer_len)) - 1;  // smer_len <= 12
  const int n_min = k - smer_len + 1;  // s-mers a window
  const int64_t items = (int64_t)B * chunks;
  const int64_t stride = (int64_t)gridDim.x * WARPS;

  // the item's row start, its first window and its residue count
  auto span = [&](int64_t item, const uint8_t** p, int* w0, int* n_res) {
    const int64_t b = item / chunks;
    *w0 = (int)(item - b * chunks) * TILE;
    *n_res = min(TILE, W - *w0) + k - 1;
    *p = codes + b * L + *w0;
  };
  int64_t item = (int64_t)blockIdx.x * WARPS + wid;
  uint4 pf = make_uint4(0, 0, 0, 0);
  int pf_len = 0;
  if (item < items) {
    const uint8_t* p;
    int w0, n_res;
    span(item, &p, &w0, &n_res);
    pf = load_span(p, n_res, lane);
    pf_len = lens[item / chunks];
  }
  for (; item < items; item += stride) {
    const int64_t b = item / chunks;
    const uint8_t* p;
    int w0, n_res;
    span(item, &p, &w0, &n_res);
    const int cw = n_res - k + 1;
    const int len = pf_len;
    *reinterpret_cast<uint4*>(raw + 16 * lane) = pf;
    if (item + stride < items) {  // the next item's bytes, in flight
      const uint8_t* q;
      int qw0, q_res;
      span(item + stride, &q, &qw0, &q_res);
      pf = load_span(q, q_res, lane);
      pf_len = lens[(item + stride) / chunks];
    }
    __syncwarp();
    const uint8_t* s = raw + (reinterpret_cast<uintptr_t>(p) & 15);

    if (syncmer) {
      // s-mers over residues with invalid ones (> 23) as 0, rolled along
      // each lane's run of positions
      const int n_sm = cw + k - smer_len;
      const int per = (n_sm + 31) / 32;
      const int i0 = lane * per, i1 = min(i0 + per, n_sm);
      uint64_t v = 0;
      for (int j = 0; i0 < i1 && j < smer_len - 1; ++j) {
        const uint32_t r = s[i0 + j];
        v = v << 5 | (r <= 23 ? r : 0);
      }
      for (int i = i0; i < i1; ++i) {
        const uint32_t r = s[i + smer_len - 1];
        v = (v << 5 | (r <= 23 ? r : 0)) & smask;
        smer[i] = (int64_t)v;
      }
      __syncwarp();
    }

    const int64_t g = b * W + w0;
    const int ov = stage_at(value + g), op = stage_at(pos + g),
              oo = stage_at(valid + g);
    const int j0 = lane * RUN, j1 = min(j0 + RUN, cw);
    uint64_t v = 0;
    uint32_t bad = 0;
    for (int q = 0; j0 < j1 && q < k - 1; ++q) {
      const uint32_t r = s[j0 + q];
      v = v << 5 | r;
      bad = bad << 1 | (r > 23);
    }
    for (int j = j0; j < j1; ++j) {
      const uint32_t r = s[j + k - 1];  // the window's last residue
      v = (v << 5 | r) & vmask;
      bad = (bad << 1 | (r > 23)) & kmask;
      bool ok = bad == 0 && w0 + j + k <= len;
      if (ok && syncmer) {
        // keep iff the FIRST minimal s-mer sits at offset 0 or k-s
        int64_t best = smer[j];
        int at = 0;
        for (int o = 1; o < n_min; ++o) {
          const int64_t m = smer[j + o];
          if (m < best) {
            best = m;
            at = o;
          }
        }
        ok = at == 0 || at == n_min - 1;
      }
      st.val[ov + j] = (int64_t)v;
      st.pos[op + j] = w0 + j;
      st.ok[oo + j] = ok;
    }
    store_stage(st, value + g, pos + g, valid + g, cw, lane);
  }
}

// ---------------------------------------------------------------- DNA rows
__device__ __forceinline__ int rc_base(int c) { return c <= 3 ? c ^ 2 : 7; }

__device__ __forceinline__ int8_t codon(const int8_t* tab, int c1, int c2,
                                        int c3) {
  return c1 <= 3 && c2 <= 3 && c3 <= 3 ? tab[(c1 * 16 + c2 * 4 + c3) & 63]
                                       : (int8_t)-1;
}

// a row's codons a frame and each reverse frame's first base: codon p is
// valid only below aa_len, where all its bases lie inside [0, len)
__device__ __forceinline__ int used_bases(int len) {
  return len >= 2 ? 3 * ((len - 2) / 3) : 0;
}

// items: whole rows of at most AMAX codons a frame
__global__ void __launch_bounds__(WARPS * 32)
aa_kmers_dna_warp_kernel(const uint8_t* __restrict__ codes,
                         const int32_t* __restrict__ lens, int B, int L,
                         int W, int k, const int32_t* __restrict__ aa_tab,
                         int64_t* __restrict__ value,
                         int32_t* __restrict__ pos,
                         uint8_t* __restrict__ valid) {
  __shared__ Stage s_stage[WARPS];
  __shared__ __align__(16) uint8_t s_raw[WARPS][SPAN];
  __shared__ int8_t s_aa[WARPS][6][AMAX];  // amino acid, -1 invalid
  __shared__ int8_t s_tab[64];
  if (threadIdx.x < 64) s_tab[threadIdx.x] = (int8_t)aa_tab[threadIdx.x];
  __syncthreads();  // the codon table, once; from here only __syncwarp
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  Stage& st = s_stage[wid];
  uint8_t* raw = s_raw[wid];
  int8_t(*aa)[AMAX] = s_aa[wid];
  const uint64_t vmask = 5 * k >= 64 ? ~0ull : (1ull << (5 * k)) - 1;
  const uint32_t kmask = k >= 32 ? ~0u : (1u << k) - 1;
  const int n_load = min(L, 3 * AMAX + 4);  // a warp-path row's bases
  const int slots = 6 * W;
  const int rpf = (W + RUN - 1) / RUN;  // runs a frame
  const int stride = gridDim.x * WARPS;

  int b = blockIdx.x * WARPS + wid;
  uint4 pf = make_uint4(0, 0, 0, 0);
  int pf_len = 0;
  if (b < B) {
    pf = load_span(codes + (int64_t)b * L, n_load, lane);
    pf_len = lens[b];
  }
  for (; b < B; b += stride) {
    const uint8_t* row = codes + (int64_t)b * L;
    const int len = pf_len;
    *reinterpret_cast<uint4*>(raw + 16 * lane) = pf;
    if (b + stride < B) {  // the next row's bases, in flight
      pf = load_span(row + (int64_t)stride * L, n_load, lane);
      pf_len = lens[b + stride];
    }
    const int used = used_bases(len);
    const int aa_len = used / 3;
    if (aa_len > AMAX) continue;  // the CTA-per-chunk kernel's row
    __syncwarp();
    const uint8_t* s = raw + (reinterpret_cast<uintptr_t>(row) & 15);
    const int r3 = len % 3;

    // codon p of every frame: forward frame f reads bases f + 3p .. +2,
    // reverse frame 3 + r reads down from e + begin_r, e = used - 1 - 3p,
    // begin_r = (len % 3 - r) mod 3: bases 3p .. 3p + 4 and e - 2 .. e + 2
    for (int p = lane; p < aa_len; p += 32) {
      const int q = 3 * p, e = used - 1 - q;
      const int c0 = s[q], c1 = s[q + 1], c2 = s[q + 2], c3 = s[q + 3],
                c4 = s[q + 4];
      aa[0][p] = codon(s_tab, c0, c1, c2);
      aa[1][p] = codon(s_tab, c1, c2, c3);
      aa[2][p] = codon(s_tab, c2, c3, c4);
      // reverse frame 3 + r reads rc(e + beg_r), rc(e + beg_r - 1),
      // rc(e + beg_r - 2), beg_r = (len % 3 - r) mod 3
      const int d0 = rc_base(s[e - 2]), d1 = rc_base(s[e - 1]),
                d2 = rc_base(s[e]), d3 = rc_base(s[e + 1]),
                d4 = rc_base(s[e + 2]);
      const int8_t from0 = codon(s_tab, d2, d1, d0);  // beg 0
      const int8_t from1 = codon(s_tab, d3, d2, d1);  // beg 1
      const int8_t from2 = codon(s_tab, d4, d3, d2);  // beg 2
      for (int r = 0; r < 3; ++r) {
        const int beg = (r3 - r + 3) % 3;
        aa[3 + r][p] = beg == 0 ? from0 : beg == 1 ? from1 : from2;
      }
    }
    __syncwarp();

    // the row's 6 W slots, frame-major, in runs of RUN windows that never
    // cross a frame (each frame has rpf runs), 32 runs a tile: the runs
    // of a tile cover consecutive slots, t0 .. t1
    for (int r0 = 0; r0 < 6 * rpf; r0 += 32) {
      const int f0 = r0 / rpf, fl = min(r0 + 31, 6 * rpf - 1) / rpf;
      const int t0 = f0 * W + (r0 - f0 * rpf) * RUN;
      const int t1 = fl * W + min(W, (min(r0 + 31, 6 * rpf - 1) - fl * rpf
                                      + 1) * RUN);
      const int64_t g = (int64_t)b * slots + t0;
      const int ov = stage_at(value + g), op = stage_at(pos + g),
                oo = stage_at(valid + g);
      const int run = r0 + lane, f = run / rpf;
      const int w0 = (run - f * rpf) * RUN;
      const int w1 = run < 6 * rpf ? min(w0 + RUN, W) : w0;
      const int j0 = f * W + w0 - t0;
      // forward frame f's window w starts at base f + 3w, reverse frame
      // 3 + r's at beg_r + used - 3 (w + k)
      int p = f < 3 ? f + 3 * w0 : (r3 - (f - 3) + 3) % 3 + used - 3 * (w0 + k);
      const int dp = f < 3 ? 3 : -3;
      uint64_t v = 0;
      uint32_t bad = 0;
      for (int q = 0; w0 < w1 && q < k - 1; ++q) {
        const int a = w0 + q < aa_len ? aa[f][w0 + q] : -1;
        v = v << 5 | (uint64_t)(a >= 0 ? a : 0);
        bad = bad << 1 | (a < 0);
      }
      for (int w = w0; w < w1; ++w) {
        const int q = w + k - 1;  // the window's last codon
        const int a = q < aa_len ? aa[f][q] : -1;
        v = (v << 5 | (uint64_t)(a >= 0 ? a : 0)) & vmask;
        bad = (bad << 1 | (a < 0)) & kmask;
        const int j = j0 + w - w0;
        st.val[ov + j] = (int64_t)v;
        st.pos[op + j] = p;
        st.ok[oo + j] = bad == 0;
        p += dp;
      }
      store_stage(st, value + g, pos + g, valid + g, t1 - t0, lane);
    }
  }
}

// a CTA per (row, chunk of CHUNK windows) of the rows the warp kernel
// leaves: each loads its chunk's bases into shared memory, translates each
// frame's codons once, then packs a window a thread
__global__ void __launch_bounds__(THREADS)
aa_kmers_dna_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lens, int L, int W,
                    int chunks, int k, const int32_t* __restrict__ aa_tab,
                    int64_t* __restrict__ value, int32_t* __restrict__ pos,
                    uint8_t* __restrict__ valid) {
  __shared__ uint8_t s_fwd[BASES + 2];  // bases of the forward frames
  __shared__ uint8_t s_rev[BASES + 2];  // bases of the reverse frames
  __shared__ int8_t s_tab[64];
  __shared__ int8_t s_aa[6][RES];       // amino acid, -1 invalid
  const unsigned chunk = blockIdx.x % (unsigned)chunks;
  const int b = (int)(blockIdx.x / (unsigned)chunks);
  const int len = lens[b];
  const int used = used_bases(len);
  const int aa_len = used / 3;
  if (aa_len <= AMAX) return;  // the warp kernel's row
  const int w0 = (int)chunk * CHUNK;
  const int cw = min(CHUNK, W - w0);
  const int n_cod = cw + k - 1;
  const uint8_t* row = codes + (int64_t)b * L;
  // forward frame f, codon p: bases f + 3p .. f + 3p + 2, so the chunk's
  // codons span [3 w0, 3 (w0 + n_cod) + 2) of the row
  const int64_t f_lo = 3 * (int64_t)w0;
  // reverse frame f, codon p: bases end_f - 3p - 2 .. end_f - 3p, end_f =
  // begin_f + used - 1 with begin_f in 0..2; the span starts at end_0's
  // lowest codon and runs 3 n_cod + 2 bases (r_lo may be negative)
  const int64_t r_lo = (int64_t)used - 1 - 3 * ((int64_t)w0 + n_cod - 1) - 2;
  const int span = 3 * n_cod + 2;
  for (int i = threadIdx.x; i < span; i += THREADS) {
    const int64_t fi = f_lo + i, ri = r_lo + i;
    s_fwd[i] = fi < len ? row[fi] : 7;
    s_rev[i] = ri >= 0 && ri < len ? row[ri] : 7;
  }
  if (threadIdx.x < 64) s_tab[threadIdx.x] = (int8_t)aa_tab[threadIdx.x];
  __syncthreads();

  for (int i = threadIdx.x; i < 6 * n_cod; i += THREADS) {
    const int f = i / n_cod, kk = i - f * n_cod;
    const int p = w0 + kk;
    int8_t a = -1;
    if (p < aa_len) {
      if (f < 3) {
        const int q = f + 3 * kk;
        a = codon(s_tab, s_fwd[q], s_fwd[q + 1], s_fwd[q + 2]);
      } else {
        const int begin = ((len % 3) - (f - 3) + 3) % 3;
        // row base end_f - 3p, at end_f - 3p - r_lo in the span
        const int q = (int)((int64_t)begin + used - 1 - 3 * (int64_t)p - r_lo);
        a = codon(s_tab, rc_base(s_rev[q]), rc_base(s_rev[q - 1]),
                  rc_base(s_rev[q - 2]));
      }
    }
    s_aa[f][kk] = a;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 6 * cw; i += THREADS) {
    const int f = i / cw, wl = i - f * cw;
    uint64_t v = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      const int a = s_aa[f][wl + j];
      ok = ok && a >= 0;
      v = v << 5 | (uint64_t)(a >= 0 ? a : 0);
    }
    const int w = w0 + wl;
    int p;
    if (f < 3) {
      p = f + 3 * w;
    } else {
      const int begin = ((len % 3) - (f - 3) + 3) % 3;
      p = begin + used - 1 - 3 * (w + k) + 1;
    }
    const int64_t t = ((int64_t)b * 6 + f) * W + w;
    value[t] = (int64_t)v;
    pos[t] = p;
    valid[t] = ok;
  }
}

bool bad_args(int B, int W, int k, int smer_len) {
  return B < 1 || W < 1 || k < 1 || k > KMAX || smer_len < 1 ||
         smer_len > k || smer_len > 12;
}

}  // namespace

extern "C" int mtb_extract_aa_kmers(const uint8_t* codes, const int32_t* lens,
                                    int B, int L, int W, int k, int syncmer,
                                    int smer_len, int64_t* value,
                                    int32_t* pos, bool* valid,
                                    cudaStream_t stream) {
  if (bad_args(B, W, k, smer_len) || W != L - k + 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = (W + TILE - 1) / TILE;
  const int grid = warp_grid(aa_kmers_kernel, (int64_t)B * chunks);
  if (grid < 0) return (int)cudaGetLastError();
  aa_kmers_kernel<<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      codes, lens, B, L, W, chunks, k, syncmer, smer_len, value, pos,
      reinterpret_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

// aa_tab: the standard alphabet's 64-entry codon -> amino acid table
extern "C" int mtb_extract_aa_kmers_dna(const uint8_t* codes,
                                        const int32_t* lens, int B, int L,
                                        int W, int k, const int32_t* aa_tab,
                                        int64_t* value, int32_t* pos,
                                        bool* valid, cudaStream_t stream) {
  if (bad_args(B, W, k, 1) || W != (L - 2) / 3 - k + 1)
    return (int)cudaErrorInvalidValue;
  uint8_t* ok = reinterpret_cast<uint8_t*>(valid);
  const int grid = warp_grid(aa_kmers_dna_warp_kernel, B);
  if (grid < 0) return (int)cudaGetLastError();
  aa_kmers_dna_warp_kernel<<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      codes, lens, B, L, W, k, aa_tab, value, pos, ok);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || (L - 2) / 3 <= AMAX) return rc;  // no row past AMAX
  const int chunks = (W + CHUNK - 1) / CHUNK;
  if ((int64_t)B * chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  aa_kmers_dna_kernel<<<(unsigned)(B * chunks), THREADS, 0, stream>>>(
      codes, lens, L, W, chunks, k, aa_tab, value, pos, ok);
  return (int)cudaGetLastError();
}
