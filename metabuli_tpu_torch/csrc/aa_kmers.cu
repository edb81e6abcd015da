// K12: amino-acid k-mer scanners, one CTA per row chunk.
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
// stream of stores. The design follows K1's (extract.cu):
//   * a CTA takes CHUNK windows of one row plus the halo its last window
//     reaches; the grid is 1-D over (row, chunk), row-major, so a row may
//     have any number of chunks, and base offsets are 64-bit;
//   * the chunk's residues (protein) or bases (DNA: the forward frames'
//     span and the reverse frames' span, each once) are loaded once into
//     shared memory;
//   * DNA rows: one pass translates each frame's codons once, through the
//     64-entry codon table staged in shared memory, into a shared array
//     of amino acids, so the translation never reaches device memory;
//   * protein rows with syncmers on: each s-mer value is computed once
//     per residue position, in shared memory;
//   * each thread then packs its windows' k residues and writes the three
//     outputs; consecutive threads hold consecutive windows of a row (and
//     frame), so every store is coalesced.
// Every slot is written, invalid ones with the value the reference package
// computes there (the residue codes as they are; for DNA rows an invalid
// codon packs as 0), so the outputs equal the plain version everywhere.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 256;   // windows per CTA (and frame)
constexpr int KMAX = 32;     // largest k the shared arrays hold
constexpr int THREADS = 256;
constexpr int RES = CHUNK + KMAX - 1;        // residues or codons a chunk
constexpr int BASES = 3 * RES + 2;           // bases a frame set spans

// ------------------------------------------------------------ protein rows
__global__ void __launch_bounds__(THREADS)
aa_kmers_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ lens, int L, int W, int chunks,
                int k, int syncmer, int smer_len,
                int64_t* __restrict__ value, int32_t* __restrict__ pos,
                bool* __restrict__ valid) {
  __shared__ uint8_t s_res[RES];
  __shared__ uint64_t s_smer[RES];
  const unsigned chunk = blockIdx.x % (unsigned)chunks;
  const int b = (int)(blockIdx.x / (unsigned)chunks);
  const int w0 = (int)chunk * CHUNK;
  const int cw = min(CHUNK, W - w0);
  const int n_res = cw + k - 1;  // <= L - w0: W = L - k + 1
  const int len = lens[b];
  const uint8_t* row = codes + (int64_t)b * L + w0;
  for (int i = threadIdx.x; i < n_res; i += THREADS) s_res[i] = row[i];
  __syncthreads();
  const int n_sm = cw + k - smer_len;
  if (syncmer) {
    // s-mers over residues with invalid ones (> 23) as 0
    for (int i = threadIdx.x; i < n_sm; i += THREADS) {
      uint64_t v = 0;
      for (int j = 0; j < smer_len; ++j) {
        const uint32_t r = s_res[i + j];
        v = v << 5 | (r <= 23 ? r : 0);
      }
      s_smer[i] = v;
    }
    __syncthreads();
  }
  for (int wl = threadIdx.x; wl < cw; wl += THREADS) {
    uint64_t v = 0;
    bool ok = w0 + wl + k <= len;
    for (int j = 0; j < k; ++j) {
      const uint32_t r = s_res[wl + j];
      ok = ok && r <= 23;
      v = v << 5 | r;
    }
    if (ok && syncmer) {
      // keep iff the FIRST minimal s-mer sits at offset 0 or k-s
      const int n = k - smer_len + 1;
      uint64_t best = ~0ull;
      int at = 0;
      for (int o = 0; o < n; ++o) {
        const uint64_t s = s_smer[wl + o];
        if (s < best) {
          best = s;
          at = o;
        }
      }
      ok = at == 0 || at == n - 1;
    }
    const int64_t t = (int64_t)b * W + w0 + wl;
    value[t] = (int64_t)v;
    pos[t] = w0 + wl;
    valid[t] = ok;
  }
}

// ---------------------------------------------------------------- DNA rows
__device__ __forceinline__ int rc_base(int c) { return c <= 3 ? c ^ 2 : 7; }

__global__ void __launch_bounds__(THREADS)
aa_kmers_dna_kernel(const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ lens, int L, int W,
                    int chunks, int k, const int32_t* __restrict__ aa_tab,
                    int64_t* __restrict__ value, int32_t* __restrict__ pos,
                    bool* __restrict__ valid) {
  __shared__ uint8_t s_fwd[BASES + 2];  // bases of the forward frames
  __shared__ uint8_t s_rev[BASES + 2];  // bases of the reverse frames
  __shared__ int8_t s_tab[64];
  __shared__ int8_t s_aa[6][RES];       // amino acid, -1 invalid
  const unsigned chunk = blockIdx.x % (unsigned)chunks;
  const int b = (int)(blockIdx.x / (unsigned)chunks);
  const int w0 = (int)chunk * CHUNK;
  const int cw = min(CHUNK, W - w0);
  const int n_cod = cw + k - 1;
  const int len = lens[b];
  // codons per frame, and each reverse frame's last base: a codon p is
  // valid only below aa_len, where all its bases lie inside [0, len)
  const int used = len >= 2 ? 3 * ((len - 2) / 3) : 0;
  const int aa_len = used / 3;
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
    int aa = -1;
    if (p < aa_len) {
      int c1, c2, c3;
      if (f < 3) {
        const int q = f + 3 * kk;
        c1 = s_fwd[q];
        c2 = s_fwd[q + 1];
        c3 = s_fwd[q + 2];
      } else {
        const int begin = ((len % 3) - (f - 3) + 3) % 3;
        // row base end_f - 3p, at end_f - 3p - r_lo in the span
        const int q = (int)((int64_t)begin + used - 1 - 3 * (int64_t)p - r_lo);
        c1 = rc_base(s_rev[q]);
        c2 = rc_base(s_rev[q - 1]);
        c3 = rc_base(s_rev[q - 2]);
      }
      if (c1 <= 3 && c2 <= 3 && c3 <= 3)
        aa = s_tab[(c1 * 16 + c2 * 4 + c3) & 63];
    }
    s_aa[f][kk] = (int8_t)aa;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 6 * cw; i += THREADS) {
    const int f = i / cw, wl = i - f * cw;
    uint64_t v = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      const int aa = s_aa[f][wl + j];
      ok = ok && aa >= 0;
      v = v << 5 | (uint64_t)(aa >= 0 ? aa : 0);
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

int grid(int B, int W, int k, int smer_len, int* chunks) {
  *chunks = (W + CHUNK - 1) / CHUNK;
  const int64_t ctas = (int64_t)B * *chunks;
  if (B < 1 || W < 1 || k < 1 || k > KMAX || smer_len < 1 || smer_len > k ||
      ctas > 0x7fffffff)
    return -1;
  return (int)ctas;
}

}  // namespace

extern "C" int mtb_extract_aa_kmers(const uint8_t* codes, const int32_t* lens,
                                    int B, int L, int W, int k, int syncmer,
                                    int smer_len, int64_t* value,
                                    int32_t* pos, bool* valid,
                                    cudaStream_t stream) {
  int chunks;
  const int ctas = grid(B, W, k, smer_len, &chunks);
  if (ctas < 0 || W != L - k + 1) return (int)cudaErrorInvalidValue;
  aa_kmers_kernel<<<(unsigned)ctas, THREADS, 0, stream>>>(
      codes, lens, L, W, chunks, k, syncmer, smer_len, value, pos, valid);
  return (int)cudaGetLastError();
}

// aa_tab: the standard alphabet's 64-entry codon -> amino acid table
extern "C" int mtb_extract_aa_kmers_dna(const uint8_t* codes,
                                        const int32_t* lens, int B, int L,
                                        int W, int k, const int32_t* aa_tab,
                                        int64_t* value, int32_t* pos,
                                        bool* valid, cudaStream_t stream) {
  int chunks;
  const int ctas = grid(B, W, k, 1, &chunks);
  if (ctas < 0 || W != (L - 2) / 3 - k + 1) return (int)cudaErrorInvalidValue;
  aa_kmers_dna_kernel<<<(unsigned)ctas, THREADS, 0, stream>>>(
      codes, lens, L, W, chunks, k, aa_tab, value, pos, valid);
  return (int)cudaGetLastError();
}
