// K1: 6-frame metamer extraction, one CTA per row chunk.
//
// Replaces the XLA block metabuli_tpu/ops/encode.py::extract_metamers
// (:72-272) with _syncmer_keep (:275-299): there, base triples go through
// a 64-way select tree and every frame is a stride-3 slice, with the
// reverse frames packed in flipped coordinates.
//
// Bound on the card: the output bytes. Every (read, frame, window) slot
// writes value, dna48 (8 B each), pos (4 B) and valid (1 B): 21 B a slot,
// against 1 B a base of input, so the kernel is a stream of stores. The
// design keeps everything else off the memory path:
//   * a CTA takes CHUNK windows of one row (a short read is one chunk; a
//     100 kb genome is ~130) plus the 23-base halo the chunk's last
//     window reaches, so long rows tile the same way; the grid is 1-D
//     over (row, chunk), row-major, so a row may have any number of
//     chunks (a 2-D grid capped them at 65,535, rows of ~50 Mb bases):
//     one 32-bit division a CTA gives its place; base offsets are 64-bit,
//     so rows up to 2^31 bases index correctly;
//   * the chunk's bases are loaded once into shared memory with 4-byte
//     coalesced loads; one pass then decodes each frame's codons once
//     (6-bit code, amino acid, codon number, valid flag) into a shared
//     array, through the two 64-entry codon tables staged in shared
//     memory; with syncmers on, each s-mer value is computed once per
//     codon position;
//   * each thread then packs its slots' windows from the shared codons and
//     writes the four outputs; consecutive threads hold consecutive
//     windows of a frame, so every store is coalesced.
// The stores still take ~2x their bound at the main path's shape: a
// 150-base read is one CTA of 252 slots whose loads, decode and stores
// follow one another, so per-CTA latency, not bandwidth, sets the pace.
//
// The reduced 16-letter alphabet (--reduced-aa 1) is the same kernel with
// Reduced = true: its own codon tables (amino acids 0..15, codon numbers
// 0..10), value = 8 x 4-bit amino acids << 32 | 8 x 4-bit codon numbers,
// and no dna48 (reduced metamers are scored on their codon numbers). Each
// decoded codon keeps a 4-bit codon-number field in both variants: the
// reference's scanner packs 3 bits and truncates reduced codon numbers
// above 7 (metabuli_tpu/ops/encode.py:84-91), which this layout avoids.
//
// Old-format DBs (kmer_format 1, metabuli_tpu/ops/encode.py:239-254) are
// the same kernel with Old = true: the same eight codons packed
// little-endian, the codon of slot j (format 2's j-th most significant)
// weighing 21^j in a base-21 amino-acid sum (16^j reduced), its codon
// number at bits 3j (4j reduced) and its bases at dna48 bits 6j.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 8;            // codons per metamer
constexpr int CHUNK = 256;      // windows per CTA and frame
constexpr int CODONS = CHUNK + K - 1;
constexpr int HALO = 3 * (K - 1) + 2;    // 23 bases past the last window
constexpr int BASES = 3 * CHUNK + HALO;  // + the frame offset, at most 2
constexpr int WORDS = (BASES + 2 + 3) / 4 + 1;
constexpr int THREADS = 128;  // a full chunk: 2 windows a thread and frame
constexpr uint32_t VALID = 1u << 15;

template <bool Reduced, bool Old>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const uint8_t* __restrict__ codes,
               const int32_t* __restrict__ lens, int L, int W, int chunks,
               int syncmer, int smer_len,
               const int32_t* __restrict__ aa_tab,
               const int32_t* __restrict__ num_tab,
               int64_t* __restrict__ value, int32_t* __restrict__ pos,
               bool* __restrict__ valid, int64_t* __restrict__ dna48) {
  __shared__ uint32_t s_words[WORDS];
  constexpr int AA_BITS = Reduced ? 4 : 5;
  constexpr int NUM_BITS = Reduced ? 4 : 3;
  __shared__ uint16_t s_tab[64];         // aa << 4 | codon number
  __shared__ uint16_t s_cod[6][CODONS];  // VALID | aa << 10 | num << 6 | c6
  __shared__ uint64_t s_smer[6][CODONS];
  const unsigned chunk = blockIdx.x % (unsigned)chunks;
  const int b = (int)(blockIdx.x / (unsigned)chunks);
  const int w0 = (int)chunk * CHUNK;
  const int cw = min(CHUNK, W - w0);
  const int tid = threadIdx.x;
  const int len = lens[b];
  const int aa_len = len >= 2 ? (len - 2) / 3 : 0;

  // bases [3 w0, 3 w0 + 3 cw + 23) of the row, as aligned 4-byte words
  const int64_t base0 = 3 * (int64_t)w0;
  const int64_t left = (int64_t)L - base0;
  const int nb = left < 3 * cw + HALO ? (int)left : 3 * cw + HALO;
  const uint8_t* first = codes + (int64_t)b * L + base0;
  const int shift = (int)((uintptr_t)first & 3);
  const uint32_t* words = (const uint32_t*)(first - shift);
  for (int i = tid; i < (shift + nb + 3) / 4; i += THREADS)
    s_words[i] = words[i];
  if (tid < 64) s_tab[tid] = (uint16_t)(aa_tab[tid] << 4 | num_tab[tid]);
  __syncthreads();
  const uint8_t* base = (const uint8_t*)s_words + shift;

  // each frame's codons w0 .. w0 + cw + 6, decoded once
  const int n_cod = cw + K - 1;
  for (int i = tid; i < 6 * n_cod; i += THREADS) {
    const int f = i / n_cod, kk = i - f * n_cod;
    const int begin = f < 3 ? f : ((len % 3) - (f - 3) + 3) % 3;
    const int q = begin + 3 * kk;  // base offset in the chunk
    uint32_t code = 0;
    if (w0 + kk < aa_len && base0 + q + 2 < L) {
      const int b0 = base[q], b1 = base[q + 1], b2 = base[q + 2];
      if (b0 <= 3 && b1 <= 3 && b2 <= 3) {
        const int c = f < 3 ? (b0 << 4 | b1 << 2 | b2)
                            : ((b2 ^ 2) << 4 | (b1 ^ 2) << 2 | (b0 ^ 2));
        code = VALID | (uint32_t)s_tab[c] << 6 | (uint32_t)c;
      }
    }
    s_cod[f][kk] = (uint16_t)code;
  }
  __syncthreads();

  // s-mer values in each frame's canonical order: forward s-mers pack
  // codons kk .. kk+s-1 upward, reverse ones kk+s-1 .. kk downward
  const int n_sm = cw + K - smer_len;
  if (syncmer) {
    for (int i = tid; i < 6 * n_sm; i += THREADS) {
      const int f = i / n_sm, kk = i - f * n_sm;
      uint64_t v = 0;
      for (int j = 0; j < smer_len; ++j) {
        const int c = f < 3 ? kk + j : kk + smer_len - 1 - j;
        v = v << 5 | (uint64_t)(s_cod[f][c] >> 10 & 31);
      }
      s_smer[f][kk] = v;
    }
    __syncthreads();
  }

  for (int i = tid; i < 6 * cw; i += THREADS) {
    const int f = i / cw, wl = i - f * cw;
    const bool reverse = f >= 3;
    // slot j (most significant first): forward codon w+j, reverse w+7-j
    uint64_t aa_part = 0, dna_part = 0, d48 = 0, weight = 1;
    bool ok = true;
    for (int j = 0; j < K; ++j) {
      const uint32_t code = s_cod[f][reverse ? wl + K - 1 - j : wl + j];
      ok = ok && (code & VALID);
      if (Old) {  // slot j the j-th least significant
        aa_part += (code >> 10 & 31) * weight;
        weight *= Reduced ? 16 : 21;
        dna_part |= (uint64_t)(code >> 6 & 15) << NUM_BITS * j;
        if (!Reduced) d48 |= (uint64_t)(code & 63) << 6 * j;
      } else {
        aa_part = aa_part << AA_BITS | (code >> 10 & 31);
        dna_part = dna_part << NUM_BITS | (code >> 6 & 15);
        if (!Reduced) d48 = d48 << 6 | (code & 63);
      }
    }
    if (ok && syncmer) {
      // keep iff the FIRST minimal s-mer sits at offset 0 or 8-s
      const int n = K - smer_len + 1;
      uint64_t best = ~0ull;
      int at = 0;
      for (int o = 0; o < n; ++o) {
        const uint64_t v =
            s_smer[f][reverse ? wl + K - smer_len - o : wl + o];
        if (v < best) {
          best = v;
          at = o;
        }
      }
      ok = at == 0 || at == n - 1;
    }
    const int w = w0 + wl;
    const int begin = f < 3 ? f : ((len % 3) - (f - 3) + 3) % 3;
    const int64_t t = ((int64_t)b * 6 + f) * W + w;
    value[t] = ok ? (int64_t)(aa_part << 8 * NUM_BITS | dna_part) : 0;
    if (!Reduced) dna48[t] = ok ? (int64_t)d48 : 0;
    pos[t] = (int32_t)(begin + 3 * (int64_t)w);
    valid[t] = ok;
  }
}

template <bool Reduced>
int launch(const uint8_t* codes, const int32_t* lens, int B, int L, int W,
           int syncmer, int smer_len, const int32_t* aa_tab,
           const int32_t* num_tab, int64_t* value, int32_t* pos, bool* valid,
           int64_t* dna48, int kmer_format, cudaStream_t stream) {
  const int chunks = (W + CHUNK - 1) / CHUNK;
  const int64_t ctas = (int64_t)B * chunks;  // grid x holds up to 2^31 - 1
  if (B < 1 || W < 1 || ctas > 0x7fffffff || smer_len < 1 || smer_len > K ||
      (kmer_format != 1 && kmer_format != 2))
    return (int)cudaErrorInvalidValue;
  if (kmer_format == 2)
    extract_kernel<Reduced, false><<<(unsigned)ctas, THREADS, 0, stream>>>(
        codes, lens, L, W, chunks, syncmer, smer_len, aa_tab, num_tab, value,
        pos, valid, dna48);
  else
    extract_kernel<Reduced, true><<<(unsigned)ctas, THREADS, 0, stream>>>(
        codes, lens, L, W, chunks, syncmer, smer_len, aa_tab, num_tab, value,
        pos, valid, dna48);
  return (int)cudaGetLastError();
}

}  // namespace

// kmer_format: 2, or 1 for the old-format packing
extern "C" int mtb_extract_metamers(const uint8_t* codes, const int32_t* lens,
                                    int B, int L, int W, int syncmer,
                                    int smer_len, const int32_t* aa_tab,
                                    const int32_t* num_tab, int64_t* value,
                                    int32_t* pos, bool* valid, int64_t* dna48,
                                    int kmer_format, cudaStream_t stream) {
  return launch<false>(codes, lens, B, L, W, syncmer, smer_len, aa_tab,
                       num_tab, value, pos, valid, dna48, kmer_format,
                       stream);
}

// the reduced alphabet: dna48 is not written (may be null)
extern "C" int mtb_extract_metamers_reduced(
    const uint8_t* codes, const int32_t* lens, int B, int L, int W,
    int syncmer, int smer_len, const int32_t* aa_tab, const int32_t* num_tab,
    int64_t* value, int32_t* pos, bool* valid, int64_t* dna48,
    int kmer_format, cudaStream_t stream) {
  return launch<true>(codes, lens, B, L, W, syncmer, smer_len, aa_tab,
                      num_tab, value, pos, valid, dna48, kmer_format, stream);
}
