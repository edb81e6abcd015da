// K3: match chaining; a warp walks the (read, species, frame) blocks that
// start in a window of kWindow rows, in tiles of up to 32 rows.
//
// Replaces the XLA block metabuli_tpu/classify/device_chain.py::
// chain_matches (:89-332): there, matches are scattered into a dense
// [column, slot, block] grid and one lax.scan over columns carries every
// block's previous position group; blocks that do not fit the grid fall
// back to the host. Here the rows are walked in their sorted order, as the
// reference does (getMatchPaths, Taxonomer.cpp:487-648), so no block is too
// long and no group too wide.
//
// Rules, as in the reference package: groups are runs of equal pos/3; a
// current match connects to a previous-group match iff the quotient shift
// is in [1, max_shift] and the 24-bit codon words overlap (isConsecutive2,
// operand order swapped on reverse frames); it extends the connectable
// predecessor with the highest score (first wins ties; score > 0). Each
// row ends up holding the path that ends at it; emit[r] marks the paths
// that end there: a previous-group path that connects to nothing, at
// depth >= the species' minimum, and the last group of a block with at
// least two groups.
//
// Design. A warp finds the block heads of its window by ballot (no head
// list, no host sync) and walks the rows from its first head to the end of
// its last block in tiles: 32 rows loaded with coalesced loads, cut back to
// the last group boundary among them (a tile holds whole groups; a group
// wider than 32 rows is a tile of its own). Group and block boundaries come
// from ballots on key changes. The tile's last group is carried to the next
// tile in shared memory (its first 32 rows; rows past 32 of a wider group
// are read back from the outputs already written). Per tile:
//  - every row counts its connectable predecessors in the previous group
//    (lane per row; the previous group is in shared memory) and marks
//    them connected;
//  - if no row has two or more, each row's predecessor is fixed and the
//    paths are a forest over the tile: pointer jumping (five rounds of
//    shuffles) gives every row its path's start, sums and root. Blocks of
//    one-row groups, the common case, take this path at one lane per row;
//  - otherwise (and for a wide group) the tile's groups are taken in order,
//    the lanes over the (previous row, current row) pairs of each, and
//    every current row's best predecessor is reduced in shared memory with
//    a 64-bit atomicMax of (score bits, ~i): highest score, then first i;
//  - emit flags of the groups whose successor is known are written by lane.
// Path states are written once, coalesced (a lane per row).
//
// Scores: the kernel adds a path's per-codon terms in another order than
// the reference (pointer jumping). Every term (3, 1.5, 1, 0.5) and hence
// every partial sum is a multiple of 0.5, and a path's score is below
// 3 x (depth + 8) < 2^23 for any read shorter than 8 Mbp, so every float32
// sum is exact in any order and the scores equal the reference's bit for
// bit. Every score is also > 0 (positive terms), so a connectable
// predecessor always extends.
//
// Bound on the card: bytes. Least bytes for one call (chip_smoke.py
// computes them): the 7 int32 input columns read once (28 B per row) and
// 21 B of path state and emit flag written once per row. Per tile the warp
// waits on its loads before it can size the next tile, so a warp's tiles
// are a chain of dependent load latencies.

#include <cstdint>
#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;           // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kWindow = 256;        // rows whose block heads one warp takes

__device__ __forceinline__ float codon_term(int h) {
  return h == 0 ? 3.0f : 2.0f - 0.5f * (float)h;
}

__device__ __forceinline__ float match_score(int h16) {
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s = s + codon_term((h16 >> (2 * i)) & 3);
  return s;
}

struct Matches {  // the sorted match columns
  const int32_t* qid;
  const int32_t* species;
  const int32_t* frame;
  const int32_t* pos;
  const int32_t* ham;
  const int32_t* dna;
  const int32_t* h16;
};

struct Paths {  // per row: the path that ends there, and its emit flag
  float* score;
  int32_t* start;
  int32_t* ham;
  int32_t* depth;
  int32_t* sh16;
  bool* emit;
};

struct State {
  float score;
  int32_t start, ham, depth, sh16;
};

__device__ __forceinline__ State fresh(int h16, int pos, int ham) {
  return {match_score(h16), pos, ham, 1, h16};
}

// the path p extended by a match with codon counts h16, sh codons on
__device__ __forceinline__ State extend(const State& p, int h16, int sh) {
  float inc = 0.0f;
  int inc_h = 0;
  for (int c = 0; c < sh; ++c) {
    int hc = (h16 >> (2 * c)) & 3;
    inc = inc + codon_term(hc);
    inc_h += hc;
  }
  return {p.score + inc, p.start, p.ham + inc_h, p.depth + sh, p.sh16};
}

__device__ __forceinline__ bool overlaps(int di, int dj, int sh, bool fwd) {
  int32_t mask = (1 << (24 - 3 * sh)) - 1;
  return fwd ? (di & mask) == (dj >> (3 * sh))
             : (dj & mask) == (di >> (3 * sh));
}

// One warp's rows on chip: buffer 0 holds the carried group (the previous
// tile's last), buffer 1 the tile, each its first 32 rows; a row past 32
// is read from the outputs (its states) and the inputs (its codons), and
// its "connected" flag lives in emit[] until its emit flag is decided.
struct Rows {
  float score[2][32];
  int32_t start[2][32], ham[2][32], depth[2][32], sh16[2][32], dna[2][32];
  unsigned long long best[32];  // the slow path's (score, ~i) per row
  unsigned conn[2];             // "connected" flags of rows 0-31
};

struct Tile {
  Rows& s;
  Matches in;
  Paths out;
  int M;  // rows: a row read or written by index is checked against it

  __device__ State get(int b, int k, int r) const {
    if (k < 32)
      return {s.score[b][k], s.start[b][k], s.ham[b][k], s.depth[b][k],
              s.sh16[b][k]};
    MTB_CHECK_INDEX(r, M);
    return {out.score[r], out.start[r], out.ham[r], out.depth[r],
            out.sh16[r]};
  }
  __device__ float score(int b, int k, int r) const {
    MTB_CHECK(k < 32 || (0 <= r && r < M), r, M);
    return k < 32 ? s.score[b][k] : out.score[r];
  }
  __device__ int depth(int b, int k, int r) const {
    MTB_CHECK(k < 32 || (0 <= r && r < M), r, M);
    return k < 32 ? s.depth[b][k] : out.depth[r];
  }
  __device__ int dna(int b, int k, int r) const {
    MTB_CHECK(k < 32 || (0 <= r && r < M), r, M);
    return k < 32 ? s.dna[b][k] : in.dna[r];
  }
  // the path ending at row r, the k-th of the tile
  __device__ void put(int k, int r, const State& v) const {
    MTB_CHECK_INDEX(r, M);
    out.score[r] = v.score;
    out.start[r] = v.start;
    out.ham[r] = v.ham;
    out.depth[r] = v.depth;
    out.sh16[r] = v.sh16;
    if (k < 32) {
      s.score[1][k] = v.score;
      s.start[1][k] = v.start;
      s.ham[1][k] = v.ham;
      s.depth[1][k] = v.depth;
      s.sh16[1][k] = v.sh16;
    } else {
      out.emit[r] = false;  // its "connected" flag, until decided
    }
  }
  __device__ void connect(int b, int k, int r) const {
    MTB_CHECK(k < 32 || (0 <= r && r < M), r, M);
    if (k < 32) atomicOr(&s.conn[b], 1u << k); else out.emit[r] = true;
  }
  __device__ bool connected(int b, int k, int r) const {
    MTB_CHECK(k < 32 || (0 <= r && r < M), r, M);
    return k < 32 ? (s.conn[b] >> k) & 1 : out.emit[r];
  }
};

// first row at or after `from` whose (read, species, frame) or, if
// with_q, position quotient differs from row s's
__device__ int run_end(const Matches& in, int s, bool with_q, int from,
                       int end, int lane) {
  MTB_CHECK(0 <= s && s < end, s, end);
  int q = in.qid[s], sp = in.species[s], fr = in.frame[s];
  int pq = in.pos[s] / 3;
  for (int r0 = from; r0 < end; r0 += 32) {
    int r = r0 + lane;
    unsigned b = __ballot_sync(
        kFull, r >= end || in.qid[r] != q || in.species[r] != sp ||
                   in.frame[r] != fr || (with_q && in.pos[r] / 3 != pq));
    if (b) return r0 + __ffs(b) - 1;
  }
  return end;
}

__device__ __forceinline__ bool key_differs(const Matches& in, int r) {
  return in.qid[r] != in.qid[r - 1] || in.species[r] != in.species[r - 1] ||
         in.frame[r] != in.frame[r - 1];
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(int M, Matches in, const int32_t* __restrict__ min_depth,
             int n_species, int max_shift, int kmer_format, Paths out) {
  __shared__ Rows s_rows[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int base = (blockIdx.x * kWarps + wid) * kWindow;
  if (base >= M) return;  // the whole warp lies past the last row
  const unsigned le = kFull >> (31 - lane);  // lanes <= this one

  // rows [first, end): the blocks that start in the window
  int first = -1, last = -1;
  for (int c = 0; c < kWindow; c += 32) {
    int r = base + c + lane;
    unsigned b = __ballot_sync(kFull,
                               r < M && (r == 0 || key_differs(in, r)));
    if (b && first < 0) first = base + c + __ffs(b) - 1;
    if (b) last = base + c + 31 - __clz(b);
  }
  if (first < 0) return;
  const int end = run_end(in, last, false, base + kWindow, M, lane);

  Rows& sr = s_rows[wid];
  Tile t{sr, in, out, M};
  if (lane == 0) sr.conn[0] = sr.conn[1] = 0;
  // the carried group: rows [c_row, c_row + c_n), c_n = 0 before the first
  int c_row = 0, c_n = 0, c_q = 0, c_qid = 0, c_sp = 0, c_fr = 0;
  int c_min_d = 0;
  bool c_first = false;
  __syncwarp();

  for (int a = first; a < end;) {
    // ---- load the tile's rows, find its groups
    const int r = a + lane;
    bool live = r < end;
    int qid = 0, sp = 0, fr = 0, pos = 0, ham = 0, dna = 0, h16 = 0;
    if (live) {
      qid = in.qid[r];
      sp = in.species[r];
      fr = in.frame[r];
      pos = in.pos[r];
      ham = in.ham[r];
      dna = in.dna[r];
      h16 = in.h16[r];
    }
    const int q = pos / 3;
    int p_qid = __shfl_up_sync(kFull, qid, 1);
    int p_sp = __shfl_up_sync(kFull, sp, 1);
    int p_fr = __shfl_up_sync(kFull, fr, 1);
    int p_q = __shfl_up_sync(kFull, q, 1);
    if (lane == 0) {
      p_qid = c_qid;
      p_sp = c_sp;
      p_fr = c_fr;
      p_q = c_q;
    }
    bool nb = (lane == 0 && c_n == 0) || qid != p_qid || sp != p_sp ||
              fr != p_fr;
    bool ng = nb || q != p_q;
    // is this row the last of its group? (the next row: the next lane's,
    // or row a + 32)
    int n_qid = __shfl_down_sync(kFull, qid, 1);
    int n_sp = __shfl_down_sync(kFull, sp, 1);
    int n_fr = __shfl_down_sync(kFull, fr, 1);
    int n_q = __shfl_down_sync(kFull, q, 1);
    if (lane == 31 && r + 1 < end) {
      n_qid = in.qid[r + 1];
      n_sp = in.species[r + 1];
      n_fr = in.frame[r + 1];
      n_q = in.pos[r + 1] / 3;
    }
    bool closes = live && (r + 1 >= end || n_qid != qid || n_sp != sp ||
                           n_fr != fr || n_q != q);
    const unsigned lm = __ballot_sync(kFull, closes);
    const bool wide = lm == 0;  // the tile's first group is > 32 rows
    const int n = wide ? run_end(in, a, true, a + 32, end, lane) - a
                       : 32 - __clz(lm);
    live = wide || lane < n;
    const unsigned nbm = __ballot_sync(kFull, live && nb);
    const unsigned ngm = __ballot_sync(kFull, live && ng) | 1u;
    const int g0 = 31 - __clz(ngm & le);      // this row's group's first lane
    const int lg0 = 31 - __clz(ngm);          // the tile's last group's
    const bool first_grp = (nbm >> g0) & 1;   // the group opens its block
    MTB_CHECK(sp >= 0 && n_species > 0, sp, n_species);
    const int min_d = min_depth[sp < n_species - 1 ? sp : n_species - 1];
    const bool fwd = (fr < 3) != (kmer_format != 2);
    if (lane < n) sr.dna[1][lane] = dna;
    __syncwarp();

    // ---- this row's previous group: carried, or lanes [p0, g0)
    const int p0 = g0 ? 31 - __clz(ngm & ((1u << g0) - 1)) : 0;
    const int pq_tile = __shfl_sync(kFull, q, p0);
    const int pb = g0 ? 1 : 0, pk0 = g0 ? p0 : 0;
    const int pn = g0 ? g0 - p0 : c_n;
    const int prow = g0 ? a + p0 : c_row;
    const int shift = q - (g0 ? pq_tile : c_q);
    const bool connectable =
        !first_grp && shift >= 1 && shift <= max_shift;
    const int sh = shift < 1 ? 1 : (shift > 8 ? 8 : shift);

    // ---- connectable predecessors of each row (not for a wide tile)
    int nc = 0, par = 0;
    if (!wide && live && connectable) {
      for (int i = 0; i < pn; ++i) {
        if (!overlaps(t.dna(pb, pk0 + i, prow + i), dna, sh, fwd)) continue;
        t.connect(pb, pk0 + i, prow + i);
        ++nc;
        par = i;
      }
    }
    const bool slow = wide || __any_sync(kFull, nc > 1);
    __syncwarp();

    if (!slow) {
      // every row has at most one predecessor: pointer jumping over the
      // tile's forest; anc is the lane of the nearest unresolved ancestor
      State v;
      int anc = -1;
      if (nc == 0) {
        v = fresh(h16, pos, ham);
      } else if (pb == 0) {
        v = extend(t.get(0, par, c_row + par), h16, sh);
      } else {
        v = extend(State{0.0f, 0, 0, 0, 0}, h16, sh);
        anc = pk0 + par;
      }
      while (__any_sync(kFull, anc >= 0)) {
        int src = anc >= 0 ? anc : lane;
        float a_score = __shfl_sync(kFull, v.score, src);
        int a_start = __shfl_sync(kFull, v.start, src);
        int a_ham = __shfl_sync(kFull, v.ham, src);
        int a_depth = __shfl_sync(kFull, v.depth, src);
        int a_sh16 = __shfl_sync(kFull, v.sh16, src);
        int a_anc = __shfl_sync(kFull, anc, src);
        if (anc >= 0) {
          v = {a_score + v.score, a_start, a_ham + v.ham, a_depth + v.depth,
               a_sh16};
          anc = a_anc;
        }
      }
      if (live) t.put(lane, r, v);
    } else {
      // the tile's groups in order, lanes over (previous, current) pairs
      unsigned gm = ngm;
      while (gm) {
        const int j0 = __ffs(gm) - 1;
        gm &= gm - 1;
        const int gn = (gm ? __ffs(gm) - 1 : n) - j0;
        const int q0 = __shfl_sync(kFull, q, j0);
        const bool gfwd = __shfl_sync(kFull, (int)fwd, j0) != 0;
        const int i0 = j0 ? 31 - __clz(ngm & ((1u << j0) - 1)) : 0;
        const int iq = __shfl_sync(kFull, q, i0);
        const int gb = j0 ? 1 : 0, gk0 = j0 ? i0 : 0;
        const int gpn = j0 ? j0 - i0 : c_n;
        const int gprow = j0 ? a + i0 : c_row;
        const int gshift = q0 - (j0 ? iq : c_q);
        const bool gconn = !((nbm >> j0) & 1) && gshift >= 1 &&
                           gshift <= max_shift;
        const int gsh = gshift < 1 ? 1 : (gshift > 8 ? 8 : gshift);
        for (int jc = 0; jc < gn; jc += 32) {
          const int cw = gn - jc < 32 ? gn - jc : 32;
          sr.best[lane] = 0;
          __syncwarp();
          if (gconn) {
            for (int p = lane; p < gpn * cw; p += 32) {
              int i = p / cw, k = j0 + jc + p % cw;
              if (!overlaps(t.dna(gb, gk0 + i, gprow + i), t.dna(1, k, a + k),
                            gsh, gfwd))
                continue;
              t.connect(gb, gk0 + i, gprow + i);
              float si = t.score(gb, gk0 + i, gprow + i);
              if (si > 0.0f)
                atomicMax(&sr.best[k - j0 - jc],
                          ((unsigned long long)__float_as_uint(si) << 32) |
                              (kFull - (unsigned)i));
            }
          }
          __syncwarp();
          const int k = j0 + jc + lane, src = k < 31 ? k : 31;
          int hj = __shfl_sync(kFull, h16, src);
          int pj = __shfl_sync(kFull, pos, src);
          int mj = __shfl_sync(kFull, ham, src);
          if (lane < cw) {
            if (k >= 32) {
              MTB_CHECK_INDEX(a + k, M);
              hj = in.h16[a + k];
              pj = in.pos[a + k];
              mj = in.ham[a + k];
            }
            unsigned long long b = sr.best[lane];
            State v;
            if (b) {
              int i = (int)(kFull - (unsigned)b);
              v = extend(t.get(gb, gk0 + i, gprow + i), hj, gsh);
            } else {
              v = fresh(hj, pj, mj);
            }
            t.put(k, a + k, v);
          }
          __syncwarp();
        }
      }
    }
    __syncwarp();

    // ---- emit flags. The carried group ends its block unless row a
    // continues it; then its rows that connected to nothing end paths.
    if (c_n > 0) {
      const bool cont = !(nbm & 1);
      for (int k = lane; k < c_n; k += 32) {
        int rr = c_row + k;
        int d = t.depth(0, k, rr);
        MTB_CHECK_INDEX(rr, M);
        out.emit[rr] = d >= c_min_d && (cont ? !t.connected(0, k, rr)
                                             : !c_first);
      }
    }
    // rows of the tile's other groups (their successor is in the tile)
    if (lane < lg0) {
      const int g1 = __ffs(ngm & ~le) - 1;  // the next group's first lane
      const bool cont = !((nbm >> g1) & 1);
      int d = sr.depth[1][lane];
      out.emit[r] = d >= min_d && (cont ? !((sr.conn[1] >> lane) & 1)
                                        : !first_grp);
    }

    // ---- carry the tile's last group
    const int cn = n - lg0;
    const bool mv = lane < cn && lg0 + lane < 32;
    State v;
    int vd = 0;
    if (mv) {
      v = t.get(1, lg0 + lane, 0);
      vd = sr.dna[1][lg0 + lane];
    }
    c_q = __shfl_sync(kFull, q, lg0);
    c_qid = __shfl_sync(kFull, qid, lg0);
    c_sp = __shfl_sync(kFull, sp, lg0);
    c_fr = __shfl_sync(kFull, fr, lg0);
    c_min_d = __shfl_sync(kFull, min_d, lg0);
    c_first = (nbm >> lg0) & 1;
    c_row = a + lg0;
    c_n = cn;
    __syncwarp();
    if (mv) {
      sr.score[0][lane] = v.score;
      sr.start[0][lane] = v.start;
      sr.ham[0][lane] = v.ham;
      sr.depth[0][lane] = v.depth;
      sr.sh16[0][lane] = v.sh16;
      sr.dna[0][lane] = vd;
    }
    if (lane == 0) sr.conn[0] = sr.conn[1] = 0;
    a += n;
    __syncwarp();
  }
  // the last carried group ends its block
  for (int k = lane; k < c_n; k += 32) {
    int rr = c_row + k;
    MTB_CHECK_INDEX(rr, M);
    out.emit[rr] = !c_first && t.depth(0, k, rr) >= c_min_d;
  }
}

}  // namespace

extern "C" int mtb_chain_matches(int M, const int32_t* qid,
                                 const int32_t* species, const int32_t* frame,
                                 const int32_t* pos, const int32_t* ham,
                                 const int32_t* dna, const int32_t* h16,
                                 const int32_t* min_depth, int n_species,
                                 int max_shift, int kmer_format,
                                 float* p_score, int32_t* p_start,
                                 int32_t* p_ham, int32_t* p_depth,
                                 int32_t* p_sh16, bool* emit,
                                 cudaStream_t stream) {
  Matches in{qid, species, frame, pos, ham, dna, h16};
  Paths out{p_score, p_start, p_ham, p_depth, p_sh16, emit};
  int64_t rows_per_cta = (int64_t)kWarps * kWindow;
  int blocks = (int)(((int64_t)M + rows_per_cta - 1) / rows_per_cta);
  chain_kernel<<<blocks, kThreads, 0, stream>>>(
      M, in, min_depth, n_species, max_shift, kmer_format, out);
  return (int)cudaGetLastError();
}
