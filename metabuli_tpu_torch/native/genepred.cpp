// Native gene prediction for database construction.
//
// The reference restricts target k-mer extraction to predicted coding
// frames via a vendored Prodigal 2.6.3 port plus "extended ORF" blocks
// (/root/reference/src/commons/IndexCreator.cpp:1128-1218,
//  ProdigalWrapper.cpp:344-560). Prodigal's metagenomic training data is
// not vendored (lib/prodigal/training.cpp is a missing blob), so a
// bit-exact port is impossible from this checkout; this module implements
// a self-training gene predictor of the same family (long-ORF seeding ->
// hexamer log-odds -> iterative refinement -> overlap-resolving DP), and
// EXACT reimplementations of the surrounding machinery whose semantics are
// fully specified in the reference:
//   * XXH64 (from the published xxHash spec; used by min-hash + 23-mers)
//   * bottom-3000 min-hash strandedness sketch (SeqIterator.cpp:65-112)
//   * intergenic 23-mer list (SeqIterator.cpp:114-152)
//   * extended-ORF block computation (ProdigalWrapper.cpp:344-560),
//     including the frame-snapping and first/last-gene edge cases.
//
// Exposed via a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

// ----------------------------------------------------------------- xxh64
// Implemented from the xxHash64 specification (Yann Collet, public spec).
static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/ARM LE)
}
static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const void* data, size_t len, uint64_t seed) {
  const uint8_t* p = (const uint8_t*)data;
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t a1 = seed + P1 + P2, a2 = seed + P2, a3 = seed, a4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      a1 = xxh_round(a1, read64(p));
      a2 = xxh_round(a2, read64(p + 8));
      a3 = xxh_round(a3, read64(p + 16));
      a4 = xxh_round(a4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(a1, 1) + rotl64(a2, 7) + rotl64(a3, 12) + rotl64(a4, 18);
    h = (h ^ xxh_round(0, a1)) * P1 + P4;
    h = (h ^ xxh_round(0, a2)) * P1 + P4;
    h = (h ^ xxh_round(0, a3)) * P1 + P4;
    h = (h ^ xxh_round(0, a4)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------- base utilities
// Complement table over raw characters (iRCT semantics restricted to the
// canonical alphabet; non-ACGT stays as-is for hashing parity with iRCT's
// IUPAC complements where relevant: use the reference's iRCT mapping).
char irct(char c) {
  switch (c) {
    case 'A': return 'T'; case 'T': return 'A';
    case 'G': return 'C'; case 'C': return 'G';
    case 'a': return 't'; case 't': return 'a';
    case 'g': return 'c'; case 'c': return 'g';
    // IUPAC complements per the reference iRCT string (GeneticCode.h:14-17)
    case 'B': return 'V'; case 'V': return 'B';
    case 'D': return 'H'; case 'H': return 'D';
    case 'K': return 'M'; case 'M': return 'K';
    case 'R': return 'Y'; case 'Y': return 'R';
    case 'S': return 'S'; case 'W': return 'W';
    case 'N': return 'N';
    default: return '.';
  }
}

static inline int base_code(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': case 'U': case 'u': return 3;
    default: return 4;
  }
}

// ------------------------------------------------------------ gene model
struct Gene {
  int32_t begin;   // 1-based inclusive, begin < end (prodigal convention)
  int32_t end;     // 1-based inclusive
  int32_t strand;  // +1 / -1
  double score;
};

struct Model {
  // hexamer log-odds over 4^6 in-frame 6-mers (codon-phase step of 3)
  std::vector<float> hex_logodds;  // 4096
  double start_w[3];               // ATG, GTG, TTG log weights
  bool trained = false;
};

std::mutex g_mu;
std::map<int64_t, Model> g_models;
int64_t g_next_id = 1;

static inline bool is_stop(int c1, int c2, int c3) {
  // TAA, TAG, TGA
  return c1 == 3 && ((c2 == 0 && (c3 == 0 || c3 == 2)) || (c2 == 2 && c3 == 0));
}
static inline int start_type(int c1, int c2, int c3) {
  if (c2 == 3 && c3 == 2) {  // _TG
    if (c1 == 0) return 0;   // ATG
    if (c1 == 2) return 1;   // GTG
    if (c1 == 3) return 2;   // TTG
  }
  return -1;
}

struct Cand {
  int begin, end;  // 0-based inclusive forward coords of the coding region
  int strand;
  int start_off;   // offset of start codon within the oriented ORF
  double score;
};

// Collect candidate genes (oriented ORFs with a chosen start) on one strand
// of the encoded sequence. codes = forward 0..4; for strand -1 the caller
// passes the reverse-complement encoding and coords are mapped back.
void collect_orfs(const std::vector<int8_t>& codes, int strand, int seq_len,
                  std::vector<Cand>& out, int min_len) {
  int n = (int)codes.size();
  for (int f = 0; f < 3; f++) {
    int orf_start = f;  // first in-frame position after the previous stop
    int first_start = -1;
    for (int i = f; i + 2 < n; i += 3) {
      int c1 = codes[i], c2 = codes[i + 1], c3 = codes[i + 2];
      bool bad = c1 > 3 || c2 > 3 || c3 > 3;
      if (bad) {  // N resets the ORF like a stop
        orf_start = i + 3;
        first_start = -1;
        continue;
      }
      if (first_start < 0 && start_type(c1, c2, c3) >= 0) first_start = i;
      if (is_stop(c1, c2, c3)) {
        if (first_start >= 0) {
          int b = first_start, e = i + 2;  // include the stop codon
          if (e - b + 1 >= min_len) {
            Cand c;
            if (strand > 0) {
              c.begin = b;
              c.end = e;
            } else {  // map oriented coords back to forward coords
              c.begin = seq_len - 1 - e;
              c.end = seq_len - 1 - b;
            }
            c.strand = strand;
            c.start_off = b;
            c.score = 0.0;
            out.push_back(c);
          }
        }
        orf_start = i + 3;
        first_start = -1;
      }
    }
    (void)orf_start;
  }
}

double score_orf(const Model& m, const std::vector<int8_t>& codes, int b,
                 int e) {
  // sum of in-frame hexamer log-odds over the coding region (codon steps)
  double s = 0.0;
  for (int i = b; i + 5 <= e; i += 3) {
    int h = 0;
    bool bad = false;
    for (int j = 0; j < 6; j++) {
      int c = codes[i + j];
      if (c > 3) { bad = true; break; }
      h = h * 4 + c;
    }
    if (!bad) s += m.hex_logodds[h];
  }
  int st = start_type(codes[b], codes[b + 1], codes[b + 2]);
  if (st >= 0) s += m.start_w[st];
  return s;
}

void count_hexamers(const std::vector<int8_t>& codes, int b, int e, int step,
                    std::vector<double>& counts) {
  for (int i = b; i + 5 <= e; i += step) {
    int h = 0;
    bool bad = false;
    for (int j = 0; j < 6; j++) {
      int c = codes[i + j];
      if (c > 3) { bad = true; break; }
      h = h * 4 + c;
    }
    if (!bad) counts[h] += 1.0;
  }
}

std::vector<int8_t> encode(const char* seq, int64_t len) {
  std::vector<int8_t> codes(len);
  for (int64_t i = 0; i < len; i++) codes[i] = (int8_t)base_code(seq[i]);
  return codes;
}

std::vector<int8_t> revcomp_codes(const std::vector<int8_t>& c) {
  std::vector<int8_t> r(c.size());
  for (size_t i = 0; i < c.size(); i++) {
    int8_t v = c[c.size() - 1 - i];
    r[i] = v > 3 ? 4 : (int8_t)(3 - v);
  }
  return r;
}

// Oriented view of a candidate for scoring: forward cands score on fwd
// codes at [begin, end]; reverse cands score on the revcomp codes.
double score_cand(const Model& m, const std::vector<int8_t>& fwd,
                  const std::vector<int8_t>& rev, const Cand& c) {
  int n = (int)fwd.size();
  if (c.strand > 0) return score_orf(m, fwd, c.begin, c.end);
  return score_orf(m, rev, n - 1 - c.end, n - 1 - c.begin);
}

void train_model(Model& m, const std::vector<int8_t>& fwd) {
  std::vector<int8_t> rev = revcomp_codes(fwd);
  std::vector<Cand> cands;
  collect_orfs(fwd, +1, (int)fwd.size(), cands, 90);
  collect_orfs(rev, -1, (int)fwd.size(), cands, 90);

  // background: all-frame hexamer composition of both strands
  std::vector<double> bg(4096, 0.25);  // Laplace-ish prior
  count_hexamers(fwd, 0, (int)fwd.size() - 1, 1, bg);
  count_hexamers(rev, 0, (int)rev.size() - 1, 1, bg);

  // seed: long ORFs are almost always genes in prokaryotes
  std::vector<double> fg(4096, 0.25);
  int seeds = 0;
  for (const Cand& c : cands) {
    if (c.end - c.begin + 1 >= 600) {
      const std::vector<int8_t>& v = c.strand > 0 ? fwd : rev;
      int b = c.strand > 0 ? c.begin : (int)fwd.size() - 1 - c.end;
      int e = c.strand > 0 ? c.end : (int)fwd.size() - 1 - c.begin;
      count_hexamers(v, b, e, 3, fg);
      seeds++;
    }
  }
  if (seeds == 0) {  // fall back: seed with every candidate ORF
    for (const Cand& c : cands) {
      const std::vector<int8_t>& v = c.strand > 0 ? fwd : rev;
      int b = c.strand > 0 ? c.begin : (int)fwd.size() - 1 - c.end;
      int e = c.strand > 0 ? c.end : (int)fwd.size() - 1 - c.begin;
      count_hexamers(v, b, e, 3, fg);
    }
  }

  auto finish_logodds = [&](const std::vector<double>& f) {
    double fs = 0, bs = 0;
    for (int i = 0; i < 4096; i++) { fs += f[i]; bs += bg[i]; }
    m.hex_logodds.assign(4096, 0.f);
    for (int i = 0; i < 4096; i++)
      m.hex_logodds[i] = (float)std::log((f[i] / fs) / (bg[i] / bs));
  };
  finish_logodds(fg);
  m.start_w[0] = std::log(0.7);
  m.start_w[1] = std::log(0.2);
  m.start_w[2] = std::log(0.1);

  // one refinement round: re-estimate from positively scoring ORFs
  std::vector<double> fg2(4096, 0.25);
  int kept = 0;
  for (const Cand& c : cands) {
    if (score_cand(m, fwd, rev, c) > 0.0) {
      const std::vector<int8_t>& v = c.strand > 0 ? fwd : rev;
      int b = c.strand > 0 ? c.begin : (int)fwd.size() - 1 - c.end;
      int e = c.strand > 0 ? c.end : (int)fwd.size() - 1 - c.begin;
      count_hexamers(v, b, e, 3, fg2);
      kept++;
    }
  }
  if (kept > 0) finish_logodds(fg2);
  m.trained = true;
}

// Overlap-resolving selection: sort by begin; greedy-DP keeping the best
// scoring compatible set; overlaps up to 60 nt are tolerated (operon-style
// overlaps, cf. Prodigal's dprog overlap allowances).
std::vector<Gene> select_genes(std::vector<Cand>& cands,
                               const std::vector<int8_t>& fwd,
                               const std::vector<int8_t>& rev,
                               const Model& m) {
  std::vector<Cand> pos;
  for (Cand& c : cands) {
    c.score = score_cand(m, fwd, rev, c);
    if (c.score > 0.0) pos.push_back(c);
  }
  std::sort(pos.begin(), pos.end(),
            [](const Cand& a, const Cand& b) { return a.end < b.end; });
  int n = (int)pos.size();
  std::vector<double> dp(n + 1, 0.0);
  std::vector<int> take(n + 1, 0), prev(n + 1, 0);
  const int OV = 60;
  for (int i = 1; i <= n; i++) {
    // last j with pos[j-1].end <= pos[i-1].begin - 1 + OV
    int lo = 0, hi = i - 1;
    int limit = pos[i - 1].begin - 1 + OV;
    while (lo < hi) {
      int mid = (lo + hi + 1) >> 1;
      if (pos[mid - 1].end <= limit) lo = mid;
      else hi = mid - 1;
    }
    double with = dp[lo] + pos[i - 1].score;
    if (with > dp[i - 1]) {
      dp[i] = with;
      take[i] = 1;
      prev[i] = lo;
    } else {
      dp[i] = dp[i - 1];
      take[i] = 0;
      prev[i] = i - 1;
    }
  }
  std::vector<Gene> out;
  for (int i = n; i > 0; i = prev[i]) {
    if (take[i]) {
      const Cand& c = pos[i - 1];
      out.push_back({c.begin + 1, c.end + 1, c.strand, c.score});
    }
    if (!take[i]) { /* prev[i] = i-1 */ }
  }
  std::sort(out.begin(), out.end(),
            [](const Gene& a, const Gene& b) { return a.begin < b.begin; });
  // removeCompletelyOverlappingGenes (ProdigalWrapper.cpp capability):
  // drop genes fully contained in the previous one
  std::vector<Gene> fin;
  for (const Gene& g : out) {
    if (!fin.empty() && g.end <= fin.back().end) continue;
    fin.push_back(g);
  }
  return fin;
}

}  // namespace

extern "C" {

uint64_t gp_xxh64(const char* data, int64_t len, uint64_t seed) {
  return xxh64(data, (size_t)len, seed);
}

int64_t gp_train(const char* seq, int64_t len) {
  Model m;
  train_model(m, encode(seq, len));
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t id = g_next_id++;
  g_models[id] = std::move(m);
  return id;
}

void gp_free(int64_t model) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_models.erase(model);
}

// Predict genes; returns the gene count (<= capacity written).
int64_t gp_predict(int64_t model, const char* seq, int64_t len,
                   int32_t* out_begin, int32_t* out_end, int32_t* out_strand,
                   int64_t capacity) {
  Model* m;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_models.find(model);
    if (it == g_models.end()) return -1;
    m = &it->second;
  }
  std::vector<int8_t> fwd = encode(seq, len);
  std::vector<int8_t> rev = revcomp_codes(fwd);
  std::vector<Cand> cands;
  collect_orfs(fwd, +1, (int)len, cands, 90);
  collect_orfs(rev, -1, (int)len, cands, 90);
  std::vector<Gene> genes = select_genes(cands, fwd, rev, *m);
  int64_t n = std::min<int64_t>((int64_t)genes.size(), capacity);
  for (int64_t i = 0; i < n; i++) {
    out_begin[i] = genes[i].begin;
    out_end[i] = genes[i].end;
    out_strand[i] = genes[i].strand;
  }
  return (int64_t)genes.size();
}

// Bottom-`cap` min-hash sketch of 24-mers (SeqIterator::getMinHashList,
// SeqIterator.cpp:88-112). Matches the reference exactly, including the
// UINT64_MAX sentinel occupying one slot until the queue first overflows —
// so `out` MUST hold `cap + 1` entries and the returned count can be
// cap + 1 (callers: db/genes.py allocates MINHASH_CAP + 1).
int64_t gp_minhash(const char* seq, int64_t len, uint64_t* out, int64_t cap) {
  const int k = 24;
  std::vector<uint64_t> heap;  // max-heap
  heap.push_back(UINT64_MAX);
  std::make_heap(heap.begin(), heap.end());
  int64_t que_len = 0;
  for (int64_t i = 0; i + k - 1 < len; i++) {
    uint64_t h = xxh64(seq + i, k, 0);
    if (h < heap.front()) {
      if (que_len < cap) {
        heap.push_back(h);
        std::push_heap(heap.begin(), heap.end());
        que_len++;
      } else {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = h;
        std::push_heap(heap.begin(), heap.end());
      }
    }
  }
  std::sort_heap(heap.begin(), heap.end());  // ascending
  int64_t n = (int64_t)heap.size();
  for (int64_t i = 0; i < n; i++) out[i] = heap[i];
  return n;
}

// compareMinHashList (SeqIterator.cpp:65-86): both lists descending-merged;
// identical count must exceed size1 * (len2/len1) * 0.5.
int32_t gp_minhash_same_strand(const uint64_t* l1, int64_t n1,
                               const uint64_t* l2, int64_t n2,
                               int64_t len1, int64_t len2) {
  float ratio = (float)len2 / (float)len1;
  float identical = 0;
  float size1 = (float)n1;
  // walk from the largest down (lists are ascending)
  int64_t i = n1 - 1, j = n2 - 1;
  while (i >= 0 && j >= 0) {
    if (l1[i] == l2[j]) {
      identical++;
      i--;
      j--;
    } else if (l1[i] > l2[j]) {
      i--;
    } else {
      j--;
    }
  }
  return identical > size1 * ratio * 0.5f ? 1 : 0;
}

// Intergenic 23-mer list from predicted genes
// (SeqIterator::generateIntergenicKmerList, SeqIterator.cpp:114-152).
int64_t gp_intergenic_kmers(const char* seq, int64_t len,
                            const int32_t* begin, const int32_t* end,
                            const int32_t* strand, int64_t n_genes,
                            uint64_t* out, int64_t cap) {
  if (n_genes == 0) return 0;
  const int k = 23;
  int64_t cnt = 0;
  char buf[24];
  auto push_kmer = [&](int64_t at, int32_t str) {
    if (at < 0 || at + k > len || cnt >= cap) return;
    if (str == 1) {
      memcpy(buf, seq + at, k);
    } else {
      for (int j = k - 1; j >= 0; j--) buf[k - 1 - j] = irct(seq[at + j]);
    }
    out[cnt++] = xxh64(buf, k, 0);
  };
  int64_t first_begin = begin[0] - 1;
  if (first_begin > k - 1) push_kmer(first_begin - k, strand[0]);
  for (int64_t i = 0; i < n_genes; i++) push_kmer(end[i], strand[i]);
  return cnt;
}

// Extended-ORF blocks (ProdigalWrapper::getExtendedORFs,
// ProdigalWrapper.cpp:344-560). `inter` is the running intergenic 23-mer
// list (in/out, capacity inter_cap); returns the block count. Blocks are
// (start, end, strand) with 0-based inclusive coords like SequenceBlock.
int64_t gp_extended_orfs(const char* seq, int64_t len, const int32_t* begin,
                         const int32_t* end, const int32_t* strand,
                         int64_t n_genes, uint64_t* inter, int64_t* n_inter,
                         int64_t inter_cap, int32_t* blk_start,
                         int32_t* blk_end, int32_t* blk_strand,
                         int64_t blk_cap) {
  int64_t nb = 0;
  auto emit = [&](int64_t s, int64_t e, int32_t st) {
    if (nb < blk_cap) {
      blk_start[nb] = (int32_t)s;
      blk_end[nb] = (int32_t)e;
      blk_strand[nb] = st;
      nb++;
    }
  };
  if (n_genes == 0) {
    emit(0, len - 1, 1);
    return nb;
  }
  const int k = 23;
  char buf[24];
  auto hash_at = [&](int64_t at, bool reverse) -> uint64_t {
    // caller guarantees at >= 0 && at + k <= len for interior genes
    if (at < 0) at = 0;
    if (at + k > len) at = len - k;
    if (!reverse) {
      memcpy(buf, seq + at, k);
    } else {
      for (int j = k - 1; j >= 0; j--) buf[k - 1 - j] = irct(seq[at + j]);
    }
    return xxh64(buf, k, 0);
  };
  auto in_list = [&](uint64_t h) {
    for (int64_t i = 0; i < *n_inter; i++)
      if (inter[i] == h) return true;
    return false;
  };
  auto add_list = [&](uint64_t h) {
    if (!in_list(h) && *n_inter < inter_cap) inter[(*n_inter)++] = h;
  };

  int64_t frame, left_end, right_end;
  if (n_genes == 1) {
    if (strand[0] == 1) {
      frame = (begin[0] - 1) % 3;
      left_end = 0;
      while (left_end % 3 != frame) left_end++;
      emit(left_end, len - 1, 1);
    } else {
      frame = (end[0] - 1) % 3;
      right_end = len - 1;
      while (right_end % 3 != frame) right_end--;
      emit(0, right_end, -1);
    }
    return nb;
  }

  bool extended_left = false;
  bool is_reverse = false;
  uint64_t left_hash = 0, right_hash = 0;

  // first gene: extend across the leading region to the second gene
  if (strand[0] == 1) {
    frame = (begin[0] - 1) % 3;
    left_end = 0;
    while (left_end % 3 != frame) left_end++;
    emit(left_end, begin[1] - 1 + 22, 1);
  } else {
    frame = (end[0] - 1) % 3;
    right_end = begin[1] - 1 + 22;
    while (right_end % 3 != frame) right_end--;
    emit(0, right_end, -1);
  }

  for (int64_t g = 1; g < n_genes - 1; g++) {
    is_reverse = strand[g] != 1;
    left_hash = hash_at(begin[g] - 1 - k, is_reverse);
    right_hash = hash_at(end[g], is_reverse);

    if (in_list(left_hash)) {  // extend left
      if (!extended_left) {
        emit(begin[g] - 1, end[g] - 1, is_reverse ? -1 : 1);
      } else {
        if (!is_reverse) {
          frame = (begin[g] - 1) % 3;
          left_end = end[g - 1] - 1 - 22;
          while (left_end % 3 != frame) left_end++;
          emit(left_end, end[g] - 1, 1);
        } else {
          emit(end[g - 1] - 22 - 1, end[g] - 1, -1);
        }
      }
      extended_left = true;
    } else {  // extend right
      if (extended_left) {
        if (!is_reverse) {
          frame = (begin[g] - 1) % 3;
          left_end = end[g - 1] - 1 - 22;
          while (left_end % 3 != frame) left_end++;
          emit(left_end, begin[g + 1] - 1 + 22, 1);
        } else {
          frame = (end[g] - 1) % 3;
          right_end = begin[g + 1] - 1 + 22;
          while (right_end % 3 != frame) right_end--;
          emit(end[g - 1] - 1 - 22, right_end, -1);
        }
      } else {
        if (!is_reverse) {
          emit(begin[g] - 1, begin[g + 1] - 1 + 22, 1);
        } else {
          frame = (end[g] - 1) % 3;
          right_end = begin[g + 1] - 1 + 22;
          while (right_end % 3 != frame) right_end--;
          emit(begin[g] - 1, right_end, -1);
        }
      }
      extended_left = false;
      add_list(right_hash);
    }
  }

  // last gene. NOTE: the reference reuses leftKmerHash/rightKmerHash and
  // isReverse from the LAST loop iteration (the second-to-last gene) here
  // without recomputing them for the last gene — and with n_genes == 2 the
  // loop never ran, leaving zero hashes and isReverse == false
  // (ProdigalWrapper.cpp:507-560). Replicated verbatim for parity.
  int64_t g = n_genes - 1;
  if (in_list(left_hash)) {  // extend left
    if (!is_reverse) {
      frame = (begin[g] - 1) % 3;
      left_end = end[g - 1] - 1 - 22;
      while (left_end % 3 != frame) left_end++;
      emit(left_end, len - 1, 1);
    } else {
      frame = (end[g] - 1) % 3;
      right_end = len - 1;
      while (right_end % 3 != frame) right_end--;
      emit(end[g - 1] - 22 - 1, right_end, -1);
    }
  } else {  // extend right
    if (extended_left) {
      if (!is_reverse) {
        frame = (begin[g] - 1) % 3;
        left_end = end[g - 1] - 1 - 22;
        while (left_end % 3 != frame) left_end++;
        emit(left_end, len - 1, 1);
      } else {
        frame = (end[g] - 1) % 3;
        right_end = len - 1;
        while (right_end % 3 != frame) right_end--;
        emit(end[g - 1] - 22 - 1, right_end, -1);
      }
    } else {
      if (!is_reverse) {
        emit(begin[g], len - 1, 1);
      } else {
        frame = (end[g] - 1) % 3;
        right_end = len - 1;
        while (right_end % 3 != frame) right_end--;
        emit(begin[g] - 1, right_end, -1);
      }
    }
    add_list(right_hash);
  }
  return nb;
}

}  // extern "C"
