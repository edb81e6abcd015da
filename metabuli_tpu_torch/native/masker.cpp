// tantan-style low-complexity masking (Frith 2011), native implementation.
//
// Re-provides the masking used by the reference at DB build time
// (`/root/reference/src/commons/SeqIterator.cpp:154-175`): an HMM with one
// background state and `max_cycle` repeat states (offsets 1..C), transition
// constants repeatProb=0.005, repeatEndProb=0.05, offsetProbDecay=0.9, no
// gap states, masking positions whose posterior repeat probability reaches
// minMaskProb. Emission likelihood ratios come from a match/mismatch
// nucleotide matrix (MMseqs2 NucleotideMatrix semantics: exp(lambda*score)
// with lambda solving the standard Karlin-Altschul constraint).
//
// Forward-backward is computed in chunks with overlap so memory stays
// bounded for chromosome-scale sequences.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Model {
  int C;
  double b2b;
  std::vector<double> b2r;  // per offset
  double r2r;
  double r2b;
  double match_ratio;
  double mismatch_ratio;
};

// Forward-backward over [begin, end) of seq; out_prob gets posterior repeat
// probability per position.
static void fb_chunk(const uint8_t* seq, int64_t begin, int64_t end,
                     const Model& mdl, double* out_prob) {
  const int C = mdl.C;
  const int64_t len = end - begin;
  if (len <= 0) return;
  // forward matrices stored per position: [len][C] repeat states + [len] bg
  // (double precision: the posterior threshold compare must match the
  // full-sequence double forward-backward oracle bit-for-bit)
  std::vector<double> fr((size_t)len * C);
  std::vector<double> fb(len);
  std::vector<double> scale(len);

  auto ratio = [&](int64_t i, int c) -> double {
    int64_t j = i - c;
    if (j < 0) return 1.0;
    uint8_t a = seq[i], b = seq[j];
    if (a > 3 || b > 3) return 1.0;
    return a == b ? mdl.match_ratio : mdl.mismatch_ratio;
  };

  std::vector<double> cur_r(C, 0.0);
  double cur_b = 1.0;
  for (int64_t i = 0; i < len; ++i) {
    int64_t gi = begin + i;
    double sum_r_to_b = 0.0;
    for (int c = 0; c < C; ++c) sum_r_to_b += cur_r[c];
    double nb = cur_b * mdl.b2b + sum_r_to_b * mdl.r2b;
    double total = nb;
    for (int c = 0; c < C; ++c) {
      double nr = (cur_b * mdl.b2r[c] + cur_r[c] * mdl.r2r) * ratio(gi, c + 1);
      cur_r[c] = nr;
      total += nr;
    }
    cur_b = nb;
    double inv = total > 0 ? 1.0 / total : 1.0;
    cur_b *= inv;
    for (int c = 0; c < C; ++c) cur_r[c] *= inv;
    fb[i] = cur_b;
    for (int c = 0; c < C; ++c) fr[(size_t)i * C + c] = cur_r[c];
    scale[i] = inv;
  }

  // backward
  std::vector<double> bb_r(C, 1.0);
  double bb_b = 1.0;
  for (int64_t i = len - 1; i >= 0; --i) {
    int64_t gi = begin + i;
    // posterior at i uses beta BEFORE absorbing transition at i+1
    double denom = fb[i] * bb_b;
    double rep = 0.0;
    for (int c = 0; c < C; ++c) {
      denom += fr[(size_t)i * C + c] * bb_r[c];
      rep += fr[(size_t)i * C + c] * bb_r[c];
    }
    out_prob[i] = denom > 0 ? rep / denom : 0.0;
    if (i == 0) break;
    // compute beta for position i-1: transitions into i's states, emission
    // ratios at i, then the scale factor applied at i in the forward pass
    std::vector<double> e(C);
    for (int c = 0; c < C; ++c) e[c] = ratio(gi, c + 1) * bb_r[c];
    double nb = mdl.b2b * bb_b;
    for (int c = 0; c < C; ++c) nb += mdl.b2r[c] * e[c];
    for (int c = 0; c < C; ++c) {
      bb_r[c] = (mdl.r2b * bb_b + mdl.r2r * e[c]) * scale[i];
    }
    bb_b = nb * scale[i];
  }
}

}  // namespace

extern "C" {

// Solve sum p_a p_b exp(lambda*s_ab) = 1 for uniform p=0.25,
// match/mismatch scores; returns lambda by bisection.
double tantan_lambda(double match_score, double mismatch_score) {
  double lo = 1e-6, hi = 10.0;
  for (int iter = 0; iter < 200; ++iter) {
    double mid = 0.5 * (lo + hi);
    double v = 0.25 * std::exp(match_score * mid) +
               0.75 * std::exp(mismatch_score * mid);
    if (v > 1.0)
      hi = mid;
    else
      lo = mid;
  }
  return 0.5 * (lo + hi);
}

// seq_codes: 0..3 bases, anything >3 neutral. out_mask: 1 = masked.
void tantan_mask(const uint8_t* seq_codes, int64_t len, int32_t max_cycle,
                 double repeat_prob, double repeat_end_prob, double decay,
                 double min_mask_prob, double match_score,
                 double mismatch_score, uint8_t* out_mask) {
  Model mdl;
  mdl.C = max_cycle;
  mdl.r2b = repeat_end_prob;
  mdl.r2r = 1.0 - repeat_end_prob;
  mdl.b2b = 1.0 - repeat_prob;
  mdl.b2r.resize(max_cycle);
  double norm = 0.0;
  double p = 1.0;
  for (int c = 0; c < max_cycle; ++c) {
    p *= decay;
    mdl.b2r[c] = p;
    norm += p;
  }
  for (int c = 0; c < max_cycle; ++c) mdl.b2r[c] *= repeat_prob / norm;
  double lambda = tantan_lambda(match_score, mismatch_score);
  mdl.match_ratio = std::exp(match_score * lambda);
  mdl.mismatch_ratio = std::exp(mismatch_score * lambda);

  const int64_t CHUNK = 1 << 16;
  const int64_t OVERLAP = 4096;
  std::vector<double> prob;
  for (int64_t begin = 0; begin < len; begin += CHUNK) {
    int64_t cs = begin == 0 ? 0 : begin - OVERLAP;
    int64_t ce = std::min(len, begin + CHUNK);
    prob.assign(ce - cs, 0.f);
    fb_chunk(seq_codes, cs, ce, mdl, prob.data());
    for (int64_t i = begin; i < ce; ++i)
      out_mask[i] = prob[i - cs] >= min_mask_prob ? 1 : 0;
  }
}

}  // extern "C"
