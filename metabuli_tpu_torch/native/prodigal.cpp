// Bit-exact port of the reference's single-genome gene-prediction pipeline
// (the vendored Prodigal "single" mode driven by ProdigalWrapper:
// `/root/reference/src/commons/ProdigalWrapper.cpp:54-127,188-257`, algorithm
// files `/root/reference/lib/prodigal/{node,dprog,gene,prodigalsequence}.cpp`).
//
// This is a re-implementation, not a copy: the per-site data lives in
// structure-of-arrays form, sequences are plain 2-bit code arrays instead of
// bit-packed bitmaps, and control flow is reorganized — but every arithmetic
// expression (including float casts, accumulation order, comparison
// tie-breaks and libm calls) follows the reference exactly so the trained
// model and the predicted gene coordinates are bit-identical. Locked by
// tests/test_prodigal_port.py against the compiled reference oracle.
//
// Scope: single mode only (trans_table 11, closed = 1, no N-masking — the
// wrapper's fixed configuration). The metagenomic models are absent from the
// reference checkout, so meta mode has no oracle and stays with the
// self-training predictor in genepred.cpp.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace pdg {

// ---------------------------------------------------------------- constants
constexpr double kMetaPen = 7.5;    // META_PEN (node.h:37)
constexpr int kMinGene = 90;        // MIN_GENE
constexpr int kMinEdgeGene = 60;    // MIN_EDGE_GENE
constexpr int kMaxSameOvlp = 60;    // MAX_SAM_OVLP
constexpr int kOperDist = 60;       // OPER_DIST
constexpr double kEdgeBonus = 0.74; // EDGE_BONUS
constexpr double kEdgeUps = -1.00;  // EDGE_UPS
constexpr int kWindow = 120;        // WINDOW (GC frame plot)
constexpr int kMaxOppOvlp = 200;    // MAX_OPP_OVLP
constexpr int kMaxNodeDist = 300;   // MAX_NODE_DIST
constexpr int kTypeAtg = 0, kTypeGtg = 1, kTypeTtg = 2, kTypeStop = 3;

// --------------------------------------------------------------- sequences
// Base codes match the bitmap's 2-bit layout read by mer_ndx
// (`prodigalsequence.cpp:608-612`): A=0, G=1, C=2, T=3; every non-ACGT byte
// encodes as C(2) (`ProdigalWrapper::getNextSeq`), on both strands.
struct Seq {
  std::vector<uint8_t> code;   // forward codes
  std::vector<uint8_t> rcode;  // reverse-complement codes
  int len = 0;
  double gc = 0.0;             // fraction of G/C bytes among accepted bytes
};

inline void encode_seq(const unsigned char* raw, int64_t n, Seq& s) {
  s.code.clear();
  s.code.reserve(n);
  long gc_cont = 0;
  for (int64_t i = 0; i < n; i++) {
    unsigned char b = raw[i];
    if (b < 'A' || b > 'z') continue;  // getNextSeq skips non-letters
    switch (b) {
      case 'a': case 'A': s.code.push_back(0); break;
      case 'g': case 'G': s.code.push_back(1); gc_cont++; break;
      case 'c': case 'C': s.code.push_back(2); gc_cont++; break;
      case 't': case 'T': s.code.push_back(3); break;
      default: s.code.push_back(2); break;  // unknown -> C-coded, no GC count
    }
  }
  s.len = (int)s.code.size();
  s.gc = ((double)gc_cont / (double)s.len);
  // rcom_seq: A<->T, G<->C; the unknown-base toggle lands back on code 2
  s.rcode.resize(s.len);
  for (int i = 0; i < s.len; i++) s.rcode[i] = 3 - s.code[s.len - 1 - i];
}

inline int is_a(const uint8_t* c, int n) { return c[n] == 0; }
inline int is_g(const uint8_t* c, int n) { return c[n] == 1; }
inline int is_c(const uint8_t* c, int n) { return c[n] == 2; }  // incl. N
inline int is_t(const uint8_t* c, int n) { return c[n] == 3; }
inline int is_gc(const uint8_t* c, int n) { return c[n] == 1 || c[n] == 2; }

// Translation-table-aware codon predicates
// (`prodigalsequence.cpp:289-371`); the fast 2-arg forms below keep the
// single-mode table-11 call sites unchanged.
inline int is_stop_tt(const uint8_t* c, int n, int tt) {
  if (is_t(c, n) && is_a(c, n + 1) && is_g(c, n + 2)) {  // TAG
    if (tt == 6 || tt == 15 || tt == 16 || tt == 22) return 0;
    return 1;
  }
  if (is_t(c, n) && is_g(c, n + 1) && is_a(c, n + 2)) {  // TGA
    if ((tt >= 2 && tt <= 5) || tt == 9 || tt == 10 || tt == 13 ||
        tt == 14 || tt == 21 || tt == 25)
      return 0;
    return 1;
  }
  if (is_t(c, n) && is_a(c, n + 1) && is_a(c, n + 2)) {  // TAA
    if (tt == 6 || tt == 14) return 0;
    return 1;
  }
  if (tt == 2 && is_a(c, n) && is_g(c, n + 1) && is_a(c, n + 2)) return 1;
  if (tt == 2 && is_a(c, n) && is_g(c, n + 1) && is_g(c, n + 2)) return 1;
  if (tt == 22 && is_t(c, n) && is_c(c, n + 1) && is_a(c, n + 2)) return 1;
  if (tt == 23 && is_t(c, n) && is_t(c, n + 1) && is_a(c, n + 2)) return 1;
  return 0;
}
inline int is_start_tt(const uint8_t* c, int n, int tt) {
  if (is_a(c, n) && is_t(c, n + 1) && is_g(c, n + 2)) return 1;  // ATG
  if (tt == 6 || tt == 10 || tt == 14 || tt == 15 || tt == 16 || tt == 22)
    return 0;
  if (is_g(c, n) && is_t(c, n + 1) && is_g(c, n + 2)) {          // GTG
    if (tt == 1 || tt == 3 || tt == 12 || tt == 22) return 0;
    return 1;
  }
  if (is_t(c, n) && is_t(c, n + 1) && is_g(c, n + 2)) {          // TTG
    if (tt < 4 || tt == 9 || (tt >= 21 && tt < 25)) return 0;
    return 1;
  }
  return 0;
}
inline int is_stop(const uint8_t* c, int n) {
  if (is_t(c, n) && is_a(c, n + 1) && is_g(c, n + 2)) return 1;  // TAG
  if (is_t(c, n) && is_g(c, n + 1) && is_a(c, n + 2)) return 1;  // TGA
  if (is_t(c, n) && is_a(c, n + 1) && is_a(c, n + 2)) return 1;  // TAA
  return 0;
}
inline int is_start(const uint8_t* c, int n) {
  if (is_a(c, n) && is_t(c, n + 1) && is_g(c, n + 2)) return 1;
  if (is_g(c, n) && is_t(c, n + 1) && is_g(c, n + 2)) return 1;
  if (is_t(c, n) && is_t(c, n + 1) && is_g(c, n + 2)) return 1;
  return 0;
}
inline int is_atg(const uint8_t* c, int n) {
  return is_a(c, n) && is_t(c, n + 1) && is_g(c, n + 2);
}
inline int is_gtg(const uint8_t* c, int n) {
  return is_g(c, n) && is_t(c, n + 1) && is_g(c, n + 2);
}
inline int is_ttg(const uint8_t* c, int n) {
  return is_t(c, n) && is_t(c, n + 1) && is_g(c, n + 2);
}

// mer_ndx: base j contributes code << 2j (codes are the bitmap's own order)
inline int mer_ndx(int len, const uint8_t* c, int pos) {
  int ndx = 0;
  for (int i = 0; i < len; i++) ndx |= ((int)c[pos + i]) << (2 * i);
  return ndx;
}

inline double dmax(double a, double b) { return a > b ? a : b; }
inline double dmin(double a, double b) { return a < b ? a : b; }
inline int imin(int a, int b) { return a < b ? a : b; }

// ----------------------------------------------------------------- training
struct Training {                 // mirrors struct _training field-for-field
  double gc = 0.0;
  int trans_table = 11;
  int is_meta_model = 0;          // port-side: predict with meta scoring
  double st_wt = 4.35;
  double bias[3] = {0, 0, 0};
  double type_wt[3] = {0, 0, 0};
  int uses_sd = 0;
  double rbs_wt[28] = {0};
  double ups_comp[32][4] = {{0}};
  std::vector<double> mot_wt;     // [4][4][4096] flattened
  double no_mot = 0.0;
  double gene_dc[4096] = {0};

  Training() : mot_wt(4 * 4 * 4096, 0.0) {}
  double& mot(int l, int s, int n) { return mot_wt[(l * 4 + s) * 4096 + n]; }
};

// ------------------------------------------------------------------- nodes
// Structure-of-arrays node list (reference: array of struct _node)
struct Nodes {
  std::vector<int> type, edge, ndx, strand, stop_val;
  std::vector<int> star0, star1, star2;           // star_ptr[3]
  std::vector<int> gc_bias;
  std::vector<double> gcs0, gcs1, gcs2;           // gc_score[3]
  std::vector<double> cscore, gc_cont;
  std::vector<int> rbs0, rbs1;
  std::vector<int> mot_ndx, mot_len, mot_spacer, mot_spacendx;
  std::vector<double> mot_score;
  std::vector<double> uscore, tscore, rscore, sscore, score;
  std::vector<int> traceb, tracef, ov_mark, elim;

  int n() const { return (int)ndx.size(); }
  void clear() {
    type.clear(); edge.clear(); ndx.clear(); strand.clear();
    stop_val.clear(); star0.clear(); star1.clear(); star2.clear();
    gc_bias.clear(); gcs0.clear(); gcs1.clear(); gcs2.clear();
    cscore.clear(); gc_cont.clear(); rbs0.clear(); rbs1.clear();
    mot_ndx.clear(); mot_len.clear(); mot_spacer.clear();
    mot_spacendx.clear(); mot_score.clear();
    uscore.clear(); tscore.clear(); rscore.clear(); sscore.clear();
    score.clear(); traceb.clear(); tracef.clear(); ov_mark.clear();
    elim.clear();
  }
  void push(int t, int e, int x, int s, int sv) {
    type.push_back(t); edge.push_back(e); ndx.push_back(x);
    strand.push_back(s); stop_val.push_back(sv);
    star0.push_back(0); star1.push_back(0); star2.push_back(0);
    gc_bias.push_back(0);
    gcs0.push_back(0); gcs1.push_back(0); gcs2.push_back(0);
    cscore.push_back(0); gc_cont.push_back(0);
    rbs0.push_back(0); rbs1.push_back(0);
    mot_ndx.push_back(0); mot_len.push_back(0); mot_spacer.push_back(0);
    mot_spacendx.push_back(0); mot_score.push_back(0);
    uscore.push_back(0); tscore.push_back(0); rscore.push_back(0);
    sscore.push_back(0); score.push_back(0);
    traceb.push_back(-1); tracef.push_back(-1); ov_mark.push_back(-1);
    elim.push_back(0);
  }
  int star(int i, int f) const {
    return f == 0 ? star0[i] : (f == 1 ? star1[i] : star2[i]);
  }
  void set_star(int i, int f, int v) {
    (f == 0 ? star0 : (f == 1 ? star1 : star2))[i] = v;
  }
  double gcs(int i, int f) const {
    return f == 0 ? gcs0[i] : (f == 1 ? gcs1[i] : gcs2[i]);
  }
  void set_gcs(int i, int f, double v) {
    (f == 0 ? gcs0 : (f == 1 ? gcs1 : gcs2))[i] = v;
  }
};

// add_nodes for the closed=1, unmasked configuration
// (`node.cpp:28-171`; open-edge and mask branches are unreachable under the
// wrapper's fixed closed=1 / do_mask=0 settings and are omitted)
inline void add_nodes(const Seq& sq, Nodes& nd, int tt = 11) {
  const uint8_t* seq = sq.code.data();
  const uint8_t* rseq = sq.rcode.data();
  int slen = sq.len;
  int slmod = slen % 3;
  int last[3], saw_start[3], min_dist[3];

  for (int strand = 0; strand < 2; strand++) {
    const uint8_t* c = strand == 0 ? seq : rseq;
    for (int i = 0; i < 3; i++) {
      last[(i + slmod) % 3] = slen + i;
      saw_start[i % 3] = 0;
      min_dist[i % 3] = kMinEdgeGene;
    }
    for (int i = slen - 3; i >= 0; i--) {
      int fr = i % 3;
      if (is_stop_tt(c, i, tt)) {
        if (saw_start[fr]) {
          // last[fr] is always a genuine stop here (closed=1): edge stays 0
          if (strand == 0)
            nd.push(kTypeStop, 0, last[fr], 1, i);
          else
            nd.push(kTypeStop, 0, slen - last[fr] - 1, -1, slen - i - 1);
        }
        min_dist[fr] = kMinGene;
        last[fr] = i;
        saw_start[fr] = 0;
        continue;
      }
      if (last[fr] >= slen) continue;
      if (is_start_tt(c, i, tt) && (last[fr] - i + 3) >= min_dist[fr]) {
        int t = is_atg(c, i) ? kTypeAtg
                             : (is_gtg(c, i) ? kTypeGtg : kTypeTtg);
        saw_start[fr] = 1;
        if (strand == 0)
          nd.push(t, 0, i, 1, last[fr]);
        else
          nd.push(t, 0, slen - i - 1, -1, slen - last[fr] - 1);
      }
    }
    for (int i = 0; i < 3; i++) {
      if (saw_start[i % 3]) {
        if (strand == 0)
          nd.push(kTypeStop, 0, last[i % 3], 1, i - 6);
        else
          nd.push(kTypeStop, 0, slen - last[i % 3] - 1, -1, slen - i + 5);
      }
    }
  }

  // compare_nodes order: ndx asc, strand desc (forward first). The key is
  // unique per node, so stability is irrelevant.
  int n = nd.n();
  std::vector<int> order(n);
  for (int i = 0; i < n; i++) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    if (nd.ndx[a] != nd.ndx[b]) return nd.ndx[a] < nd.ndx[b];
    return nd.strand[a] > nd.strand[b];
  });
  Nodes out;
  for (int i : order)
    out.push(nd.type[i], nd.edge[i], nd.ndx[i], nd.strand[i], nd.stop_val[i]);
  nd = std::move(out);
}

// calc_most_gc_frame (`prodigalsequence.cpp:573-604`)
inline std::vector<int> gc_frame_plot(const Seq& sq) {
  const uint8_t* seq = sq.code.data();
  int slen = sq.len;
  std::vector<int> fwd(slen, 0), bwd(slen, 0), tot(slen, 0), gp(slen, -1);
  for (int i = 0; i < 3; i++) {
    for (int j = i; j < slen; j++) {
      if (j < 3) fwd[j] = is_gc(seq, j);
      else fwd[j] = fwd[j - 3] + is_gc(seq, j);
      if (j < 3) bwd[slen - j - 1] = is_gc(seq, slen - j - 1);
      else bwd[slen - j - 1] = bwd[slen - j + 2] + is_gc(seq, slen - j - 1);
    }
  }
  for (int i = 0; i < slen; i++) {
    tot[i] = fwd[i] + bwd[i] - is_gc(seq, i);
    if (i - kWindow / 2 >= 0) tot[i] -= fwd[i - kWindow / 2];
    if (i + kWindow / 2 < slen) tot[i] -= bwd[i + kWindow / 2];
  }
  auto max_fr = [](int a, int b, int c) {
    if (a > b) return a > c ? 0 : 2;
    return b > c ? 1 : 2;
  };
  for (int i = 0; i < slen - 2; i += 3) {
    int win = max_fr(tot[i], tot[i + 1], tot[i + 2]);
    for (int j = 0; j < 3; j++) gp[i + j] = win;
  }
  return gp;
}

inline int max_fr3(int a, int b, int c) {
  if (a > b) return a > c ? 0 : 2;
  return b > c ? 1 : 2;
}

// record_gc_bias (`node.cpp:262-316`)
inline void record_gc_bias(const std::vector<int>& gc, Nodes& nd,
                           Training& ti) {
  int nn = nd.n();
  if (nn == 0) return;
  int ctr[3][3], last[3];
  for (int i = 0; i < 3; i++) for (int j = 0; j < 3; j++) ctr[i][j] = 0;
  for (int i = nn - 1; i >= 0; i--) {
    int fr = nd.ndx[i] % 3, frmod = 3 - fr;
    if (nd.strand[i] == 1 && nd.type[i] == kTypeStop) {
      for (int j = 0; j < 3; j++) ctr[fr][j] = 0;
      last[fr] = nd.ndx[i];
      ctr[fr][(gc[nd.ndx[i]] + frmod) % 3] = 1;
    } else if (nd.strand[i] == 1) {
      for (int j = last[fr] - 3; j >= nd.ndx[i]; j -= 3)
        ctr[fr][(gc[j] + frmod) % 3]++;
      nd.gc_bias[i] = max_fr3(ctr[fr][0], ctr[fr][1], ctr[fr][2]);
      for (int j = 0; j < 3; j++) {
        double v = 3.0 * ctr[fr][j];
        v /= 1.0 * (nd.stop_val[i] - nd.ndx[i] + 3);
        nd.set_gcs(i, j, v);
      }
      last[fr] = nd.ndx[i];
    }
  }
  for (int i = 0; i < nn; i++) {
    int fr = nd.ndx[i] % 3, frmod = fr;
    if (nd.strand[i] == -1 && nd.type[i] == kTypeStop) {
      for (int j = 0; j < 3; j++) ctr[fr][j] = 0;
      last[fr] = nd.ndx[i];
      ctr[fr][((3 - gc[nd.ndx[i]]) + frmod) % 3] = 1;
    } else if (nd.strand[i] == -1) {
      for (int j = last[fr] + 3; j <= nd.ndx[i]; j += 3)
        ctr[fr][((3 - gc[j]) + frmod) % 3]++;
      nd.gc_bias[i] = max_fr3(ctr[fr][0], ctr[fr][1], ctr[fr][2]);
      for (int j = 0; j < 3; j++) {
        double v = 3.0 * ctr[fr][j];
        v /= 1.0 * (nd.ndx[i] - nd.stop_val[i] + 3);
        nd.set_gcs(i, j, v);
      }
      last[fr] = nd.ndx[i];
    }
  }
  for (int i = 0; i < 3; i++) ti.bias[i] = 0.0;
  for (int i = 0; i < nn; i++) {
    if (nd.type[i] != kTypeStop) {
      int len = abs(nd.stop_val[i] - nd.ndx[i]) + 1;
      ti.bias[nd.gc_bias[i]] += (nd.gcs(i, nd.gc_bias[i]) * len) / 1000.0;
    }
  }
  double tot = ti.bias[0] + ti.bias[1] + ti.bias[2];
  for (int i = 0; i < 3; i++) ti.bias[i] *= (3.0 / tot);
}

// intergenic_mod (`node.cpp:1376-1400`)
inline double intergenic_mod(const Nodes& nd, int i1, int i2,
                             const Training& ti) {
  double rval = 0.0, ovlp = 0.0;
  if ((nd.strand[i1] == 1 && nd.strand[i2] == 1 &&
       (nd.ndx[i1] + 2 == nd.ndx[i2] || nd.ndx[i1] - 1 == nd.ndx[i2])) ||
      (nd.strand[i1] == -1 && nd.strand[i2] == -1 &&
       (nd.ndx[i1] + 2 == nd.ndx[i2] || nd.ndx[i1] - 1 == nd.ndx[i2]))) {
    if (nd.strand[i1] == 1 && nd.rscore[i2] < 0) rval -= nd.rscore[i2];
    if (nd.strand[i1] == -1 && nd.rscore[i1] < 0) rval -= nd.rscore[i1];
    if (nd.strand[i1] == 1 && nd.uscore[i2] < 0) rval -= nd.uscore[i2];
    if (nd.strand[i1] == -1 && nd.uscore[i1] < 0) rval -= nd.uscore[i1];
  }
  int dist = abs(nd.ndx[i1] - nd.ndx[i2]);
  if (nd.strand[i1] == 1 && nd.strand[i2] == 1 &&
      nd.ndx[i1] + 2 >= nd.ndx[i2])
    ovlp = 1;
  else if (nd.strand[i1] == -1 && nd.strand[i2] == -1 &&
           nd.ndx[i1] >= nd.ndx[i2] + 2)
    ovlp = 1;
  if (dist > 3 * kOperDist || nd.strand[i1] != nd.strand[i2]) {
    rval -= 0.15 * ti.st_wt;
  } else if ((dist <= kOperDist && ovlp == 0) || dist < 0.25 * kOperDist) {
    rval += (2.0 - (double)dist / kOperDist) * 0.15 * ti.st_wt;
  }
  return rval;
}

// record_overlapping_starts (`node.cpp:207-252`)
inline void record_overlapping_starts(Nodes& nd, const Training& ti,
                                      int flag) {
  int nn = nd.n();
  for (int i = 0; i < nn; i++) {
    nd.star0[i] = -1; nd.star1[i] = -1; nd.star2[i] = -1;
    if (nd.type[i] != kTypeStop || nd.edge[i] == 1) continue;
    double max_sc = -100;
    if (nd.strand[i] == 1) {
      for (int j = i + 3; j >= 0; j--) {
        if (j >= nn || nd.ndx[j] > nd.ndx[i] + 2) continue;
        if (nd.ndx[j] + kMaxSameOvlp < nd.ndx[i]) break;
        if (nd.strand[j] == 1 && nd.type[j] != kTypeStop) {
          if (nd.stop_val[j] <= nd.ndx[i]) continue;
          int f = nd.ndx[j] % 3;
          if (flag == 0 && nd.star(i, f) == -1)
            nd.set_star(i, f, j);
          else if (flag == 1 && (nd.cscore[j] + nd.sscore[j] +
                                 intergenic_mod(nd, i, j, ti) > max_sc)) {
            nd.set_star(i, f, j);
            max_sc = nd.cscore[j] + nd.sscore[j] +
                     intergenic_mod(nd, i, j, ti);
          }
        }
      }
    } else {
      for (int j = i - 3; j < nn; j++) {
        if (j < 0 || nd.ndx[j] < nd.ndx[i] - 2) continue;
        if (nd.ndx[j] - kMaxSameOvlp > nd.ndx[i]) break;
        if (nd.strand[j] == -1 && nd.type[j] != kTypeStop) {
          if (nd.stop_val[j] >= nd.ndx[i]) continue;
          int f = nd.ndx[j] % 3;
          if (flag == 0 && nd.star(i, f) == -1)
            nd.set_star(i, f, j);
          else if (flag == 1 && (nd.cscore[j] + nd.sscore[j] +
                                 intergenic_mod(nd, j, i, ti) > max_sc)) {
            nd.set_star(i, f, j);
            max_sc = nd.cscore[j] + nd.sscore[j] +
                     intergenic_mod(nd, j, i, ti);
          }
        }
      }
    }
  }
}

// calc_mer_bg (`prodigalsequence.cpp:640-655`)
inline void calc_mer_bg(int len, const Seq& sq, double* bg) {
  int size = 1;
  for (int i = 1; i <= len; i++) size *= 4;
  std::vector<int> counts(size, 0);
  int glob = 0;
  for (int i = 0; i < sq.len - len + 1; i++) {
    counts[mer_ndx(len, sq.code.data(), i)]++;
    counts[mer_ndx(len, sq.rcode.data(), i)]++;
    glob += 2;
  }
  for (int i = 0; i < size; i++) bg[i] = (double)((counts[i] * 1.0) / (glob * 1.0));
}

// calc_dicodon_gene (`node.cpp:324-366`)
inline void calc_dicodon_gene(Training& ti, const Seq& sq, Nodes& nd,
                              int dbeg) {
  int counts[4096], glob = 0;
  double prob[4096], bg[4096];
  for (int i = 0; i < 4096; i++) {
    counts[i] = 0;
    prob[i] = 0.0;
    bg[i] = 0.0;
  }
  int left = -1, right = -1;
  calc_mer_bg(6, sq, bg);
  int path = dbeg, in_gene = 0;
  int slen = sq.len;
  while (path != -1) {
    if (nd.strand[path] == -1 && nd.type[path] != kTypeStop) {
      in_gene = -1;
      left = slen - nd.ndx[path] - 1;
    }
    if (nd.strand[path] == 1 && nd.type[path] == kTypeStop) {
      in_gene = 1;
      right = nd.ndx[path] + 2;
    }
    if (in_gene == -1 && nd.strand[path] == -1 &&
        nd.type[path] == kTypeStop) {
      right = slen - nd.ndx[path] + 1;
      for (int i = left; i < right - 5; i += 3) {
        counts[mer_ndx(6, sq.rcode.data(), i)]++;
        glob++;
      }
      in_gene = 0;
    }
    if (in_gene == 1 && nd.strand[path] == 1 && nd.type[path] != kTypeStop) {
      left = nd.ndx[path];
      for (int i = left; i < right - 5; i += 3) {
        counts[mer_ndx(6, sq.code.data(), i)]++;
        glob++;
      }
      in_gene = 0;
    }
    path = nd.traceb[path];
  }
  for (int i = 0; i < 4096; i++) {
    prob[i] = (counts[i] * 1.0) / (glob * 1.0);
    if (prob[i] == 0 && bg[i] != 0) ti.gene_dc[i] = -5.0;
    else if (bg[i] == 0) ti.gene_dc[i] = 0.0;
    else ti.gene_dc[i] = log(prob[i] / bg[i]);
    if (ti.gene_dc[i] > 5.0) ti.gene_dc[i] = 5.0;
    if (ti.gene_dc[i] < -5.0) ti.gene_dc[i] = -5.0;
  }
}

// raw_coding_score (`node.cpp:569-677`)
inline void raw_coding_score(const Seq& sq, Nodes& nd, const Training& ti) {
  int nn = nd.n(), slen = sq.len;
  double no_stop;
  if (ti.trans_table != 11) {  // TGA or TAG is not a stop
    no_stop = ((1 - ti.gc) * (1 - ti.gc) * ti.gc) / 8.0;
    no_stop += ((1 - ti.gc) * (1 - ti.gc) * (1 - ti.gc)) / 8.0;
    no_stop = (1 - no_stop);
  } else {
    no_stop = ((1 - ti.gc) * (1 - ti.gc) * ti.gc) / 4.0;
    no_stop += ((1 - ti.gc) * (1 - ti.gc) * (1 - ti.gc)) / 8.0;
    no_stop = (1 - no_stop);
  }

  double score[3];
  int last[3];
  // initial pass: sum dicodon weights start -> stop
  for (int i = 0; i < 3; i++) score[i] = 0.0;
  for (int i = nn - 1; i >= 0; i--) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == 1 && nd.type[i] == kTypeStop) {
      last[fr] = nd.ndx[i];
      score[fr] = 0.0;
    } else if (nd.strand[i] == 1) {
      for (int j = last[fr] - 3; j >= nd.ndx[i]; j -= 3)
        score[fr] += ti.gene_dc[mer_ndx(6, sq.code.data(), j)];
      nd.cscore[i] = score[fr];
      last[fr] = nd.ndx[i];
    }
  }
  for (int i = 0; i < 3; i++) score[i] = 0.0;
  for (int i = 0; i < nn; i++) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == -1 && nd.type[i] == kTypeStop) {
      last[fr] = nd.ndx[i];
      score[fr] = 0.0;
    } else if (nd.strand[i] == -1) {
      for (int j = last[fr] + 3; j <= nd.ndx[i]; j += 3)
        score[fr] += ti.gene_dc[mer_ndx(6, sq.rcode.data(), slen - j - 1)];
      nd.cscore[i] = score[fr];
      last[fr] = nd.ndx[i];
    }
  }

  // second pass: penalize starts with ascending coding to their left
  for (int i = 0; i < 3; i++) score[i] = -10000.0;
  for (int i = 0; i < nn; i++) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == 1 && nd.type[i] == kTypeStop) score[fr] = -10000.0;
    else if (nd.strand[i] == 1) {
      if (nd.cscore[i] > score[fr]) score[fr] = nd.cscore[i];
      else nd.cscore[i] -= (score[fr] - nd.cscore[i]);
    }
  }
  for (int i = 0; i < 3; i++) score[i] = -10000.0;
  for (int i = nn - 1; i >= 0; i--) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == -1 && nd.type[i] == kTypeStop) score[fr] = -10000.0;
    else if (nd.strand[i] == -1) {
      if (nd.cscore[i] > score[fr]) score[fr] = nd.cscore[i];
      else nd.cscore[i] -= (score[fr] - nd.cscore[i]);
    }
  }

  // third pass: length factor (score[] carries over from the second pass's
  // last reverse sweep, exactly as in the reference)
  for (int i = 0; i < nn; i++) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == 1 && nd.type[i] == kTypeStop) score[fr] = -10000.0;
    else if (nd.strand[i] == 1) {
      double gsize = ((float)(abs(nd.stop_val[i] - nd.ndx[i]) + 3.0)) / 3.0;
      double lfac;
      if (gsize > 1000.0) {
        lfac = log((1 - pow(no_stop, 1000.0)) / pow(no_stop, 1000.0));
        lfac -= log((1 - pow(no_stop, 80)) / pow(no_stop, 80));
        lfac *= (gsize - 80) / 920.0;
      } else {
        lfac = log((1 - pow(no_stop, gsize)) / pow(no_stop, gsize));
        lfac -= log((1 - pow(no_stop, 80)) / pow(no_stop, 80));
      }
      if (lfac > score[fr]) score[fr] = lfac;
      else lfac -= dmax(dmin(score[fr] - lfac, lfac), 0);
      if (lfac > 3.0 && nd.cscore[i] < 0.5 * lfac) nd.cscore[i] = 0.5 * lfac;
      nd.cscore[i] += lfac;
    }
  }
  for (int i = nn - 1; i >= 0; i--) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == -1 && nd.type[i] == kTypeStop) score[fr] = -10000.0;
    else if (nd.strand[i] == -1) {
      double gsize = ((float)(abs(nd.stop_val[i] - nd.ndx[i]) + 3.0)) / 3.0;
      double lfac;
      if (gsize > 1000.0) {
        lfac = log((1 - pow(no_stop, 1000.0)) / pow(no_stop, 1000.0));
        lfac -= log((1 - pow(no_stop, 80)) / pow(no_stop, 80));
        lfac *= (gsize - 80) / 920.0;
      } else {
        lfac = log((1 - pow(no_stop, gsize)) / pow(no_stop, gsize));
        lfac -= log((1 - pow(no_stop, 80)) / pow(no_stop, 80));
      }
      if (lfac > score[fr]) score[fr] = lfac;
      else lfac -= dmax(dmin(score[fr] - lfac, lfac), 0);
      if (lfac > 3.0 && nd.cscore[i] < 0.5 * lfac) nd.cscore[i] = 0.5 * lfac;
      nd.cscore[i] += lfac;
    }
  }
}

// calc_orf_gc (`node.cpp:523-561`)
inline void calc_orf_gc(const Seq& sq, Nodes& nd) {
  int nn = nd.n();
  const uint8_t* seq = sq.code.data();
  double gc[3];
  int last[3];
  for (int i = 0; i < 3; i++) gc[i] = 0.0;
  for (int i = nn - 1; i >= 0; i--) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == 1 && nd.type[i] == kTypeStop) {
      last[fr] = nd.ndx[i];
      gc[fr] = is_gc(seq, nd.ndx[i]) + is_gc(seq, nd.ndx[i] + 1) +
               is_gc(seq, nd.ndx[i] + 2);
    } else if (nd.strand[i] == 1) {
      for (int j = last[fr] - 3; j >= nd.ndx[i]; j -= 3)
        gc[fr] += is_gc(seq, j) + is_gc(seq, j + 1) + is_gc(seq, j + 2);
      double gsize = (float)(abs(nd.stop_val[i] - nd.ndx[i]) + 3.0);
      nd.gc_cont[i] = gc[fr] / gsize;
      last[fr] = nd.ndx[i];
    }
  }
  for (int i = 0; i < 3; i++) gc[i] = 0.0;
  for (int i = 0; i < nn; i++) {
    int fr = nd.ndx[i] % 3;
    if (nd.strand[i] == -1 && nd.type[i] == kTypeStop) {
      last[fr] = nd.ndx[i];
      gc[fr] = is_gc(seq, nd.ndx[i]) + is_gc(seq, nd.ndx[i] - 1) +
               is_gc(seq, nd.ndx[i] - 2);
    } else if (nd.strand[i] == -1) {
      for (int j = last[fr] + 3; j <= nd.ndx[i]; j += 3)
        gc[fr] += is_gc(seq, j) + is_gc(seq, j + 1) + is_gc(seq, j + 2);
      double gsize = (float)(abs(nd.stop_val[i] - nd.ndx[i]) + 3.0);
      nd.gc_cont[i] = gc[fr] / gsize;
      last[fr] = nd.ndx[i];
    }
  }
}

// shine_dalgarno_exact / _mm (`prodigalsequence.cpp:662-799`)
inline int shine_dalgarno_exact(const uint8_t* seq, int pos, int start,
                                const double* rwt) {
  double match[6], cur_ctr, dis_flag;
  int limit = imin(6, start - 4 - pos);
  for (int i = limit; i < 6; i++) match[i] = -10.0;
  for (int i = 0; i < limit; i++) {
    if (pos + i < 0) continue;
    if (i % 3 == 0 && is_a(seq, pos + i)) match[i] = 2.0;
    else if (i % 3 != 0 && is_g(seq, pos + i)) match[i] = 3.0;
    else match[i] = -10.0;
  }
  int max_val = 0, cur_val = 0;
  for (int i = limit; i >= 3; i--) {
    for (int j = 0; j <= limit - i; j++) {
      cur_ctr = -2.0;
      int mism = 0;
      for (int k = j; k < j + i; k++) {
        cur_ctr += match[k];
        if (match[k] < 0.0) mism++;
      }
      if (mism > 0) continue;
      int rdis = start - (pos + j + i);
      if (rdis < 5 && i < 5) dis_flag = 2;
      else if (rdis < 5 && i >= 5) dis_flag = 1;
      else if (rdis > 10 && rdis <= 12 && i < 5) dis_flag = 1;
      else if (rdis > 10 && rdis <= 12 && i >= 5) dis_flag = 2;
      else if (rdis >= 13) dis_flag = 3;
      else dis_flag = 0;
      if (rdis > 15 || cur_ctr < 6.0) continue;

      if (cur_ctr < 6.0) cur_val = 0;
      else if (cur_ctr == 6.0 && dis_flag == 2) cur_val = 1;
      else if (cur_ctr == 6.0 && dis_flag == 3) cur_val = 2;
      else if (cur_ctr == 8.0 && dis_flag == 3) cur_val = 3;
      else if (cur_ctr == 9.0 && dis_flag == 3) cur_val = 3;
      else if (cur_ctr == 6.0 && dis_flag == 1) cur_val = 6;
      else if (cur_ctr == 11.0 && dis_flag == 3) cur_val = 10;
      else if (cur_ctr == 12.0 && dis_flag == 3) cur_val = 10;
      else if (cur_ctr == 14.0 && dis_flag == 3) cur_val = 10;
      else if (cur_ctr == 8.0 && dis_flag == 2) cur_val = 11;
      else if (cur_ctr == 9.0 && dis_flag == 2) cur_val = 11;
      else if (cur_ctr == 8.0 && dis_flag == 1) cur_val = 12;
      else if (cur_ctr == 9.0 && dis_flag == 1) cur_val = 12;
      else if (cur_ctr == 6.0 && dis_flag == 0) cur_val = 13;
      else if (cur_ctr == 8.0 && dis_flag == 0) cur_val = 15;
      else if (cur_ctr == 9.0 && dis_flag == 0) cur_val = 16;
      else if (cur_ctr == 11.0 && dis_flag == 2) cur_val = 20;
      else if (cur_ctr == 11.0 && dis_flag == 1) cur_val = 21;
      else if (cur_ctr == 11.0 && dis_flag == 0) cur_val = 22;
      else if (cur_ctr == 12.0 && dis_flag == 2) cur_val = 20;
      else if (cur_ctr == 12.0 && dis_flag == 1) cur_val = 23;
      else if (cur_ctr == 12.0 && dis_flag == 0) cur_val = 24;
      else if (cur_ctr == 14.0 && dis_flag == 2) cur_val = 25;
      else if (cur_ctr == 14.0 && dis_flag == 1) cur_val = 26;
      else if (cur_ctr == 14.0 && dis_flag == 0) cur_val = 27;

      if (rwt[cur_val] < rwt[max_val]) continue;
      if (rwt[cur_val] == rwt[max_val] && cur_val < max_val) continue;
      max_val = cur_val;
    }
  }
  return max_val;
}

inline int shine_dalgarno_mm(const uint8_t* seq, int pos, int start,
                             const double* rwt) {
  double match[6], cur_ctr, dis_flag;
  int limit = imin(6, start - 4 - pos);
  for (int i = limit; i < 6; i++) match[i] = -10.0;
  for (int i = 0; i < limit; i++) {
    if (pos + i < 0) continue;
    if (i % 3 == 0) {
      if (is_a(seq, pos + i)) match[i] = 2.0;
      else match[i] = -3.0;
    } else {
      if (is_g(seq, pos + i)) match[i] = 3.0;
      else match[i] = -2.0;
    }
  }
  int max_val = 0, cur_val = 0;
  for (int i = limit; i >= 5; i--) {
    for (int j = 0; j <= limit - i; j++) {
      cur_ctr = -2.0;
      int mism = 0;
      for (int k = j; k < j + i; k++) {
        cur_ctr += match[k];
        if (match[k] < 0.0) mism++;
        if (match[k] < 0.0 && (k <= j + 1 || k >= j + i - 2)) cur_ctr -= 10.0;
      }
      if (mism != 1) continue;
      int rdis = start - (pos + j + i);
      if (rdis < 5) dis_flag = 1;
      else if (rdis > 10 && rdis <= 12) dis_flag = 2;
      else if (rdis >= 13) dis_flag = 3;
      else dis_flag = 0;
      if (rdis > 15 || cur_ctr < 6.0) continue;

      if (cur_ctr < 6.0) cur_val = 0;
      else if (cur_ctr == 6.0 && dis_flag == 3) cur_val = 2;
      else if (cur_ctr == 7.0 && dis_flag == 3) cur_val = 2;
      else if (cur_ctr == 9.0 && dis_flag == 3) cur_val = 3;
      else if (cur_ctr == 6.0 && dis_flag == 2) cur_val = 4;
      else if (cur_ctr == 6.0 && dis_flag == 1) cur_val = 5;
      else if (cur_ctr == 6.0 && dis_flag == 0) cur_val = 9;
      else if (cur_ctr == 7.0 && dis_flag == 2) cur_val = 7;
      else if (cur_ctr == 7.0 && dis_flag == 1) cur_val = 8;
      else if (cur_ctr == 7.0 && dis_flag == 0) cur_val = 14;
      else if (cur_ctr == 9.0 && dis_flag == 2) cur_val = 17;
      else if (cur_ctr == 9.0 && dis_flag == 1) cur_val = 18;
      else if (cur_ctr == 9.0 && dis_flag == 0) cur_val = 19;

      if (rwt[cur_val] < rwt[max_val]) continue;
      if (rwt[cur_val] == rwt[max_val] && cur_val < max_val) continue;
      max_val = cur_val;
    }
  }
  return max_val;
}

// rbs_score (`node.cpp:699-730`)
inline void rbs_score(const Seq& sq, Nodes& nd, const Training& ti) {
  int nn = nd.n(), slen = sq.len;
  for (int i = 0; i < nn; i++) {
    if (nd.type[i] == kTypeStop || nd.edge[i] == 1) continue;
    nd.rbs0[i] = 0;
    nd.rbs1[i] = 0;
    if (nd.strand[i] == 1) {
      for (int j = nd.ndx[i] - 20; j <= nd.ndx[i] - 6; j++) {
        if (j < 0) continue;
        int c0 = shine_dalgarno_exact(sq.code.data(), j, nd.ndx[i], ti.rbs_wt);
        int c1 = shine_dalgarno_mm(sq.code.data(), j, nd.ndx[i], ti.rbs_wt);
        if (c0 > nd.rbs0[i]) nd.rbs0[i] = c0;
        if (c1 > nd.rbs1[i]) nd.rbs1[i] = c1;
      }
    } else {
      for (int j = slen - nd.ndx[i] - 21; j <= slen - nd.ndx[i] - 7; j++) {
        if (j > slen - 1) continue;
        int c0 = shine_dalgarno_exact(sq.rcode.data(), j,
                                      slen - 1 - nd.ndx[i], ti.rbs_wt);
        int c1 = shine_dalgarno_mm(sq.rcode.data(), j, slen - 1 - nd.ndx[i],
                                   ti.rbs_wt);
        if (c0 > nd.rbs0[i]) nd.rbs0[i] = c0;
        if (c1 > nd.rbs1[i]) nd.rbs1[i] = c1;
      }
    }
  }
}

// score_connection (`dprog.cpp:131-313`)
inline void score_connection(Nodes& nd, int p1, int p2, const Training& ti,
                             int flag) {
  int left = nd.ndx[p1];
  int right = nd.ndx[p2];
  int ovlp = 0, maxfr = -1;
  double score = 0.0, scr_mod = 0.0, maxval;
  const int s1 = nd.strand[p1], s2 = nd.strand[p2];
  const bool st1 = nd.type[p1] == kTypeStop, st2 = nd.type[p2] == kTypeStop;

  // invalid connections
  if (!st1 && !st2 && s1 == s2) return;
  else if (s1 == 1 && !st1 && s2 == -1) return;
  else if (s1 == -1 && st1 && s2 == 1) return;
  else if (s1 == -1 && !st1 && s2 == 1 && st2) return;
  // edge artifacts
  if (nd.traceb[p1] == -1 && s1 == 1 && st1) return;
  if (nd.traceb[p1] == -1 && s1 == -1 && !st1) return;
  // genes
  else if (s1 == s2 && s1 == 1 && !st1 && st2) {
    if (nd.stop_val[p2] >= nd.ndx[p1]) return;
    if (nd.ndx[p1] % 3 != nd.ndx[p2] % 3) return;
    right += 2;
    if (flag == 0)
      scr_mod = ti.bias[0] * nd.gcs0[p1] + ti.bias[1] * nd.gcs1[p1] +
                ti.bias[2] * nd.gcs2[p1];
    else if (flag == 1)
      score = nd.cscore[p1] + nd.sscore[p1];
  } else if (s1 == s2 && s1 == -1 && st1 && !st2) {
    if (nd.stop_val[p1] <= nd.ndx[p2]) return;
    if (nd.ndx[p1] % 3 != nd.ndx[p2] % 3) return;
    left -= 2;
    if (flag == 0)
      scr_mod = ti.bias[0] * nd.gcs0[p2] + ti.bias[1] * nd.gcs1[p2] +
                ti.bias[2] * nd.gcs2[p2];
    else if (flag == 1)
      score = nd.cscore[p2] + nd.sscore[p2];
  }
  // intergenic space
  else if (s1 == 1 && st1 && s2 == 1 && !st2) {
    left += 2;
    if (left >= right) return;
    if (flag == 1) score = intergenic_mod(nd, p1, p2, ti);
  } else if (s1 == 1 && st1 && s2 == -1 && st2) {
    left += 2;
    right -= 2;
    if (left >= right) return;
    // three consecutive overlapping genes f r r
    maxfr = -1;
    maxval = 0.0;
    for (int i = 0; i < 3; i++) {
      if (nd.star(p2, i) == -1) continue;
      int p3 = nd.star(p2, i);
      ovlp = left - nd.stop_val[p3] + 3;
      if (ovlp <= 0 || ovlp >= kMaxOppOvlp) continue;
      if (ovlp >= nd.ndx[p3] - left) continue;
      if (nd.traceb[p1] == -1) continue;
      if (ovlp >= nd.stop_val[p3] - nd.ndx[nd.traceb[p1]] - 2) continue;
      if ((flag == 1 && nd.cscore[p3] + nd.sscore[p3] +
                            intergenic_mod(nd, p3, p2, ti) > maxval) ||
          (flag == 0 && ti.bias[0] * nd.gcs0[p3] + ti.bias[1] * nd.gcs1[p3] +
                                ti.bias[2] * nd.gcs2[p3] > maxval)) {
        maxfr = i;
        maxval = nd.cscore[p3] + nd.sscore[p3] +
                 intergenic_mod(nd, p3, p2, ti);
      }
    }
    if (maxfr != -1) {
      int p3 = nd.star(p2, maxfr);
      if (flag == 0)
        scr_mod = ti.bias[0] * nd.gcs0[p3] + ti.bias[1] * nd.gcs1[p3] +
                  ti.bias[2] * nd.gcs2[p3];
      else if (flag == 1)
        score = nd.cscore[p3] + nd.sscore[p3] +
                intergenic_mod(nd, p3, p2, ti);
    } else if (flag == 1)
      score = intergenic_mod(nd, p1, p2, ti);
  } else if (s1 == -1 && !st1 && s2 == -1 && st2) {
    right -= 2;
    if (left >= right) return;
    if (flag == 1) score = intergenic_mod(nd, p1, p2, ti);
  } else if (s1 == -1 && !st1 && s2 == 1 && !st2) {
    if (left >= right) return;
    if (flag == 1) score = intergenic_mod(nd, p1, p2, ti);
  }
  // possible operons
  else if (s1 == 1 && s2 == 1 && st1 && st2) {
    if (nd.stop_val[p2] >= nd.ndx[p1]) return;
    if (nd.star(p1, nd.ndx[p2] % 3) == -1) return;
    int p3 = nd.star(p1, nd.ndx[p2] % 3);
    left = nd.ndx[p3];
    right += 2;
    if (flag == 0)
      scr_mod = ti.bias[0] * nd.gcs0[p3] + ti.bias[1] * nd.gcs1[p3] +
                ti.bias[2] * nd.gcs2[p3];
    else if (flag == 1)
      score = nd.cscore[p3] + nd.sscore[p3] + intergenic_mod(nd, p1, p3, ti);
  } else if (s1 == -1 && st1 && s2 == -1 && st2) {
    if (nd.stop_val[p1] <= nd.ndx[p2]) return;
    if (nd.star(p2, nd.ndx[p1] % 3) == -1) return;
    int p3 = nd.star(p2, nd.ndx[p1] % 3);
    left -= 2;
    right = nd.ndx[p3];
    if (flag == 0)
      scr_mod = ti.bias[0] * nd.gcs0[p3] + ti.bias[1] * nd.gcs1[p3] +
                ti.bias[2] * nd.gcs2[p3];
    else if (flag == 1)
      score = nd.cscore[p3] + nd.sscore[p3] + intergenic_mod(nd, p3, p2, ti);
  }
  // overlapping opposite-strand 3' ends: 3'fwd -> 5'rev
  else if (s1 == 1 && st1 && s2 == -1 && !st2) {
    if (nd.stop_val[p2] - 2 >= nd.ndx[p1] + 2) return;
    ovlp = (nd.ndx[p1] + 2) - (nd.stop_val[p2] - 2) + 1;
    if (ovlp >= kMaxOppOvlp) return;
    if ((nd.ndx[p1] + 2 - nd.stop_val[p2] - 2 + 1) >=
        (nd.ndx[p2] - nd.ndx[p1] + 3 + 1))
      return;
    int bnd = nd.traceb[p1] == -1 ? 0 : nd.ndx[nd.traceb[p1]];
    if ((nd.ndx[p1] + 2 - nd.stop_val[p2] - 2 + 1) >=
        (nd.stop_val[p2] - 3 - bnd + 1))
      return;
    left = nd.stop_val[p2] - 2;
    if (flag == 0)
      scr_mod = ti.bias[0] * nd.gcs0[p2] + ti.bias[1] * nd.gcs1[p2] +
                ti.bias[2] * nd.gcs2[p2];
    else if (flag == 1)
      score = nd.cscore[p2] + nd.sscore[p2] - 0.15 * ti.st_wt;
  }

  if (flag == 0) score = ((double)(right - left + 1 - (ovlp * 2))) * scr_mod;

  if (nd.score[p1] + score >= nd.score[p2]) {
    nd.score[p2] = nd.score[p1] + score;
    nd.traceb[p2] = p1;
    nd.ov_mark[p2] = maxfr;
  }
}

// dprog (`dprog.cpp:31-120`)
inline int dprog(Nodes& nd, const Training& ti, int flag) {
  int nn = nd.n();
  if (nn == 0) return -1;
  for (int i = 0; i < nn; i++) {
    nd.score[i] = 0;
    nd.traceb[i] = -1;
    nd.tracef[i] = -1;
  }
  for (int i = 0; i < nn; i++) {
    int min = i < kMaxNodeDist ? 0 : i - kMaxNodeDist;
    if (nd.strand[i] == -1 && nd.type[i] != kTypeStop &&
        nd.ndx[min] >= nd.stop_val[i]) {
      while (min > 0 && nd.ndx[min] != nd.stop_val[i]) min--;
    }
    if (nd.strand[i] == 1 && nd.type[i] == kTypeStop &&
        nd.ndx[min] >= nd.stop_val[i]) {
      while (min > 0 && nd.ndx[min] != nd.stop_val[i]) min--;
    }
    if (min < 0) min = 0;
    for (int j = min; j < i; j++) score_connection(nd, j, i, ti, flag);
  }
  int max_ndx = -1;
  double max_sc = -1.0;
  for (int i = nn - 1; i >= 0; i--) {
    if (nd.strand[i] == 1 && nd.type[i] != kTypeStop) continue;
    if (nd.strand[i] == -1 && nd.type[i] == kTypeStop) continue;
    if (nd.score[i] > max_sc) {
      max_sc = nd.score[i];
      max_ndx = i;
    }
  }
  if (max_ndx == -1) return -1;

  // first pass: untangle the triple overlaps
  int path = max_ndx;
  while (nd.traceb[path] != -1) {
    int nxt = nd.traceb[path];
    if (nd.strand[path] == -1 && nd.type[path] == kTypeStop &&
        nd.strand[nxt] == 1 && nd.type[nxt] == kTypeStop &&
        nd.ov_mark[path] != -1 && nd.ndx[path] > nd.ndx[nxt]) {
      int tmp = nd.star(path, nd.ov_mark[path]);
      int i;
      for (i = tmp; nd.ndx[i] != nd.stop_val[tmp]; i--)
        ;
      nd.traceb[path] = tmp;
      nd.traceb[tmp] = i;
      nd.ov_mark[i] = -1;
      nd.traceb[i] = nxt;
    }
    path = nd.traceb[path];
  }

  // second pass: untangle the simple overlaps
  path = max_ndx;
  while (nd.traceb[path] != -1) {
    int nxt = nd.traceb[path];
    if (nd.strand[path] == -1 && nd.type[path] != kTypeStop &&
        nd.strand[nxt] == 1 && nd.type[nxt] == kTypeStop) {
      int i;
      for (i = path; nd.ndx[i] != nd.stop_val[path]; i--)
        ;
      nd.traceb[path] = i;
      nd.traceb[i] = nxt;
    }
    if (nd.strand[path] == 1 && nd.type[path] == kTypeStop &&
        nd.strand[nxt] == 1 && nd.type[nxt] == kTypeStop) {
      nd.traceb[path] = nd.star(nxt, nd.ndx[path] % 3);
      nd.traceb[nd.traceb[path]] = nxt;
    }
    if (nd.strand[path] == -1 && nd.type[path] == kTypeStop &&
        nd.strand[nxt] == -1 && nd.type[nxt] == kTypeStop) {
      nd.traceb[path] = nd.star(path, nd.ndx[nxt] % 3);
      nd.traceb[nd.traceb[path]] = nxt;
    }
    path = nd.traceb[path];
  }

  // mark forward pointers
  path = max_ndx;
  while (nd.traceb[path] != -1) {
    nd.tracef[nd.traceb[path]] = path;
    path = nd.traceb[path];
  }

  if (nd.traceb[max_ndx] == -1) return -1;
  return max_ndx;
}

// eliminate_bad_genes (`dprog.cpp:321-350`)
inline void eliminate_bad_genes(Nodes& nd, int dbeg, const Training& ti) {
  if (dbeg == -1) return;
  int path = dbeg;
  while (nd.traceb[path] != -1) path = nd.traceb[path];
  while (nd.tracef[path] != -1) {
    if (nd.strand[path] == 1 && nd.type[path] == kTypeStop)
      nd.sscore[nd.tracef[path]] +=
          intergenic_mod(nd, path, nd.tracef[path], ti);
    if (nd.strand[path] == -1 && nd.type[path] != kTypeStop)
      nd.sscore[path] += intergenic_mod(nd, path, nd.tracef[path], ti);
    path = nd.tracef[path];
  }
  path = dbeg;
  while (nd.traceb[path] != -1) path = nd.traceb[path];
  while (nd.tracef[path] != -1) {
    if (nd.strand[path] == 1 && nd.type[path] != kTypeStop &&
        nd.cscore[path] + nd.sscore[path] < 0) {
      nd.elim[path] = 1;
      nd.elim[nd.tracef[path]] = 1;
    }
    if (nd.strand[path] == -1 && nd.type[path] == kTypeStop &&
        nd.cscore[nd.tracef[path]] + nd.sscore[nd.tracef[path]] < 0) {
      nd.elim[path] = 1;
      nd.elim[nd.tracef[path]] = 1;
    }
    path = nd.tracef[path];
  }
}

// count_upstream_composition (`node.cpp:1152-1163`)
inline void count_upstream_composition(const uint8_t* seq, int slen,
                                       int strand, int pos, Training& ti) {
  int start = strand == 1 ? pos : slen - 1 - pos;
  int count = 0;
  for (int i = 1; i < 45; i++) {
    if (i > 2 && i < 15) continue;
    if (start - i >= 0) ti.ups_comp[count][mer_ndx(1, seq, start - i)]++;
    count++;
  }
}

// score_upstream_composition (`node.cpp:1170-1184`)
inline void score_upstream_composition(const uint8_t* seq, int slen, Nodes& nd,
                                       int i, const Training& ti) {
  int start = nd.strand[i] == 1 ? nd.ndx[i] : slen - 1 - nd.ndx[i];
  int count = 0;
  nd.uscore[i] = 0.0;
  for (int k = 1; k < 45; k++) {
    if (k > 2 && k < 15) continue;
    if (start - k < 0) continue;
    nd.uscore[i] +=
        0.4 * ti.st_wt * ti.ups_comp[count][mer_ndx(1, seq, start - k)];
    count++;
  }
}

// shared log-conversion of the upstream composition counts
// (tail of train_starts_sd / train_starts_nonsd)
inline void ups_comp_to_log(Training& ti) {
  for (int i = 0; i < 32; i++) {
    double sum = 0.0;
    for (int j = 0; j < 4; j++) sum += ti.ups_comp[i][j];
    if (sum == 0.0) {
      for (int j = 0; j < 4; j++) ti.ups_comp[i][j] = 0.0;
    } else {
      for (int j = 0; j < 4; j++) {
        ti.ups_comp[i][j] /= sum;
        if (ti.gc > 0.1 && ti.gc < 0.9) {
          if (j == 0 || j == 3)
            ti.ups_comp[i][j] = log(ti.ups_comp[i][j] * 2.0 / (1.0 - ti.gc));
          else
            ti.ups_comp[i][j] = log(ti.ups_comp[i][j] * 2.0 / ti.gc);
        } else if (ti.gc <= 0.1) {
          if (j == 0 || j == 3)
            ti.ups_comp[i][j] = log(ti.ups_comp[i][j] * 2.0 / 0.90);
          else
            ti.ups_comp[i][j] = log(ti.ups_comp[i][j] * 2.0 / 0.10);
        } else {
          if (j == 0 || j == 3)
            ti.ups_comp[i][j] = log(ti.ups_comp[i][j] * 2.0 / 0.10);
          else
            ti.ups_comp[i][j] = log(ti.ups_comp[i][j] * 2.0 / 0.90);
        }
        if (ti.ups_comp[i][j] > 4.0) ti.ups_comp[i][j] = 4.0;
        if (ti.ups_comp[i][j] < -4.0) ti.ups_comp[i][j] = -4.0;
      }
    }
  }
}

// train_starts_sd (`node.cpp:738-929`)
inline void train_starts_sd(const Seq& sq, Nodes& nd, Training& ti) {
  int nn = nd.n(), slen = sq.len;
  double wt = ti.st_wt, sthresh = 35.0;
  double rbg[28], rreal[28], best[3], tbg[3], treal[3];
  int bndx[3], rbs[3], type[3];

  for (int j = 0; j < 3; j++) ti.type_wt[j] = 0.0;
  for (int j = 0; j < 28; j++) ti.rbs_wt[j] = 0.0;
  for (int i = 0; i < 32; i++)
    for (int j = 0; j < 4; j++) ti.ups_comp[i][j] = 0.0;

  for (int i = 0; i < 3; i++) tbg[i] = 0.0;
  for (int i = 0; i < nn; i++) {
    if (nd.type[i] == kTypeStop) continue;
    tbg[nd.type[i]] += 1.0;
  }
  double sum = 0.0;
  for (int i = 0; i < 3; i++) sum += tbg[i];
  for (int i = 0; i < 3; i++) tbg[i] /= sum;

  auto pick_rb = [&](int j) {
    if (ti.rbs_wt[nd.rbs0[j]] > ti.rbs_wt[nd.rbs1[j]] + 1.0 ||
        nd.rbs1[j] == 0)
      return nd.rbs0[j];
    if (ti.rbs_wt[nd.rbs0[j]] < ti.rbs_wt[nd.rbs1[j]] - 1.0 ||
        nd.rbs0[j] == 0)
      return nd.rbs1[j];
    return (int)dmax(nd.rbs0[j], nd.rbs1[j]);
  };

  for (int i = 0; i < 10; i++) {
    // RBS motif background
    for (int j = 0; j < 28; j++) rbg[j] = 0.0;
    for (int j = 0; j < nn; j++) {
      if (nd.type[j] == kTypeStop || nd.edge[j] == 1) continue;
      rbg[pick_rb(j)] += 1.0;
    }
    sum = 0.0;
    for (int j = 0; j < 28; j++) sum += rbg[j];
    for (int j = 0; j < 28; j++) rbg[j] /= sum;

    for (int j = 0; j < 28; j++) rreal[j] = 0.0;
    for (int j = 0; j < 3; j++) treal[j] = 0.0;

    // forward strand pass
    for (int j = 0; j < 3; j++) {
      best[j] = 0.0; bndx[j] = -1; rbs[j] = 0; type[j] = 0;
    }
    for (int j = 0; j < nn; j++) {
      if (nd.type[j] != kTypeStop && nd.edge[j] == 1) continue;
      int fr = nd.ndx[j] % 3;
      if (nd.type[j] == kTypeStop && nd.strand[j] == 1) {
        if (best[fr] >= sthresh && nd.ndx[bndx[fr]] % 3 == fr) {
          rreal[rbs[fr]] += 1.0;
          treal[type[fr]] += 1.0;
          if (i == 9)
            count_upstream_composition(sq.code.data(), slen, 1,
                                       nd.ndx[bndx[fr]], ti);
        }
        best[fr] = 0.0; bndx[fr] = -1; rbs[fr] = 0; type[fr] = 0;
      } else if (nd.strand[j] == 1) {
        int max_rb = pick_rb(j);
        if (nd.cscore[j] + wt * ti.rbs_wt[max_rb] +
                wt * ti.type_wt[nd.type[j]] >= best[fr]) {
          best[fr] = nd.cscore[j] + wt * ti.rbs_wt[max_rb];
          best[fr] += wt * ti.type_wt[nd.type[j]];
          bndx[fr] = j;
          type[fr] = nd.type[j];
          rbs[fr] = max_rb;
        }
      }
    }

    // reverse strand pass
    for (int j = 0; j < 3; j++) {
      best[j] = 0.0; bndx[j] = -1; rbs[j] = 0; type[j] = 0;
    }
    for (int j = nn - 1; j >= 0; j--) {
      if (nd.type[j] != kTypeStop && nd.edge[j] == 1) continue;
      int fr = nd.ndx[j] % 3;
      if (nd.type[j] == kTypeStop && nd.strand[j] == -1) {
        if (best[fr] >= sthresh && nd.ndx[bndx[fr]] % 3 == fr) {
          rreal[rbs[fr]] += 1.0;
          treal[type[fr]] += 1.0;
          if (i == 9)
            count_upstream_composition(sq.rcode.data(), slen, -1,
                                       nd.ndx[bndx[fr]], ti);
        }
        best[fr] = 0.0; bndx[fr] = -1; rbs[fr] = 0; type[fr] = 0;
      } else if (nd.strand[j] == -1) {
        int max_rb = pick_rb(j);
        if (nd.cscore[j] + wt * ti.rbs_wt[max_rb] +
                wt * ti.type_wt[nd.type[j]] >= best[fr]) {
          best[fr] = nd.cscore[j] + wt * ti.rbs_wt[max_rb];
          best[fr] += wt * ti.type_wt[nd.type[j]];
          bndx[fr] = j;
          type[fr] = nd.type[j];
          rbs[fr] = max_rb;
        }
      }
    }

    sum = 0.0;
    for (int j = 0; j < 28; j++) sum += rreal[j];
    if (sum == 0.0) {
      for (int j = 0; j < 28; j++) ti.rbs_wt[j] = 0.0;
    } else {
      for (int j = 0; j < 28; j++) {
        rreal[j] /= sum;
        if (rbg[j] != 0) ti.rbs_wt[j] = log(rreal[j] / rbg[j]);
        else ti.rbs_wt[j] = -4.0;
        if (ti.rbs_wt[j] > 4.0) ti.rbs_wt[j] = 4.0;
        if (ti.rbs_wt[j] < -4.0) ti.rbs_wt[j] = -4.0;
      }
    }
    sum = 0.0;
    for (int j = 0; j < 3; j++) sum += treal[j];
    if (sum == 0.0) {
      for (int j = 0; j < 3; j++) ti.type_wt[j] = 0.0;
    } else {
      for (int j = 0; j < 3; j++) {
        treal[j] /= sum;
        if (tbg[j] != 0) ti.type_wt[j] = log(treal[j] / tbg[j]);
        else ti.type_wt[j] = -4.0;
        if (ti.type_wt[j] > 4.0) ti.type_wt[j] = 4.0;
        if (ti.type_wt[j] < -4.0) ti.type_wt[j] = -4.0;
      }
    }
    if (sum <= (double)nn / 2000.0) sthresh /= 2.0;
  }
  ups_comp_to_log(ti);
}

// determine_sd_usage (`node.cpp:685-692`)
inline void determine_sd_usage(Training& ti) {
  ti.uses_sd = 1;
  if (ti.rbs_wt[0] >= 0.0) ti.uses_sd = 0;
  if (ti.rbs_wt[16] < 1.0 && ti.rbs_wt[13] < 1.0 && ti.rbs_wt[15] < 1.0 &&
      (ti.rbs_wt[0] >= -0.5 ||
       (ti.rbs_wt[22] < 2.0 && ti.rbs_wt[24] < 2.0 && ti.rbs_wt[27] < 2.0)))
    ti.uses_sd = 0;
}

// find_best_upstream_motif (`node.cpp:1192-1238`)
inline void find_best_upstream_motif(const Training& ti, const Seq& sq,
                                     Nodes& nd, int i, int stage) {
  if (nd.type[i] == kTypeStop || nd.edge[i] == 1) return;
  const uint8_t* wseq;
  int start;
  if (nd.strand[i] == 1) {
    wseq = sq.code.data();
    start = nd.ndx[i];
  } else {
    wseq = sq.rcode.data();
    start = sq.len - 1 - nd.ndx[i];
  }
  int max_spacer = 0, max_spacendx = 0, max_len = 0, max_ndx = 0;
  double max_sc = -100.0;
  for (int l = 3; l >= 0; l--) {
    for (int j = start - 18 - l; j <= start - 6 - l; j++) {
      if (j < 0) continue;
      int spacer = start - j - l - 3;
      int spacendx;
      if (j <= start - 16 - l) spacendx = 3;
      else if (j <= start - 14 - l) spacendx = 2;
      else if (j >= start - 7 - l) spacendx = 1;
      else spacendx = 0;
      int index = mer_ndx(l + 3, wseq, j);
      double score =
          ti.mot_wt[(l * 4 + spacendx) * 4096 + index];
      if (score > max_sc) {
        max_sc = score;
        max_spacendx = spacendx;
        max_spacer = spacer;
        max_ndx = index;
        max_len = l + 3;
      }
    }
  }
  if (stage == 2 && (max_sc == -4.0 || max_sc < ti.no_mot + 0.69)) {
    nd.mot_ndx[i] = 0;
    nd.mot_len[i] = 0;
    nd.mot_spacendx[i] = 0;
    nd.mot_spacer[i] = 0;
    nd.mot_score[i] = ti.no_mot;
  } else {
    nd.mot_ndx[i] = max_ndx;
    nd.mot_len[i] = max_len;
    nd.mot_spacendx[i] = max_spacendx;
    nd.mot_spacer[i] = max_spacer;
    nd.mot_score[i] = max_sc;
  }
}

// update_motif_counts (`node.cpp:1247-1294`)
inline void update_motif_counts(std::vector<double>& mcnt, double* zero,
                                const Seq& sq, const Nodes& nd, int i,
                                int stage) {
  if (nd.type[i] == kTypeStop || nd.edge[i] == 1) return;
  if (nd.mot_len[i] == 0) {
    *zero += 1.0;
    return;
  }
  const uint8_t* wseq;
  int start;
  if (nd.strand[i] == 1) {
    wseq = sq.code.data();
    start = nd.ndx[i];
  } else {
    wseq = sq.rcode.data();
    start = sq.len - 1 - nd.ndx[i];
  }
  auto at = [&](int l, int s, int n) -> double& {
    return mcnt[(l * 4 + s) * 4096 + n];
  };
  if (stage == 0) {
    for (int l = 3; l >= 0; l--) {
      for (int j = start - 18 - l; j <= start - 6 - l; j++) {
        if (j < 0) continue;
        int spacendx;
        if (j <= start - 16 - l) spacendx = 3;
        else if (j <= start - 14 - l) spacendx = 2;
        else if (j >= start - 7 - l) spacendx = 1;
        else spacendx = 0;
        (void)spacendx;
        for (int k = 0; k < 4; k++) at(l, k, mer_ndx(l + 3, wseq, j)) += 1.0;
      }
    }
  } else if (stage == 1) {
    at(nd.mot_len[i] - 3, nd.mot_spacendx[i], nd.mot_ndx[i]) += 1.0;
    for (int l = 0; l < nd.mot_len[i] - 3; l++) {
      for (int j = start - nd.mot_spacer[i] - nd.mot_len[i];
           j <= start - nd.mot_spacer[i] - (l + 3); j++) {
        if (j < 0) continue;
        int spacendx;
        if (j <= start - 16 - l) spacendx = 3;
        else if (j <= start - 14 - l) spacendx = 2;
        else if (j >= start - 7 - l) spacendx = 1;
        else spacendx = 0;
        at(l, spacendx, mer_ndx(l + 3, wseq, j)) += 1.0;
      }
    }
  } else if (stage == 2) {
    at(nd.mot_len[i] - 3, nd.mot_spacendx[i], nd.mot_ndx[i]) += 1.0;
  }
}

// build_coverage_map (`node.cpp:1306-1366`)
inline void build_coverage_map(const std::vector<double>& real,
                               std::vector<int>& good, double ng) {
  double thresh = 0.2;
  good.assign(4 * 4 * 4096, 0);
  auto r = [&](int l, int s, int n) { return real[(l * 4 + s) * 4096 + n]; };
  auto g = [&](int l, int s, int n) -> int& {
    return good[(l * 4 + s) * 4096 + n];
  };
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 64; j++) {
      if (r(0, i, j) / ng >= thresh)
        for (int k = 0; k < 4; k++) g(0, k, j) = 1;
    }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 256; j++) {
      int d0 = (j & 252) >> 2, d1 = j & 63;
      if (g(0, i, d0) == 0 || g(0, i, d1) == 0) continue;
      g(1, i, j) = 1;
    }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 1024; j++) {
      int d0 = (j & 1008) >> 4, d1 = (j & 252) >> 2, d2 = j & 63;
      if (g(0, i, d0) == 0 || g(0, i, d1) == 0 || g(0, i, d2) == 0) continue;
      g(2, i, j) = 1;
      int tmp = j;
      for (int k = 0; k <= 16; k += 16) {
        tmp = tmp ^ k;
        for (int l = 0; l <= 32; l += 32) {
          tmp = tmp ^ l;
          if (g(2, i, tmp) == 0) g(2, i, tmp) = 2;
        }
      }
    }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4096; j++) {
      int d0 = (j & 4092) >> 2, d1 = j & 1023;
      if (g(2, i, d0) == 0 || g(2, i, d1) == 0) continue;
      if (g(2, i, d0) == 1 && g(2, i, d1) == 1) g(3, i, j) = 1;
      else g(3, i, j) = 2;
    }
}

// train_starts_nonsd (`node.cpp:937-1145`)
inline void train_starts_nonsd(const Seq& sq, Nodes& nd, Training& ti) {
  int nn = nd.n(), slen = sq.len;
  double wt = ti.st_wt, sthresh = 35.0;
  double tbg[3], treal[3], best[3];
  int bndx[3];
  std::vector<double> mbg(4 * 4 * 4096), mreal(4 * 4 * 4096);
  std::vector<int> mgood(4 * 4 * 4096, 0);
  double zbg, zreal;

  for (int i = 0; i < 32; i++)
    for (int j = 0; j < 4; j++) ti.ups_comp[i][j] = 0.0;

  for (int i = 0; i < 3; i++) ti.type_wt[i] = 0.0;
  for (int i = 0; i < 3; i++) tbg[i] = 0.0;
  for (int i = 0; i < nn; i++) {
    if (nd.type[i] == kTypeStop) continue;
    tbg[nd.type[i]] += 1.0;
  }
  double sum = 0.0;
  for (int i = 0; i < 3; i++) sum += tbg[i];
  for (int i = 0; i < 3; i++) tbg[i] /= sum;

  for (int i = 0; i < 20; i++) {
    int stage = i < 4 ? 0 : (i < 12 ? 1 : 2);

    std::fill(mbg.begin(), mbg.end(), 0.0);
    zbg = 0.0;
    for (int j = 0; j < nn; j++) {
      if (nd.type[j] == kTypeStop || nd.edge[j] == 1) continue;
      find_best_upstream_motif(ti, sq, nd, j, stage);
      update_motif_counts(mbg, &zbg, sq, nd, j, stage);
    }
    sum = 0.0;
    for (double v : mbg) sum += v;
    sum += zbg;
    for (double& v : mbg) v /= sum;
    zbg /= sum;

    std::fill(mreal.begin(), mreal.end(), 0.0);
    zreal = 0.0;
    for (int j = 0; j < 3; j++) treal[j] = 0.0;
    double ngenes = 0.0;

    // forward strand pass
    for (int j = 0; j < 3; j++) {
      best[j] = 0.0;
      bndx[j] = -1;
    }
    for (int j = 0; j < nn; j++) {
      if (nd.type[j] != kTypeStop && nd.edge[j] == 1) continue;
      int fr = nd.ndx[j] % 3;
      if (nd.type[j] == kTypeStop && nd.strand[j] == 1) {
        if (best[fr] >= sthresh) {
          ngenes += 1.0;
          treal[nd.type[bndx[fr]]] += 1.0;
          update_motif_counts(mreal, &zreal, sq, nd, bndx[fr], stage);
          if (i == 19)
            count_upstream_composition(sq.code.data(), slen, 1,
                                       nd.ndx[bndx[fr]], ti);
        }
        best[fr] = 0.0;
        bndx[fr] = -1;
      } else if (nd.strand[j] == 1) {
        if (nd.cscore[j] + wt * nd.mot_score[j] +
                wt * ti.type_wt[nd.type[j]] >= best[fr]) {
          best[fr] = nd.cscore[j] + wt * nd.mot_score[j];
          best[fr] += wt * ti.type_wt[nd.type[j]];
          bndx[fr] = j;
        }
      }
    }

    // reverse strand pass
    for (int j = 0; j < 3; j++) {
      best[j] = 0.0;
      bndx[j] = -1;
    }
    for (int j = nn - 1; j >= 0; j--) {
      if (nd.type[j] != kTypeStop && nd.edge[j] == 1) continue;
      int fr = nd.ndx[j] % 3;
      if (nd.type[j] == kTypeStop && nd.strand[j] == -1) {
        if (best[fr] >= sthresh) {
          ngenes += 1.0;
          treal[nd.type[bndx[fr]]] += 1.0;
          update_motif_counts(mreal, &zreal, sq, nd, bndx[fr], stage);
          if (i == 19)
            count_upstream_composition(sq.rcode.data(), slen, -1,
                                       nd.ndx[bndx[fr]], ti);
        }
        best[fr] = 0.0;
        bndx[fr] = -1;
      } else if (nd.strand[j] == -1) {
        if (nd.cscore[j] + wt * nd.mot_score[j] +
                wt * ti.type_wt[nd.type[j]] >= best[fr]) {
          best[fr] = nd.cscore[j] + wt * nd.mot_score[j];
          best[fr] += wt * ti.type_wt[nd.type[j]];
          bndx[fr] = j;
        }
      }
    }

    if (stage < 2) build_coverage_map(mreal, mgood, ngenes);
    sum = 0.0;
    for (double v : mreal) sum += v;
    sum += zreal;
    if (sum == 0.0) {
      std::fill(ti.mot_wt.begin(), ti.mot_wt.end(), 0.0);
      ti.no_mot = 0.0;
    } else {
      for (int j = 0; j < 4; j++)
        for (int k = 0; k < 4; k++)
          for (int l = 0; l < 4096; l++) {
            int idx = (j * 4 + k) * 4096 + l;
            if (mgood[idx] == 0) {
              zreal += mreal[idx];
              zbg += mreal[idx];
              mreal[idx] = 0.0;
              mbg[idx] = 0.0;
            }
            mreal[idx] /= sum;
            if (mbg[idx] != 0) ti.mot_wt[idx] = log(mreal[idx] / mbg[idx]);
            else ti.mot_wt[idx] = -4.0;
            if (ti.mot_wt[idx] > 4.0) ti.mot_wt[idx] = 4.0;
            if (ti.mot_wt[idx] < -4.0) ti.mot_wt[idx] = -4.0;
          }
    }
    zreal /= sum;
    if (zbg != 0) ti.no_mot = log(zreal / zbg);
    else ti.no_mot = -4.0;
    if (ti.no_mot > 4.0) ti.no_mot = 4.0;
    if (ti.no_mot < -4.0) ti.no_mot = -4.0;
    sum = 0.0;
    for (int j = 0; j < 3; j++) sum += treal[j];
    if (sum == 0.0) {
      for (int j = 0; j < 3; j++) ti.type_wt[j] = 0.0;
    } else {
      for (int j = 0; j < 3; j++) {
        treal[j] /= sum;
        if (tbg[j] != 0) ti.type_wt[j] = log(treal[j] / tbg[j]);
        else ti.type_wt[j] = -4.0;
        if (ti.type_wt[j] > 4.0) ti.type_wt[j] = 4.0;
        if (ti.type_wt[j] < -4.0) ti.type_wt[j] = -4.0;
      }
    }
    if (sum <= (double)nn / 2000.0) sthresh /= 2.0;
  }
  ups_comp_to_log(ti);
}

// score_nodes, single mode (`node.cpp:374-520`; is_meta branches are dead
// here and the closed==0 edge conversions unreachable under closed=1)
inline void score_nodes(const Seq& sq, Nodes& nd, const Training& ti,
                        int is_meta = 0) {
  int nn = nd.n(), slen = sq.len;
  calc_orf_gc(sq, nd);
  raw_coding_score(sq, nd, ti);
  if (ti.uses_sd == 1) {
    rbs_score(sq, nd, ti);
  } else {
    for (int i = 0; i < nn; i++) {
      if (nd.type[i] == kTypeStop || nd.edge[i] == 1) continue;
      find_best_upstream_motif(ti, sq, nd, i, 2);
    }
  }
  for (int i = 0; i < nn; i++) {
    if (nd.type[i] == kTypeStop) continue;
    double edge_gene = 0;
    if (nd.edge[i] == 1) edge_gene++;
    if ((nd.strand[i] == 1 &&
         !is_stop_tt(sq.code.data(), nd.stop_val[i], ti.trans_table)) ||
        (nd.strand[i] == -1 &&
         !is_stop_tt(sq.rcode.data(), slen - 1 - nd.stop_val[i],
                     ti.trans_table)))
      edge_gene++;

    if (nd.edge[i] == 1) {
      nd.tscore[i] = kEdgeBonus * ti.st_wt / edge_gene;
      nd.uscore[i] = 0.0;
      nd.rscore[i] = 0.0;
    } else {
      nd.tscore[i] = ti.type_wt[nd.type[i]] * ti.st_wt;
      double rbs1 = ti.rbs_wt[nd.rbs0[i]];
      double rbs2 = ti.rbs_wt[nd.rbs1[i]];
      double sd_score = dmax(rbs1, rbs2) * ti.st_wt;
      if (ti.uses_sd == 1) {
        nd.rscore[i] = sd_score;
      } else {
        nd.rscore[i] = ti.st_wt * nd.mot_score[i];
        if (nd.rscore[i] < sd_score && ti.no_mot > -0.5)
          nd.rscore[i] = sd_score;
      }
      if (nd.strand[i] == 1)
        score_upstream_composition(sq.code.data(), slen, nd, i, ti);
      else
        score_upstream_composition(sq.rcode.data(), slen, nd, i, ti);

      // closed=1: the open-edge upstream penalties reduce to the
      // edge-stop scan branches
      if (i < 500 && nd.strand[i] == 1) {
        for (int j = i - 1; j >= 0; j--)
          if (nd.edge[j] == 1 && nd.stop_val[i] == nd.stop_val[j]) {
            nd.uscore[i] += kEdgeUps * ti.st_wt;
            break;
          }
      } else if (i >= nn - 500 && nd.strand[i] == -1) {
        for (int j = i + 1; j < nn; j++)
          if (nd.edge[j] == 1 && nd.stop_val[i] == nd.stop_val[j]) {
            nd.uscore[i] += kEdgeUps * ti.st_wt;
            break;
          }
      }
    }

    // (closed=1: no base-1/slen start -> edge gene conversion)

    if (nd.edge[i] == 0 && edge_gene == 1)
      nd.uscore[i] -= 0.5 * kEdgeBonus * ti.st_wt;

    if (edge_gene == 0 && abs(nd.ndx[i] - nd.stop_val[i]) < 250) {
      double negf = 250.0 / (float)abs(nd.ndx[i] - nd.stop_val[i]);
      double posf = (float)abs(nd.ndx[i] - nd.stop_val[i]) / 250.0;
      if (nd.rscore[i] < 0) nd.rscore[i] *= negf;
      if (nd.uscore[i] < 0) nd.uscore[i] *= negf;
      if (nd.tscore[i] < 0) nd.tscore[i] *= negf;
      if (nd.rscore[i] > 0) nd.rscore[i] *= posf;
      if (nd.uscore[i] > 0) nd.uscore[i] *= posf;
      if (nd.tscore[i] > 0) nd.tscore[i] *= posf;
    }

    // Coding penalization in metagenomic fragments (`node.cpp:488-491`;
    // NB `abs(ndx - stop_val < 120)` is the reference's own
    // operator-precedence quirk, replicated verbatim)
    if (is_meta == 1 && slen < 3000 && edge_gene == 0 &&
        (nd.cscore[i] < 5.0 || abs(nd.ndx[i] - nd.stop_val[i] < 120)))
      nd.cscore[i] -= kMetaPen * dmax(0, (3000 - slen) / 2700.0);

    nd.sscore[i] = nd.tscore[i] + nd.rscore[i] + nd.uscore[i];

    if (nd.cscore[i] < 0.0) {
      if (edge_gene > 0 && nd.edge[i] == 0) {
        if (is_meta == 0 || slen > 1500) {
          nd.sscore[i] -= ti.st_wt;
        } else {
          nd.sscore[i] -= (10.31 - 0.004 * slen);
        }
      } else if (is_meta == 1 && slen < 3000 && nd.edge[i] == 1) {
        double min_meta_len = sqrt((double)slen) * 5.0;
        if (abs(nd.ndx[i] - nd.stop_val[i]) >= min_meta_len) {
          if (nd.cscore[i] >= 0) nd.cscore[i] = -1.0;
          nd.sscore[i] = 0.0;
          nd.uscore[i] = 0.0;
        }
      } else {
        nd.sscore[i] -= 0.5;
      }
    } else if (nd.cscore[i] < 5.0 && is_meta == 1 &&
               abs(nd.ndx[i] - nd.stop_val[i] < 120) && nd.sscore[i] < 0.0) {
      nd.sscore[i] -= ti.st_wt;
    }
  }
}

// ------------------------------------------------------------------- genes
struct Genes {
  std::vector<int> begin, end, start_ndx, stop_ndx;
  int n() const { return (int)begin.size(); }
  void clear() {
    begin.clear();
    end.clear();
    start_ndx.clear();
    stop_ndx.clear();
  }
};

// add_genes (`gene.cpp:24-56`)
inline void add_genes(Genes& g, const Nodes& nd, int dbeg) {
  g.clear();
  if (dbeg == -1) return;
  int path = dbeg;
  while (nd.traceb[path] != -1) path = nd.traceb[path];
  int cb = 0, cs = 0;  // pending begin/start_ndx of the open gene
  bool open = false;
  while (path != -1) {
    if (nd.elim[path] == 1) {
      path = nd.tracef[path];
      continue;
    }
    if (nd.strand[path] == 1 && nd.type[path] != kTypeStop) {
      cb = nd.ndx[path] + 1;
      cs = path;
      open = true;
    }
    if (nd.strand[path] == -1 && nd.type[path] == kTypeStop) {
      cb = nd.ndx[path] - 1;
      g.begin.push_back(cb);
      g.end.push_back(0);
      g.start_ndx.push_back(-1);
      g.stop_ndx.push_back(path);
      open = true;
    }
    if (nd.strand[path] == 1 && nd.type[path] == kTypeStop && open) {
      g.begin.push_back(cb);
      g.end.push_back(nd.ndx[path] + 3);
      g.start_ndx.push_back(cs);
      g.stop_ndx.push_back(path);
      open = false;
    }
    if (nd.strand[path] == -1 && nd.type[path] != kTypeStop && open &&
        !g.begin.empty() && g.start_ndx.back() == -1) {
      g.end.back() = nd.ndx[path] + 1;
      g.start_ndx.back() = path;
      open = false;
    }
    path = nd.tracef[path];
  }
  // an unterminated trailing record (reference leaves ctr un-incremented)
  if (!g.begin.empty() && (g.start_ndx.back() == -1 || g.end.back() == 0)) {
    g.begin.pop_back();
    g.end.pop_back();
    g.start_ndx.pop_back();
    g.stop_ndx.pop_back();
  }
}

// tweak_final_starts (`gene.cpp:70-225`)
inline void tweak_final_starts(Genes& g, Nodes& nd, const Training& ti) {
  int ng = g.n(), nn = nd.n();
  for (int i = 0; i < ng; i++) {
    int ndx = g.start_ndx[i];
    double sc = nd.sscore[ndx] + nd.cscore[ndx];
    double igm = 0.0;
    if (i > 0 && nd.strand[ndx] == 1 &&
        nd.strand[g.start_ndx[i - 1]] == 1)
      igm = intergenic_mod(nd, g.stop_ndx[i - 1], ndx, ti);
    if (i > 0 && nd.strand[ndx] == 1 &&
        nd.strand[g.start_ndx[i - 1]] == -1)
      igm = intergenic_mod(nd, g.start_ndx[i - 1], ndx, ti);
    if (i < ng - 1 && nd.strand[ndx] == -1 &&
        nd.strand[g.start_ndx[i + 1]] == 1)
      igm = intergenic_mod(nd, ndx, g.start_ndx[i + 1], ti);
    if (i < ng - 1 && nd.strand[ndx] == -1 &&
        nd.strand[g.start_ndx[i + 1]] == -1)
      igm = intergenic_mod(nd, ndx, g.stop_ndx[i + 1], ti);

    int maxndx[2] = {-1, -1};
    double maxsc[2] = {0, 0}, maxigm[2] = {0, 0};
    for (int j = ndx - 100; j < ndx + 100; j++) {
      if (j < 0 || j >= nn || j == ndx) continue;
      if (nd.type[j] == kTypeStop || nd.stop_val[j] != nd.stop_val[ndx])
        continue;
      double tigm = 0.0;
      if (i > 0 && nd.strand[j] == 1 && nd.strand[g.start_ndx[i - 1]] == 1) {
        if (nd.ndx[g.stop_ndx[i - 1]] - nd.ndx[j] > kMaxSameOvlp) continue;
        tigm = intergenic_mod(nd, g.stop_ndx[i - 1], j, ti);
      }
      if (i > 0 && nd.strand[j] == 1 &&
          nd.strand[g.start_ndx[i - 1]] == -1) {
        if (nd.ndx[g.start_ndx[i - 1]] - nd.ndx[j] >= 0) continue;
        tigm = intergenic_mod(nd, g.start_ndx[i - 1], j, ti);
      }
      if (i < ng - 1 && nd.strand[j] == -1 &&
          nd.strand[g.start_ndx[i + 1]] == 1) {
        if (nd.ndx[j] - nd.ndx[g.start_ndx[i + 1]] >= 0) continue;
        tigm = intergenic_mod(nd, j, g.start_ndx[i + 1], ti);
      }
      if (i < ng - 1 && nd.strand[j] == -1 &&
          nd.strand[g.start_ndx[i + 1]] == -1) {
        if (nd.ndx[j] - nd.ndx[g.stop_ndx[i + 1]] > kMaxSameOvlp) continue;
        tigm = intergenic_mod(nd, j, g.stop_ndx[i + 1], ti);
      }
      if (maxndx[0] == -1) {
        maxndx[0] = j;
        maxsc[0] = nd.cscore[j] + nd.sscore[j];
        maxigm[0] = tigm;
      } else if (nd.cscore[j] + nd.sscore[j] + tigm > maxsc[0]) {
        maxndx[1] = maxndx[0];
        maxsc[1] = maxsc[0];
        maxigm[1] = maxigm[0];
        maxndx[0] = j;
        maxsc[0] = nd.cscore[j] + nd.sscore[j];
        maxigm[0] = tigm;
      } else if (maxndx[1] == -1 ||
                 nd.cscore[j] + nd.sscore[j] + tigm > maxsc[1]) {
        maxndx[1] = j;
        maxsc[1] = nd.cscore[j] + nd.sscore[j];
        maxigm[1] = tigm;
      }
    }

    for (int j = 0; j < 2; j++) {
      int mndx = maxndx[j];
      if (mndx == -1) continue;
      if (nd.tscore[mndx] < nd.tscore[ndx] &&
          maxsc[j] - nd.tscore[mndx] >= sc - nd.tscore[ndx] + ti.st_wt &&
          nd.rscore[mndx] > nd.rscore[ndx] &&
          nd.uscore[mndx] > nd.uscore[ndx] &&
          nd.cscore[mndx] > nd.cscore[ndx] &&
          abs(nd.ndx[mndx] - nd.ndx[ndx]) > 15) {
        maxsc[j] += nd.tscore[ndx] - nd.tscore[mndx];
      } else if (abs(nd.ndx[mndx] - nd.ndx[ndx]) <= 15 &&
                 nd.rscore[mndx] + nd.tscore[mndx] >
                     nd.rscore[ndx] + nd.tscore[ndx] &&
                 nd.edge[ndx] == 0 && nd.edge[mndx] == 0) {
        if (nd.cscore[ndx] > nd.cscore[mndx])
          maxsc[j] += nd.cscore[ndx] - nd.cscore[mndx];
        if (nd.uscore[ndx] > nd.uscore[mndx])
          maxsc[j] += nd.uscore[ndx] - nd.uscore[mndx];
        if (igm > maxigm[j]) maxsc[j] += igm - maxigm[j];
      } else {
        maxsc[j] = -1000.0;
      }
    }

    int mndx = -1;
    for (int j = 0; j < 2; j++) {
      if (maxndx[j] == -1) continue;
      if (mndx == -1 && maxsc[j] + maxigm[j] > sc + igm) mndx = j;
      else if (mndx >= 0 && maxsc[j] + maxigm[j] > maxsc[mndx] + maxigm[mndx])
        mndx = j;
    }
    if (mndx != -1 && nd.strand[maxndx[mndx]] == 1) {
      g.start_ndx[i] = maxndx[mndx];
      g.begin[i] = nd.ndx[maxndx[mndx]] + 1;
    } else if (mndx != -1 && nd.strand[maxndx[mndx]] == -1) {
      g.start_ndx[i] = maxndx[mndx];
      g.end[i] = nd.ndx[maxndx[mndx]] + 1;
    }
  }
}

// ------------------------------------------------------------------ driver
// ProdigalWrapper::trainASpecies (`ProdigalWrapper.cpp:54-127`)
inline void train_single(const unsigned char* raw, int64_t len, Training& ti) {
  Seq sq;
  encode_seq(raw, len, sq);
  ti = Training();
  ti.gc = sq.gc;
  Nodes nd;
  add_nodes(sq, nd);
  std::vector<int> gp = gc_frame_plot(sq);
  record_gc_bias(gp, nd, ti);
  record_overlapping_starts(nd, ti, 0);
  int ipath = dprog(nd, ti, 0);
  calc_dicodon_gene(ti, sq, nd, ipath);
  raw_coding_score(sq, nd, ti);
  rbs_score(sq, nd, ti);
  train_starts_sd(sq, nd, ti);
  determine_sd_usage(ti);
  if (ti.uses_sd == 0) train_starts_nonsd(sq, nd, ti);
}

// ProdigalWrapper::getPredictedGenes single-mode path
// (`ProdigalWrapper.cpp:188-240`)
inline void predict_genes(const unsigned char* raw, int64_t len,
                          const Training& ti, Nodes& nd, Genes& g) {
  Seq sq;
  encode_seq(raw, len, sq);
  nd.clear();
  add_nodes(sq, nd);
  score_nodes(sq, nd, ti);
  record_overlapping_starts(nd, ti, 1);
  int ipath = dprog(nd, ti, 1);
  eliminate_bad_genes(nd, ipath, ti);
  add_genes(g, nd, ipath);
  tweak_final_starts(g, nd, ti);
}

// ---- metagenomic mode ----------------------------------------------
// ProdigalWrapper::trainMeta (`ProdigalWrapper.cpp:129-186`): run every
// GC-compatible precomputed bin over the sequence, keep the bin whose
// optimal dprog path scores highest; getPredictedGenes then predicts with
// that bin (`ProdigalWrapper.cpp:217-250`). The bins themselves are the
// reference's training.cpp blob, MISSING from this checkout
// (/root/reference/.MISSING_LARGE_BLOBS) — they load from an external
// file (pdg_meta_load) whose records mirror struct _training field order.

inline void read_training_record(FILE* f, Training& ti) {
  auto rd = [&](void* dst, size_t n) {
    if (fread(dst, 1, n, f) != n) {
      memset(dst, 0, n);
    }
  };
  rd(&ti.gc, 8);
  int32_t tt = 11, sd = 0;
  rd(&tt, 4);
  ti.trans_table = tt;
  rd(&ti.st_wt, 8);
  rd(ti.bias, 24);
  rd(ti.type_wt, 24);
  rd(&sd, 4);
  ti.uses_sd = sd;
  rd(ti.rbs_wt, 28 * 8);
  rd(ti.ups_comp, 128 * 8);
  rd(ti.mot_wt.data(), 4 * 4 * 4096 * 8);
  rd(&ti.no_mot, 8);
  rd(ti.gene_dc, 4096 * 8);
}

inline void write_training_record(FILE* f, const Training& ti) {
  fwrite(&ti.gc, 8, 1, f);
  int32_t tt = ti.trans_table, sd = ti.uses_sd;
  fwrite(&tt, 4, 1, f);
  fwrite(&ti.st_wt, 8, 1, f);
  fwrite(ti.bias, 24, 1, f);
  fwrite(ti.type_wt, 24, 1, f);
  fwrite(&sd, 4, 1, f);
  fwrite(ti.rbs_wt, 28 * 8, 1, f);
  fwrite(ti.ups_comp, 128 * 8, 1, f);
  fwrite(ti.mot_wt.data(), 4 * 4 * 4096 * 8, 1, f);
  fwrite(&ti.no_mot, 8, 1, f);
  fwrite(ti.gene_dc, 4096 * 8, 1, f);
}

// trainMeta: returns the winning bin index (-1 if nothing scored)
inline int train_meta(const Seq& sq, const std::vector<Training>& bins,
                      Nodes& nd) {
  double gc = sq.gc;
  double low = 0.88495 * gc - 0.0102337;
  if (low > 0.65) low = 0.65;
  double high = 0.86596 * gc + .1131991;
  if (high < 0.35) high = 0.35;
  double max_score = -100.0;
  int max_phase = -1;
  for (size_t i = 0; i < bins.size(); i++) {
    if (i == 0 ||
        bins[i].trans_table != bins[i - 1].trans_table) {
      nd.clear();
      add_nodes(sq, nd, bins[i].trans_table);
    }
    if (bins[i].gc < low || bins[i].gc > high) continue;
    // reset_node_scores (`node.cpp:175-196`)
    int nn = nd.n();
    for (int j = 0; j < nn; j++) {
      nd.star0[j] = 0; nd.star1[j] = 0; nd.star2[j] = 0;
      nd.gcs0[j] = 0; nd.gcs1[j] = 0; nd.gcs2[j] = 0;
      nd.rbs0[j] = 0; nd.rbs1[j] = 0;
      nd.score[j] = 0; nd.cscore[j] = 0; nd.sscore[j] = 0;
      nd.rscore[j] = 0; nd.tscore[j] = 0; nd.uscore[j] = 0;
      nd.traceb[j] = -1; nd.tracef[j] = -1; nd.ov_mark[j] = -1;
      nd.elim[j] = 0; nd.gc_bias[j] = 0;
      nd.mot_ndx[j] = 0; nd.mot_len[j] = 0; nd.mot_spacer[j] = 0;
      nd.mot_spacendx[j] = 0; nd.mot_score[j] = 0;
    }
    score_nodes(sq, nd, bins[i], 1);
    record_overlapping_starts(nd, bins[i], 1);
    int ipath = dprog(nd, bins[i], 1);
    if (ipath == -1) continue;
    if (nd.score[ipath] > max_score) {
      max_phase = (int)i;
      max_score = nd.score[ipath];
    }
  }
  return max_phase;
}

// getPredictedGenes, meta path (`ProdigalWrapper.cpp:217-250`)
inline void predict_genes_meta(const unsigned char* raw, int64_t len,
                               const Training& ti, Nodes& nd, Genes& g) {
  Seq sq;
  encode_seq(raw, len, sq);
  nd.clear();
  add_nodes(sq, nd, ti.trans_table);
  score_nodes(sq, nd, ti, 1);
  record_overlapping_starts(nd, ti, 1);
  int ipath = dprog(nd, ti, 1);
  eliminate_bad_genes(nd, ipath, ti);
  add_genes(g, nd, ipath);
  tweak_final_starts(g, nd, ti);
}

// ProdigalWrapper::removeCompletelyOverlappingGenes
// (`ProdigalWrapper.cpp:309-320`)
inline void final_genes(const Genes& g, Genes& fin) {
  fin.clear();
  int ng = g.n();
  if (ng == 0) return;
  for (int i = 0; i < ng - 1; i++) {
    if (g.begin[i] >= g.begin[i + 1]) continue;
    fin.begin.push_back(g.begin[i]);
    fin.end.push_back(g.end[i]);
    fin.start_ndx.push_back(g.start_ndx[i]);
    fin.stop_ndx.push_back(g.stop_ndx[i]);
  }
  fin.begin.push_back(g.begin[ng - 1]);
  fin.end.push_back(g.end[ng - 1]);
  fin.start_ndx.push_back(g.start_ndx[ng - 1]);
  fin.stop_ndx.push_back(g.stop_ndx[ng - 1]);
}

struct Model {
  Training ti;
};

}  // namespace pdg

// ---------------------------------------------------------------- C API
static std::mutex g_pdg_mu;
static std::map<int64_t, pdg::Model> g_pdg_models;
static int64_t g_pdg_next = 1;

static std::vector<pdg::Training> g_meta_bins;

extern "C" {

// Load the metagenomic training bins from a binary file:
//   int32 K, then K records mirroring struct _training field order
//   (gc f64, trans_table i32, st_wt f64, bias[3], type_wt[3],
//    uses_sd i32, rbs_wt[28], ups_comp[32][4], mot_wt[4][4][4096],
//    no_mot, gene_dc[4096]; doubles little-endian).
// Returns the bin count, or -1 on open failure. The reference's own 50
// bins live in lib/prodigal/training.cpp — a missing large blob in this
// checkout — so the table bytes must come from the side channel this
// loader reads (see PARITY.md).
int64_t pdg_meta_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int32_t k = 0;
  if (fread(&k, 4, 1, f) != 1 || k <= 0 || k > 4096) {
    fclose(f);
    return -1;
  }
  std::lock_guard<std::mutex> lk(g_pdg_mu);
  g_meta_bins.assign(k, pdg::Training());
  for (int32_t i = 0; i < k; i++)
    pdg::read_training_record(f, g_meta_bins[i]);
  fclose(f);
  return k;
}

// Serialize a trained model (handle) to an open bin file position —
// test support for synthesizing bin files from single-mode trainings.
int64_t pdg_meta_append(const char* path, int64_t h) {
  pdg::Model* m;
  {
    std::lock_guard<std::mutex> lk(g_pdg_mu);
    auto it = g_pdg_models.find(h);
    if (it == g_pdg_models.end()) return -1;
    m = &it->second;
  }
  FILE* f = fopen(path, "r+b");
  if (!f) {
    f = fopen(path, "w+b");
    if (!f) return -1;
  }
  int32_t k = 0;
  if (fread(&k, 4, 1, f) != 1) {
    // fresh file: lay down the count header before the first record
    k = 0;
    fseek(f, 0, SEEK_SET);
    fwrite(&k, 4, 1, f);
  }
  fseek(f, 0, SEEK_END);
  pdg::write_training_record(f, m->ti);
  k++;
  fseek(f, 0, SEEK_SET);
  fwrite(&k, 4, 1, f);
  fclose(f);
  return k;
}

// Override a trained model's trans_table (bin-file synthesis support).
int32_t pdg_set_trans_table(int64_t h, int32_t tt) {
  std::lock_guard<std::mutex> lk(g_pdg_mu);
  auto it = g_pdg_models.find(h);
  if (it == g_pdg_models.end()) return -1;
  it->second.ti.trans_table = tt;
  return 0;
}

// trainMeta (`ProdigalWrapper.cpp:129-186`): pick the best loaded bin
// for `seq` and return a model handle predicting with it (meta scoring).
// Returns -2 if no bins are loaded, -3 if no bin passes the GC window.
int64_t pdg_train_meta(const char* seq, int64_t len, int32_t* out_bin) {
  std::vector<pdg::Training> bins;
  {
    std::lock_guard<std::mutex> lk(g_pdg_mu);
    bins = g_meta_bins;
  }
  if (bins.empty()) return -2;
  pdg::Seq sq;
  pdg::encode_seq((const unsigned char*)seq, len, sq);
  pdg::Nodes nd;
  int win = pdg::train_meta(sq, bins, nd);
  if (win < 0) return -3;
  if (out_bin) *out_bin = win;
  pdg::Model m;
  m.ti = bins[win];
  m.ti.is_meta_model = 1;
  std::lock_guard<std::mutex> lk(g_pdg_mu);
  int64_t id = g_pdg_next++;
  g_pdg_models[id] = std::move(m);
  return id;
}

// Train the single-genome model on `seq`; returns a handle (>0).
int64_t pdg_train(const char* seq, int64_t len) {
  pdg::Model m;
  pdg::train_single((const unsigned char*)seq, len, m.ti);
  std::lock_guard<std::mutex> lk(g_pdg_mu);
  int64_t id = g_pdg_next++;
  g_pdg_models[id] = std::move(m);
  return id;
}

void pdg_free(int64_t h) {
  std::lock_guard<std::mutex> lk(g_pdg_mu);
  g_pdg_models.erase(h);
}

int32_t pdg_uses_sd(int64_t h) {
  std::lock_guard<std::mutex> lk(g_pdg_mu);
  auto it = g_pdg_models.find(h);
  return it == g_pdg_models.end() ? -1 : it->second.ti.uses_sd;
}

// Predict genes on `seq` with a trained model. With `final_only` != 0 the
// completely-overlapping-genes filter is applied (the list used for the
// extended-ORF blocks); otherwise the raw list (used for the intergenic
// 23-mer seed). Coordinates are the reference's 1-based begin/end; strand
// +1/-1. Returns the gene count (may exceed `cap`; only `cap` written).
int64_t pdg_predict(int64_t h, const char* seq, int64_t len,
                    int32_t* out_begin, int32_t* out_end, int32_t* out_strand,
                    int64_t cap, int32_t final_only) {
  pdg::Model* m;
  {
    std::lock_guard<std::mutex> lk(g_pdg_mu);
    auto it = g_pdg_models.find(h);
    if (it == g_pdg_models.end()) return -1;
    m = &it->second;
  }
  pdg::Nodes nd;
  pdg::Genes g, fin;
  if (m->ti.is_meta_model)
    pdg::predict_genes_meta((const unsigned char*)seq, len, m->ti, nd, g);
  else
    pdg::predict_genes((const unsigned char*)seq, len, m->ti, nd, g);
  const pdg::Genes& out = final_only ? (pdg::final_genes(g, fin), fin) : g;
  int64_t n = out.n();
  for (int64_t i = 0; i < n && i < cap; i++) {
    out_begin[i] = out.begin[i];
    out_end[i] = out.end[i];
    out_strand[i] = nd.strand[out.start_ndx[i]];
  }
  return n;
}

// Debug/differential dump: stage 0 = trained tinf summary, 1 = nodes after
// scoring, 2 = raw genes, 3 = final genes. Writes text into `out` (cap
// bytes); returns bytes written (excluding NUL) or required size.
int64_t pdg_dump(int64_t h, const char* seq, int64_t len, int32_t stage,
                 char* out, int64_t cap) {
  pdg::Model* m;
  {
    std::lock_guard<std::mutex> lk(g_pdg_mu);
    auto it = g_pdg_models.find(h);
    if (it == g_pdg_models.end()) return -1;
    m = &it->second;
  }
  std::string s;
  char buf[256];
  auto app = [&](const char* fmt, auto... a) {
    snprintf(buf, sizeof(buf), fmt, a...);
    s += buf;
  };
  if (stage == 0) {
    const pdg::Training& ti = m->ti;
    app("gc %.17g\nuses_sd %d\nno_mot %.17g\n", ti.gc, ti.uses_sd, ti.no_mot);
    app("bias %.17g %.17g %.17g\n", ti.bias[0], ti.bias[1], ti.bias[2]);
    app("type_wt %.17g %.17g %.17g\n", ti.type_wt[0], ti.type_wt[1],
        ti.type_wt[2]);
    for (int i = 0; i < 28; i++) app("rbs_wt %d %.17g\n", i, ti.rbs_wt[i]);
    for (int i = 0; i < 32; i++)
      app("ups %d %.17g %.17g %.17g %.17g\n", i, ti.ups_comp[i][0],
          ti.ups_comp[i][1], ti.ups_comp[i][2], ti.ups_comp[i][3]);
    for (int i = 0; i < 4096; i++)
      if (ti.gene_dc[i] != 0.0) app("dc %d %.17g\n", i, ti.gene_dc[i]);
    for (int j = 0; j < 4; j++)
      for (int k = 0; k < 4; k++)
        for (int l = 0; l < 4096; l++) {
          double v = ti.mot_wt[(j * 4 + k) * 4096 + l];
          if (v != 0.0) app("mot %d %d %d %.17g\n", j, k, l, v);
        }
  } else {
    pdg::Nodes nd;
    pdg::Genes g, fin;
    if (m->ti.is_meta_model)
      pdg::predict_genes_meta((const unsigned char*)seq, len, m->ti, nd, g);
    else
      pdg::predict_genes((const unsigned char*)seq, len, m->ti, nd, g);
    if (stage == 1) {
      for (int i = 0; i < nd.n(); i++)
        app("node %d %d %d %d %d %.17g %.17g %.17g %.17g %.17g %d %d\n",
            nd.ndx[i], nd.type[i], nd.strand[i], nd.stop_val[i], nd.edge[i],
            nd.cscore[i], nd.sscore[i], nd.tscore[i], nd.rscore[i],
            nd.uscore[i], nd.rbs0[i], nd.rbs1[i]);
    } else {
      const pdg::Genes& out_g = stage == 3 ? (pdg::final_genes(g, fin), fin)
                                           : g;
      for (int i = 0; i < out_g.n(); i++)
        app("gene %d %d %d\n", out_g.begin[i], out_g.end[i],
            nd.strand[out_g.start_ndx[i]]);
    }
  }
  int64_t n = (int64_t)s.size();
  if (out && cap > 0) {
    int64_t c = n < cap - 1 ? n : cap - 1;
    memcpy(out, s.data(), c);
    out[c] = 0;
  }
  return n;
}

}  // extern "C"
