// Native per-read taxonomic assignment.
//
// C++ port of the framework's host-side Taxonomer (semantics documented in
// /root/reference/src/commons/Taxonomer.cpp; see classify/taxonomer.py for
// the annotated reference mapping). Operates on flat match arrays sorted by
// (read, species, frame, pos, hamming, dna) and a dense-internal-ID
// taxonomy with Euler-tour + sparse-table LCA. OpenMP-parallel over reads.
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct TaxView {
  int32_t n_nodes;
  const int32_t* parent;
  const int64_t* euler_first;
  const int32_t* euler_node;
  const int64_t* sparse;  // [levels][euler_len]
  const int64_t* euler_depth;
  int32_t sparse_levels;
  int64_t euler_len;
  const int64_t* tin;
  const int64_t* tout;
  const uint8_t* rank_leafish;
  int32_t eukaryota_id;

  int32_t lca2(int32_t a, int32_t b) const {
    if (a <= 0) return b;
    if (b <= 0) return a;
    int64_t fa = euler_first[a], fb = euler_first[b];
    int64_t lo = fa < fb ? fa : fb;
    int64_t hi = fa < fb ? fb : fa;
    int64_t len = hi - lo + 1;
    int k = 63 - __builtin_clzll((uint64_t)len);
    int64_t left = sparse[(int64_t)k * euler_len + lo];
    int64_t right = sparse[(int64_t)k * euler_len + hi - ((int64_t)1 << k) + 1];
    int64_t idx = euler_depth[right] < euler_depth[left] ? right : left;
    return euler_node[idx];
  }

  bool is_ancestor(int32_t anc, int32_t child) const {
    if (anc <= 0 || child <= 0) return false;
    return tin[anc] <= tin[child] && tout[child] <= tout[anc];
  }
};

struct Params {
  int32_t kmer_format;
  float min_score;
  float min_sp_score;
  int32_t min_cons_cnt;
  int32_t min_cons_cnt_euk;
  float tie_ratio;
  int32_t dna_shift;
  int32_t max_codon_shift;
  int32_t denominator;
  int32_t accession_level;
  int32_t em_mode;
  // 3/24 for the standard alphabet, 4/32 for --reduced-aa
  // (Taxonomer.cpp:50-57)
  int32_t bits_per_codon;
  int32_t total_dna_bits;
};

struct MatchView {
  const int32_t *qid, *species, *frame, *pos, *hamming, *dna, *taxid, *h16;
};

struct Path {
  int32_t start, end;
  float score;
  int32_t hamming;
  int32_t depth;
  int64_t start_idx, end_idx;  // match indices for trim scoring
};

static inline float match_score(int32_t h16) {
  float s = 0.f;
  for (int i = 0; i < 8; ++i) {
    int h = (h16 >> (2 * i)) & 3;
    s += (h == 0) ? 3.0f : 2.0f - 0.5f * (float)h;
  }
  return s;
}

static inline float score_increment(int32_t h16, int shift) {
  float s = 0.f;
  for (int i = 0; i < shift; ++i) {
    int h = (h16 >> (2 * i)) & 3;
    s += (h == 0) ? 3.0f : 2.0f - 0.5f * (float)h;
  }
  return s;
}

static inline int hamming_increment(int32_t h16, int shift) {
  int s = 0;
  for (int i = 0; i < shift; ++i) s += (h16 >> (2 * i)) & 3;
  return s;
}

static inline int right_part_hamming(int32_t h16, int range) {
  int s = 0;
  for (int i = 0; i < range; ++i) s += (h16 >> (2 * i)) & 3;
  return s;
}

static inline int left_part_hamming(int32_t h16, int range) {
  int s = 0;
  for (int i = 0; i < range; ++i) s += (h16 >> (14 - 2 * i)) & 3;
  return s;
}

static inline float right_part_score(int32_t h16, int range) {
  float s = 0.f;
  for (int i = 0; i < range; ++i) {
    int h = (h16 >> (2 * i)) & 3;
    s += (h == 0) ? 3.0f : 2.0f - 0.5f * (float)h;
  }
  return s;
}

static inline float left_part_score(int32_t h16, int range) {
  float s = 0.f;
  for (int i = 0; i < range; ++i) {
    int h = (h16 >> (14 - 2 * i)) & 3;
    s += (h == 0) ? 3.0f : 2.0f - 0.5f * (float)h;
  }
  return s;
}

// getMatchPaths: DP over consecutive position groups in [start, end)
static void get_match_paths(const MatchView& m, int64_t start, int64_t end,
                            const TaxView& tax, const Params& par,
                            int32_t species_id, std::vector<Path>& out,
                            std::vector<Path>& local,
                            std::vector<uint8_t>& connected) {
  int min_depth = par.min_cons_cnt;
  if (tax.eukaryota_id && tax.is_ancestor(tax.eukaryota_id, species_id))
    min_depth = par.min_cons_cnt_euk;
  bool forward = m.frame[start] < 3;
  int max_shift = par.max_codon_shift;

  local.clear();
  connected.assign(end - start, 0);
  for (int64_t j = start; j < end; ++j) {
    Path p;
    p.start = m.pos[j];
    p.end = m.pos[j] + 23;
    p.score = match_score(m.h16[j]);
    p.hamming = m.hamming[j];
    p.depth = 1;
    p.start_idx = j;
    p.end_idx = j;
    local.push_back(p);
  }

  int64_t i = start;
  int32_t cur_pos = m.pos[start];
  int64_t cur_s = i;
  while (i < end && m.pos[i] == cur_pos) ++i;
  int64_t cur_e = i;
  while (i < end) {
    int32_t next_pos = m.pos[i];
    int64_t nxt_s = i;
    while (i < end && m.pos[i] == next_pos) ++i;
    int64_t nxt_e = i;
    int shift = (next_pos - cur_pos) / 3;
    if (shift > 0 && shift <= max_shift) {
      const int bpc = par.bits_per_codon;
      uint32_t mask =
          (uint32_t)(((uint64_t)1 << (par.total_dna_bits - bpc * shift)) - 1);
      for (int64_t nj = nxt_s; nj < nxt_e; ++nj) {
        float inc = score_increment(m.h16[nj], shift);
        const Path* best = nullptr;
        float best_score = 0.f;
        for (int64_t cj = cur_s; cj < cur_e; ++cj) {
          // isConsecutive2 (new format) / isConsecutive (old format);
          // operand order swaps for reverse frames
          int64_t a = forward ? cj : nj;
          int64_t b = forward ? nj : cj;
          bool ok;
          if (par.kmer_format == 2)
            ok = ((uint32_t)m.dna[a] & mask) ==
                 ((uint32_t)m.dna[b] >> (bpc * shift));
          else
            ok = ((uint32_t)m.dna[a] >> (bpc * shift)) ==
                 ((uint32_t)m.dna[b] & mask);
          if (ok) {
            connected[cj - start] = 1;
            const Path& lp = local[cj - start];
            if (lp.score > best_score) {
              best = &lp;
              best_score = lp.score;
            }
          }
        }
        if (best) {
          Path& ln = local[nj - start];
          ln.start = best->start;
          ln.score = best->score + inc;
          ln.hamming = best->hamming + hamming_increment(m.h16[nj], shift);
          ln.depth = best->depth + shift;
          ln.start_idx = best->start_idx;
        }
      }
    }
    for (int64_t cj = cur_s; cj < cur_e; ++cj)
      if (!connected[cj - start] && local[cj - start].depth >= min_depth)
        out.push_back(local[cj - start]);
    if (i == end)
      for (int64_t nj = nxt_s; nj < nxt_e; ++nj)
        if (local[nj - start].depth >= min_depth)
          out.push_back(local[nj - start]);
    cur_s = nxt_s;
    cur_e = nxt_e;
    cur_pos = next_pos;
  }
}

// combineMatchPaths: greedy non-overlap combination with <24bp trims
static float combine_paths(const MatchView& m, std::vector<Path>& paths,
                           int read_len, std::vector<Path>& combined) {
  std::sort(paths.begin(), paths.end(), [](const Path& a, const Path& b) {
    if (a.score != b.score) return a.score > b.score;
    if (a.hamming != b.hamming) return a.hamming < b.hamming;
    return a.start > b.start;
  });
  combined.clear();
  float total = 0.f;
  for (Path& path : paths) {
    bool overlapped = false;
    for (const Path& comb : combined) {
      if (path.end < comb.start || comb.end < path.start) continue;
      int ov = std::min(path.end, comb.end) - std::max(path.start, comb.start) + 1;
      if (ov == path.end - path.start + 1) {
        overlapped = true;
        break;
      }
      if (ov < 24) {
        if (path.start < comb.start) {
          path.end = comb.start - 1;
          path.hamming = std::max(
              0, path.hamming - right_part_hamming(m.h16[path.end_idx], ov / 3));
          path.score = path.score - right_part_score(m.h16[path.end_idx], ov / 3) -
                       (float)(ov % 3);
        } else {
          path.start = comb.end + 1;
          path.hamming = std::max(
              0, path.hamming - left_part_hamming(m.h16[path.start_idx], ov / 3));
          path.score = path.score - left_part_score(m.h16[path.start_idx], ov / 3) -
                       (float)(ov % 3);
        }
        continue;
      }
      overlapped = true;
      break;
    }
    if (!overlapped) {
      combined.push_back(path);
      total += path.score;
    }
  }
  return total / (float)read_len;
}

struct ReadResult {
  uint8_t classified = 0;
  int32_t taxid = 0;
  float score = 0.f;
  std::vector<std::pair<int32_t, int32_t>> tax_counts;
  std::vector<std::pair<int32_t, float>> mappings;  // (species, score^2)
};

// lowerRankClassification: clade counts under the species + BFS descent
// (`/root/reference/src/commons/Taxonomer.cpp:252-314`)
static int32_t lower_rank_bfs(
    const std::vector<std::pair<int32_t, int32_t>>& tax_counts,
    int32_t species, int32_t read_len, const TaxView& tax,
    const int32_t* parent, const Params& par) {
  int32_t threshold = (read_len - 1) / par.denominator;
  std::unordered_map<int32_t, int32_t> clade;
  std::unordered_map<int32_t, std::vector<int32_t>> children;
  for (auto& tc : tax_counts) {
    int32_t node = tc.first;
    int32_t c = tc.second;
    clade[node] += c;
    int guard = 0;
    while (node != species && guard < 64) {
      int32_t p = parent[node];
      auto& ch = children[p];
      if (std::find(ch.begin(), ch.end(), node) == ch.end()) ch.push_back(node);
      clade[p] += c;
      if (p == node) break;
      node = p;
      ++guard;
    }
  }
  if (!clade.count(species)) return species;
  if (par.accession_level == 2) {
    for (auto& kv : clade) {
      if (tax.rank_leafish && tax.rank_leafish[kv.first]) {
        auto& ch = children[parent[kv.first]];
        auto it = std::find(ch.begin(), ch.end(), kv.first);
        if (it != ch.end()) ch.erase(it);
      }
    }
  }
  int32_t root = species;
  while (true) {
    auto cit = children.find(root);
    if (cit == children.end() || cit->second.empty()) break;
    int32_t best_child = 0;
    int n_best = 0;
    int32_t cur_max = threshold;
    for (int32_t ch : cit->second) {
      auto cc = clade.find(ch);
      int32_t cnt = cc == clade.end() ? 0 : cc->second;
      if (cnt > cur_max) {
        best_child = ch;
        n_best = 1;
        cur_max = cnt;
      } else if (cnt == cur_max) {
        ++n_best;
        best_child = ch;
      }
    }
    if (n_best == 1) {
      root = best_child;
    } else {
      break;
    }
  }
  return root;
}

static void choose_best_taxon(const MatchView& m, int64_t lo, int64_t hi,
                              int32_t read_len, const TaxView& tax,
                              const int32_t* species_of, const int32_t* parent,
                              const Params& par, ReadResult& res,
                              std::vector<Path>& paths, std::vector<Path>& local,
                              std::vector<uint8_t>& connected,
                              std::vector<Path>& combined) {
  // ---- getBestSpeciesMatches
  std::vector<std::pair<int32_t, float>> sp2score;
  float best_sp_score = 0.f;
  int64_t best_lo = 0, best_hi = 0;
  int meaningful = 0;

  int64_t i = lo;
  while (i < hi) {
    int32_t cur_sp = m.species[i];
    int64_t sp_start = i;
    paths.clear();
    while (i < hi && m.species[i] == cur_sp) {
      int32_t cur_frame = m.frame[i];
      int64_t f_start = i;
      while (i < hi && m.species[i] == cur_sp && m.frame[i] == cur_frame) ++i;
      if (i - f_start > 1)
        get_match_paths(m, f_start, i, tax, par, cur_sp, paths, local, connected);
    }
    if (!paths.empty()) {
      float score = combine_paths(m, paths, read_len, combined);
      score = std::min(score, 1.0f);
      if (score < par.min_score) continue;
      sp2score.emplace_back(cur_sp, score);
      if (score > 0.f) ++meaningful;
      if (score > best_sp_score) {
        best_sp_score = score;
        best_lo = sp_start;
        best_hi = i;
      }
    }
  }

  if (meaningful == 0) {
    res.classified = 0;
    res.taxid = 0;
    res.score = 0.f;
    return;
  }

  if (par.em_mode && !sp2score.empty()) {
    auto ordered = sp2score;
    std::sort(ordered.begin(), ordered.end(),
              [](const std::pair<int32_t, float>& a,
                 const std::pair<int32_t, float>& b) { return a.second > b.second; });
    for (size_t k = 0; k < ordered.size() && k < 10; ++k)
      res.mappings.emplace_back(ordered[k].first,
                                ordered[k].second * ordered[k].second);
  }

  std::vector<int32_t> max_species;
  float total = 0.f;
  for (auto& ss : sp2score)
    if (ss.second >= best_sp_score * par.tie_ratio) {
      max_species.push_back(ss.first);
      total += ss.second;
    }

  int32_t best_taxid;
  bool lca_flag = false;
  if (max_species.size() > 1) {
    int32_t l = 0;
    for (int32_t sp : max_species) l = tax.lca2(l, sp);
    best_taxid = l;
    total = total / (float)max_species.size();
    lca_flag = true;
  } else {
    best_taxid = max_species[0];
  }

  float score = total;
  if (score == 0.f || score < par.min_score) {
    res.classified = 0;
    res.taxid = 0;
    res.score = score;
    return;
  }
  if (lca_flag) {
    res.classified = 1;
    res.taxid = best_taxid;
    res.score = score;
    return;
  }

  // ---- filterRedundantMatches over the best species range
  std::unordered_map<int32_t, std::pair<int32_t, int32_t>> best_q;  // q -> (tax, ham)
  best_q.reserve(64);
  for (int64_t j = best_lo; j < best_hi; ++j) {
    int32_t q = m.pos[j] / par.dna_shift;
    int32_t h = m.hamming[j];
    auto it = best_q.find(q);
    if (it == best_q.end()) {
      best_q.emplace(q, std::make_pair(m.taxid[j], h));
    } else if (h < it->second.second) {
      it->second = std::make_pair(m.taxid[j], h);
    } else if (h == it->second.second) {
      it->second.first = tax.lca2(it->second.first, m.taxid[j]);
    }
  }
  std::unordered_map<int32_t, int32_t> tax_cnt;
  tax_cnt.reserve(best_q.size());
  for (auto& kv : best_q) ++tax_cnt[kv.second.first];
  res.tax_counts.assign(tax_cnt.begin(), tax_cnt.end());
  std::sort(res.tax_counts.begin(), res.tax_counts.end());

  if (score < par.min_sp_score) {
    int32_t sp = species_of[best_taxid];
    res.classified = 1;
    res.taxid = parent[sp];
    res.score = score;
    return;
  }

  res.classified = 1;
  res.score = score;
  if (par.em_mode) {
    res.taxid = best_taxid;
    return;
  }

  res.taxid = lower_rank_bfs(res.tax_counts, best_taxid, read_len, tax,
                             parent, par);
}

}  // namespace

extern "C" {

int64_t taxonomer_assign(
    // matches
    int64_t n_matches, const int32_t* qid, const int32_t* species,
    const int32_t* frame, const int32_t* pos, const int32_t* hamming,
    const int32_t* dna, const int32_t* taxid, const int32_t* h16,
    // reads
    int64_t n_reads, const int64_t* read_start, const int64_t* read_end,
    const int32_t* read_len,
    // taxonomy
    int32_t n_nodes, const int32_t* parent, const int64_t* euler_first,
    const int32_t* euler_node, const int64_t* sparse,
    const int64_t* euler_depth, int32_t sparse_levels, int64_t euler_len,
    const int64_t* tin, const int64_t* tout, const int32_t* species_of,
    const uint8_t* rank_leafish, int32_t eukaryota_id,
    // params
    int32_t kmer_format,
    float min_score, float min_sp_score, int32_t min_cons_cnt,
    int32_t min_cons_cnt_euk, float tie_ratio, int32_t dna_shift,
    int32_t max_codon_shift, int32_t denominator, int32_t accession_level,
    int32_t em_mode, int32_t bits_per_codon, int32_t n_threads,
    int32_t need_sort,
    // outputs
    int32_t* out_taxid, float* out_score, uint8_t* out_classified,
    int64_t taxcnt_capacity, int64_t* taxcnt_read, int32_t* taxcnt_taxid,
    int32_t* taxcnt_cnt, int64_t* taxcnt_used, int64_t map_capacity,
    int64_t* map_read, int32_t* map_species, float* map_score,
    int64_t* map_used) {
  TaxView tax{n_nodes,    parent,       euler_first, euler_node,
              sparse,     euler_depth,  sparse_levels, euler_len,
              tin,        tout,         rank_leafish, eukaryota_id};
  Params par{kmer_format,
             min_score,      min_sp_score, min_cons_cnt, min_cons_cnt_euk,
             tie_ratio,      dna_shift,    max_codon_shift, denominator,
             accession_level, em_mode,     bits_per_codon,
             bits_per_codon == 4 ? 32 : 24};
  MatchView m{qid, species, frame, pos, hamming, dna, taxid, h16};

  std::atomic<int64_t> taxcnt_cursor{0};
  std::atomic<int64_t> map_cursor{0};
  std::atomic<int64_t> overflow{0};

#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads(n_threads);
#endif

  // Per-read sort into the reference match order (KmerMatcher.cpp:1149-1166)
  // when the device pipeline skipped its global sort. Rows may arrive in
  // ANY read order (the two-tier candidate path appends its re-gathered
  // rows at the tail), so first counting-sort indices into the caller's
  // per-read bins (read_start/read_end from a qid bincount), then each
  // read's slice gets the full comparator sort. Reads are independent, so
  // this replaces a device-wide sort with one O(n) pass + parallel
  // read-sized sorts.
  std::vector<int32_t> s_q, s_sp, s_f, s_pos, s_h, s_d, s_t, s_h16;
  std::vector<int64_t> binned;
  if (need_sort && n_matches > 0) {
    binned.resize(n_matches);
    {
      std::vector<int64_t> cursor(n_reads);
      for (int64_t r = 0; r < n_reads; ++r) cursor[r] = read_start[r];
      for (int64_t i = 0; i < n_matches; ++i) {
        int32_t q = qid[i];
        if (q >= 0 && q < n_reads) binned[cursor[q]++] = i;
      }
    }
    s_q.resize(n_matches);
    s_sp.resize(n_matches);
    s_f.resize(n_matches);
    s_pos.resize(n_matches);
    s_h.resize(n_matches);
    s_d.resize(n_matches);
    s_t.resize(n_matches);
    s_h16.resize(n_matches);
#pragma omp parallel
    {
#pragma omp for schedule(dynamic, 64)
      for (int64_t r = 0; r < n_reads; ++r) {
        int64_t lo = read_start[r], hi = read_end[r];
        if (lo >= hi) continue;
        std::sort(binned.begin() + lo, binned.begin() + hi,
                  [&](int64_t a, int64_t b) {
          if (species[a] != species[b]) return species[a] < species[b];
          if (frame[a] != frame[b]) return frame[a] < frame[b];
          if (pos[a] != pos[b]) return pos[a] < pos[b];
          if (hamming[a] != hamming[b]) return hamming[a] < hamming[b];
          return (uint32_t)dna[a] < (uint32_t)dna[b];
        });
        for (int64_t k = lo; k < hi; ++k) {
          int64_t j = binned[k];
          s_q[k] = (int32_t)r;
          s_sp[k] = species[j];
          s_f[k] = frame[j];
          s_pos[k] = pos[j];
          s_h[k] = hamming[j];
          s_d[k] = dna[j];
          s_t[k] = taxid[j];
          s_h16[k] = h16[j];
        }
      }
    }
    m = MatchView{s_q.data(),   s_sp.data(), s_f.data(), s_pos.data(),
                  s_h.data(),   s_d.data(),  s_t.data(), s_h16.data()};
  }

#pragma omp parallel
  {
    std::vector<Path> paths, local, combined;
    std::vector<uint8_t> connected;
#pragma omp for schedule(dynamic, 64)
    for (int64_t r = 0; r < n_reads; ++r) {
      out_taxid[r] = 0;
      out_score[r] = 0.f;
      out_classified[r] = 0;
      int64_t lo = read_start[r], hi = read_end[r];
      if (lo >= hi) continue;
      ReadResult res;
      choose_best_taxon(m, lo, hi, read_len[r], tax, species_of, parent, par,
                        res, paths, local, connected, combined);
      out_taxid[r] = res.taxid;
      out_score[r] = res.score;
      out_classified[r] = res.classified;
      if (!res.tax_counts.empty()) {
        int64_t at = taxcnt_cursor.fetch_add((int64_t)res.tax_counts.size());
        if (at + (int64_t)res.tax_counts.size() <= taxcnt_capacity) {
          for (size_t k = 0; k < res.tax_counts.size(); ++k) {
            taxcnt_read[at + k] = r;
            taxcnt_taxid[at + k] = res.tax_counts[k].first;
            taxcnt_cnt[at + k] = res.tax_counts[k].second;
          }
        } else {
          overflow.fetch_add(1);
        }
      }
      if (em_mode && !res.mappings.empty()) {
        int64_t at = map_cursor.fetch_add((int64_t)res.mappings.size());
        if (at + (int64_t)res.mappings.size() <= map_capacity) {
          for (size_t k = 0; k < res.mappings.size(); ++k) {
            map_read[at + k] = r;
            map_species[at + k] = res.mappings[k].first;
            map_score[at + k] = res.mappings[k].second;
          }
        } else {
          overflow.fetch_add(1);
        }
      }
    }
  }
  *taxcnt_used = std::min(taxcnt_cursor.load(), taxcnt_capacity);
  *map_used = std::min(map_cursor.load(), map_capacity);
  return overflow.load() ? -1 : 0;
}

// Host finish for the fused device taxonomer: per-(read, species) combined
// scores + per-(read, species, taxid) quotient counts -> per-read
// classifications (the tail of Taxonomer::chooseBestTaxon,
// /root/reference/src/commons/Taxonomer.cpp:130-202, after the device did
// chaining/combination/redundancy). Mirrors DeviceTaxonomer._finish.
int64_t taxonomer_finish(
    // per-(read, species) combined scores
    int64_t n_groups, const int32_t* g_read, const int32_t* g_species,
    const float* g_score,
    // per-(read, species, taxid) quotient counts
    int64_t n_taxcnt, const int32_t* t_read, const int32_t* t_species,
    const int32_t* t_taxid, const int32_t* t_count,
    // reads
    int64_t n_reads, const int32_t* read_len,
    // taxonomy
    int32_t n_nodes, const int32_t* parent, const int64_t* euler_first,
    const int32_t* euler_node, const int64_t* sparse,
    const int64_t* euler_depth, int32_t sparse_levels, int64_t euler_len,
    const int64_t* tin, const int64_t* tout, const int32_t* species_of,
    const uint8_t* rank_leafish, int32_t eukaryota_id,
    // params
    float min_score, float min_sp_score, float tie_ratio,
    int32_t denominator, int32_t accession_level, int32_t em_mode,
    int32_t n_threads,
    // outputs
    int32_t* out_taxid, float* out_score, uint8_t* out_classified,
    int64_t taxcnt_capacity, int64_t* taxcnt_read, int32_t* taxcnt_taxid,
    int32_t* taxcnt_cnt, int64_t* taxcnt_used,
    int64_t map_capacity, int64_t* map_read, int32_t* map_species,
    float* map_score, int64_t* map_used) {
  TaxView tax{n_nodes,    parent,       euler_first, euler_node,
              sparse,     euler_depth,  sparse_levels, euler_len,
              tin,        tout,         rank_leafish, eukaryota_id};
  Params par{};
  par.denominator = denominator;
  par.accession_level = accession_level;

  // bin groups and taxcnt rows by read (counting sort; inputs are compact
  // device tensors in grid order, not guaranteed read-major)
  std::vector<int64_t> g_off(n_reads + 1, 0), t_off(n_reads + 1, 0);
  for (int64_t i = 0; i < n_groups; ++i)
    if (g_read[i] >= 0 && g_read[i] < n_reads) ++g_off[g_read[i] + 1];
  for (int64_t i = 0; i < n_taxcnt; ++i)
    if (t_read[i] >= 0 && t_read[i] < n_reads) ++t_off[t_read[i] + 1];
  for (int64_t r = 0; r < n_reads; ++r) {
    g_off[r + 1] += g_off[r];
    t_off[r + 1] += t_off[r];
  }
  std::vector<int64_t> g_idx(n_groups), t_idx(n_taxcnt);
  {
    std::vector<int64_t> gc(g_off.begin(), g_off.end() - 1);
    std::vector<int64_t> tc(t_off.begin(), t_off.end() - 1);
    for (int64_t i = 0; i < n_groups; ++i)
      if (g_read[i] >= 0 && g_read[i] < n_reads) g_idx[gc[g_read[i]]++] = i;
    for (int64_t i = 0; i < n_taxcnt; ++i)
      if (t_read[i] >= 0 && t_read[i] < n_reads) t_idx[tc[t_read[i]]++] = i;
  }

  std::atomic<int64_t> map_cursor{0};
  std::atomic<int64_t> taxcnt_cursor{0};
  std::atomic<int64_t> overflow{0};
#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads(n_threads);
#endif
#pragma omp parallel
  {
    std::vector<int64_t> grp;
    std::vector<std::pair<int32_t, int32_t>> tax_cnt;
#pragma omp for schedule(dynamic, 64)
    for (int64_t r = 0; r < n_reads; ++r) {
      out_taxid[r] = 0;
      out_score[r] = 0.f;
      out_classified[r] = 0;
      grp.clear();
      for (int64_t a = g_off[r]; a < g_off[r + 1]; ++a) {
        int64_t i = g_idx[a];
        if (g_score[i] >= min_score) grp.push_back(i);
      }
      if (grp.empty()) continue;
      // species-ascending accumulation order (reference encounter order)
      std::sort(grp.begin(), grp.end(), [&](int64_t a, int64_t b) {
        return g_species[a] < g_species[b];
      });
      float best = 0.f;
      int meaningful = 0;
      for (int64_t i : grp) {
        if (g_score[i] > best) best = g_score[i];
        if (g_score[i] > 0.f) ++meaningful;
      }
      if (meaningful == 0) continue;
      int n_tied = 0;
      float sum_tied = 0.f;
      int32_t winner = 0;
      int32_t lca_acc = 0;
      float tie_cut = best * tie_ratio;
      for (int64_t i : grp) {
        if (g_score[i] >= tie_cut) {
          ++n_tied;
          sum_tied = sum_tied + g_score[i];
          winner = g_species[i];
          lca_acc = tax.lca2(lca_acc, g_species[i]);
        }
      }
      if (em_mode) {
        std::vector<std::pair<int32_t, float>> ordered;
        ordered.reserve(grp.size());
        for (int64_t i : grp) ordered.emplace_back(g_species[i], g_score[i]);
        std::stable_sort(ordered.begin(), ordered.end(),
                         [](const std::pair<int32_t, float>& a,
                            const std::pair<int32_t, float>& b) {
                           return a.second > b.second;
                         });
        size_t n_map = std::min<size_t>(10, ordered.size());
        int64_t at = map_cursor.fetch_add((int64_t)n_map);
        if (at + (int64_t)n_map <= map_capacity) {
          for (size_t kk = 0; kk < n_map; ++kk) {
            map_read[at + kk] = r;
            map_species[at + kk] = ordered[kk].first;
            map_score[at + kk] = ordered[kk].second * ordered[kk].second;
          }
        } else {
          overflow.fetch_add(1);
        }
      }
      if (n_tied > 1) {
        float score = sum_tied / (float)n_tied;
        out_score[r] = score;
        if (score == 0.f || score < min_score) continue;
        out_classified[r] = 1;
        out_taxid[r] = lca_acc;
        continue;
      }
      float score = sum_tied;
      out_score[r] = score;
      if (score == 0.f || score < min_score) continue;
      out_classified[r] = 1;
      // the winner's per-taxid quotient counts (reported for parity with
      // ReadClassification.tax_counts, and input to the BFS below)
      tax_cnt.clear();
      for (int64_t a = t_off[r]; a < t_off[r + 1]; ++a) {
        int64_t i = t_idx[a];
        if (t_species[i] == winner)
          tax_cnt.emplace_back(t_taxid[i], t_count[i]);
      }
      std::sort(tax_cnt.begin(), tax_cnt.end());
      if (!tax_cnt.empty()) {
        int64_t at = taxcnt_cursor.fetch_add((int64_t)tax_cnt.size());
        if (at + (int64_t)tax_cnt.size() <= taxcnt_capacity) {
          for (size_t kk = 0; kk < tax_cnt.size(); ++kk) {
            taxcnt_read[at + kk] = r;
            taxcnt_taxid[at + kk] = tax_cnt[kk].first;
            taxcnt_cnt[at + kk] = tax_cnt[kk].second;
          }
        } else {
          overflow.fetch_add(1);
        }
      }
      if (score < min_sp_score) {
        int32_t sp = species_of[winner];
        out_taxid[r] = parent[sp];
        continue;
      }
      if (em_mode) {
        out_taxid[r] = winner;
        continue;
      }
      out_taxid[r] = lower_rank_bfs(tax_cnt, winner, read_len[r], tax,
                                    parent, par);
    }
  }
  *taxcnt_used = std::min(taxcnt_cursor.load(), taxcnt_capacity);
  *map_used = std::min(map_cursor.load(), map_capacity);
  return overflow.load() ? -1 : 0;
}

}  // extern "C"
