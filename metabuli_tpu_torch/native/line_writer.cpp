// Line writer for classify: a batch's results, as columns, to the bytes of
// its classification lines, with no Python object per read.
//
// The bytes are those Reporter.write_classifications (io/report.py) writes
// for the same reads. A classified read's line is
//   [index \t] 1 \t name \t taxid \t length \t score \t rank \t [lineage \t]
//   taxid:count taxid:count ... \n
// with original taxids, the tax-count pairs in ascending internal taxid and
// a later row of one (read, taxid) in place of an earlier one (a dict's
// update, row by row); an unclassified read's line is
//   [index \t] 0 \t name \t 0 \t length \t score \t - \t [- \t] - \t \n
// The score is Python's f"{x:.6g}", which is C's "%.6g" (std::to_chars,
// free of the locale), "nan" for either sign of a NaN. One call a batch,
// without the interpreter lock: write_lines writes into the caller's
// buffer and returns the bytes written, or a negative code.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

enum : int64_t {
  kErrCapacity = -1,  // the lines do not fit the caller's buffer
  kErrTaxid = -2,     // a taxid outside the taxonomy's tables
  kErrRow = -3,       // a tax-count row of a read outside the batch
  kErrLineage = -4,   // a classified read's taxon without its lineage
};

// A cursor over the caller's buffer; a write past its end clears ok.
struct Out {
  char* p;
  char* end;
  bool ok = true;

  void put(const char* s, int64_t n) {
    if (end - p < n) {
      ok = false;
      return;
    }
    if (n) std::memcpy(p, s, (size_t)n);
    p += n;
  }
  void put(const char* s) { put(s, (int64_t)std::strlen(s)); }
  void ch(char c) { put(&c, 1); }
  template <class T>
  void num(T v) {
    auto r = std::to_chars(p, end, v);
    if (r.ec != std::errc()) {
      ok = false;
      return;
    }
    p = r.ptr;
  }
  void score(double x) {
    if (std::isnan(x)) {
      put("nan");
      return;
    }
    auto r = std::to_chars(p, end, x, std::chars_format::general, 6);
    if (r.ec != std::errc()) {
      ok = false;
      return;
    }
    p = r.ptr;
  }
};

}  // namespace

extern "C" {

// n_reads reads: cls (nonzero: classified), taxid (internal), score,
// read_len, and names[name_off[i], name_off[i + 1]). n_rows tax-count
// rows (row_read, row_taxid internal, row_count) in any order of reads.
// The taxonomy's tables over internal ids 0..n_nodes: to_original, and
// rank_id into ranks[rank_off[k], rank_off[k + 1]]. lineage_start null:
// no lineage column; else each classified read's taxon t has its lineage
// at lineages[lineage_start[t]] for lineage_len[t] bytes. with_index: each
// line starts with index_base + i and a tab.
int64_t write_lines(int64_t n_reads, const uint8_t* cls, const int32_t* taxid,
                    const double* score, const int32_t* read_len,
                    const char* names, const int64_t* name_off, int64_t n_rows,
                    const int64_t* row_read, const int32_t* row_taxid,
                    const int32_t* row_count, int32_t n_nodes,
                    const int64_t* to_original, const int32_t* rank_id,
                    const char* ranks, const int64_t* rank_off,
                    const int64_t* lineage_start, const int64_t* lineage_len,
                    const char* lineages, int32_t with_index,
                    int64_t index_base, char* out, int64_t capacity) {
  // the rows of each read, in their order (a stable counting sort)
  std::vector<int64_t> off((size_t)n_reads + 1, 0);
  for (int64_t k = 0; k < n_rows; ++k) {
    int64_t r = row_read[k];
    if (r < 0 || r >= n_reads) return kErrRow;
    ++off[(size_t)r + 1];
  }
  for (int64_t r = 0; r < n_reads; ++r) off[r + 1] += off[r];
  std::vector<int64_t> by_read((size_t)n_rows);
  {
    std::vector<int64_t> at(off.begin(), off.end() - 1);
    for (int64_t k = 0; k < n_rows; ++k) by_read[at[row_read[k]]++] = k;
  }
  auto known = [&](int32_t t) { return t >= 0 && t <= n_nodes; };

  Out o{out, out + capacity};
  std::vector<std::pair<int32_t, int64_t>> pairs;  // (taxid, row)
  for (int64_t i = 0; i < n_reads && o.ok; ++i) {
    if (with_index) {
      o.num(index_base + i);
      o.ch('\t');
    }
    o.put(cls[i] ? "1\t" : "0\t");
    o.put(names + name_off[i], name_off[i + 1] - name_off[i]);
    o.ch('\t');
    if (!cls[i]) {
      o.put("0\t");
      o.num(read_len[i]);
      o.ch('\t');
      o.score(score[i]);
      o.put(lineage_start ? "\t-\t-\t-\t\n" : "\t-\t-\t\n");
      continue;
    }
    int32_t t = taxid[i];
    if (!known(t)) return kErrTaxid;
    o.num(to_original[t]);
    o.ch('\t');
    o.num(read_len[i]);
    o.ch('\t');
    o.score(score[i]);
    o.ch('\t');
    int32_t k = rank_id[t];
    o.put(ranks + rank_off[k], rank_off[k + 1] - rank_off[k]);
    o.ch('\t');
    if (lineage_start) {
      if (lineage_start[t] < 0) return kErrLineage;
      o.put(lineages + lineage_start[t], lineage_len[t]);
      o.ch('\t');
    }
    pairs.clear();
    for (int64_t a = off[i]; a < off[i + 1]; ++a)
      pairs.emplace_back(row_taxid[by_read[a]], by_read[a]);
    // ascending taxid; of equal taxids the latest row (pairs are in row
    // order, and the sort keeps it)
    std::stable_sort(pairs.begin(), pairs.end(),
                     [](const std::pair<int32_t, int64_t>& x,
                        const std::pair<int32_t, int64_t>& y) {
                       return x.first < y.first;
                     });
    for (size_t a = 0; a < pairs.size(); ++a) {
      if (a + 1 < pairs.size() && pairs[a + 1].first == pairs[a].first)
        continue;
      int32_t u = pairs[a].first;
      if (!known(u)) return kErrTaxid;
      o.num(to_original[u]);
      o.ch(':');
      o.num(row_count[pairs[a].second]);
      o.ch(' ');
    }
    o.ch('\n');
  }
  return o.ok ? (int64_t)(o.p - out) : kErrCapacity;
}

}  // extern "C"
