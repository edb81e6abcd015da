// Parallel argsort for the DB-build hot path.
//
// The reference sorts its in-memory kmer buffer with a parallel sort over
// (value, id) comparators (IndexCreator sort of Kmer arrays, Kmer.h:77-87);
// our build funnelled everything through numpy's single-threaded lexsort.
// This is the OpenMP replacement: an MSB radix partition on the primary
// key (shift picked from the observed key range, so skewed/synthetic key
// distributions still spread across buckets) followed by per-bucket
// std::sort. The original index is the final tiebreak, which makes the
// result bit-identical to a STABLE lexsort on (k2, k1).
#include <algorithm>
#include <cstdint>
#include <vector>

#include <omp.h>

namespace {

struct Entry {
  uint64_t k1, k2;
  int64_t idx;
};

}  // namespace

extern "C" {

// out[i] := index of the i-th smallest (k1, k2, i) triple.
// k2 may be null (plain stable argsort of k1).
void mtb_argsort_u64_pair(const uint64_t* k1, const uint64_t* k2, int64_t n,
                          int64_t* out) {
  if (n <= 0) return;
  if (n < (1 << 14)) {  // small: plain single-thread sort, no scratch
    std::vector<Entry> buf((size_t)n);
    for (int64_t i = 0; i < n; i++)
      buf[(size_t)i] = {k1[i], k2 ? k2[i] : 0, i};
    std::sort(buf.begin(), buf.end(), [](const Entry& a, const Entry& b) {
      if (a.k1 != b.k1) return a.k1 < b.k1;
      if (a.k2 != b.k2) return a.k2 < b.k2;
      return a.idx < b.idx;
    });
    for (int64_t i = 0; i < n; i++) out[i] = buf[(size_t)i].idx;
    return;
  }

  const int B = 11;  // 2048 buckets
  const int NB = 1 << B;

  // key range -> bucket shift (top B bits OF THE RANGE, not of the word:
  // tables whose values share a long common prefix still fan out)
  uint64_t kmin = k1[0], kmax = k1[0];
#pragma omp parallel for schedule(static) reduction(min : kmin) \
    reduction(max : kmax)
  for (int64_t i = 0; i < n; i++) {
    if (k1[i] < kmin) kmin = k1[i];
    if (k1[i] > kmax) kmax = k1[i];
  }
  uint64_t range = kmax - kmin;
  int bits = range ? 64 - __builtin_clzll(range) : 0;
  int shift = bits > B ? bits - B : 0;

  int nt = omp_get_max_threads();
  std::vector<Entry> buf((size_t)n);
  std::vector<int64_t> hist((size_t)nt * NB, 0);

  // per-thread histograms; schedule(static) over the same bounds twice
  // guarantees each thread re-visits exactly its counted elements.
#pragma omp parallel
  {
    int t = omp_get_thread_num();
    int64_t* h = hist.data() + (size_t)t * NB;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; i++) h[(k1[i] - kmin) >> shift]++;
  }

  std::vector<int64_t> bucket_start((size_t)NB + 1, 0);
  {
    int64_t run = 0;
    for (int b = 0; b < NB; b++) {
      bucket_start[(size_t)b] = run;
      for (int t = 0; t < nt; t++) {
        int64_t& c = hist[(size_t)t * NB + b];
        int64_t cnt = c;
        c = run;
        run += cnt;
      }
    }
    bucket_start[(size_t)NB] = run;
  }

#pragma omp parallel
  {
    int t = omp_get_thread_num();
    int64_t* h = hist.data() + (size_t)t * NB;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; i++) {
      int64_t b = (int64_t)((k1[i] - kmin) >> shift);
      Entry& e = buf[(size_t)h[b]++];
      e.k1 = k1[i];
      e.k2 = k2 ? k2[i] : 0;
      e.idx = i;
    }
  }

#pragma omp parallel for schedule(dynamic, 1)
  for (int b = 0; b < NB; b++) {
    std::sort(buf.begin() + bucket_start[(size_t)b],
              buf.begin() + bucket_start[(size_t)b + 1],
              [](const Entry& a, const Entry& c) {
                if (a.k1 != c.k1) return a.k1 < c.k1;
                if (a.k2 != c.k2) return a.k2 < c.k2;
                return a.idx < c.idx;
              });
  }

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) out[i] = buf[(size_t)i].idx;
}

}  // extern "C"
