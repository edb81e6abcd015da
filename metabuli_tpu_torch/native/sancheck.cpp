// Sanitizer harness: drives every native component in a standalone
// process so ASan/UBSan can run without the jaxlib interceptor conflict
// (tests/test_native_sanitize.py). The reference gates releases on an
// ASan regression run (azure-pipelines.yml:32-36); this is the repo
// counterpart for taxonomer.cpp, masker.cpp, prodigal.cpp, genepred.cpp,
// fastx.cpp and sortkeys.cpp.
//
// Usage: sancheck <dump_dir>
//   dump_dir holds the raw taxonomer_assign argument buffers written by
//   NativeTaxonomer._dump_args (manifest.txt + <name>.bin) from a real
//   classification; the other components run on synthesized inputs.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <random>
#include <string>
#include <vector>

extern "C" {
int64_t taxonomer_assign(
    int64_t n_matches, const int32_t*, const int32_t*, const int32_t*,
    const int32_t*, const int32_t*, const int32_t*, const int32_t*,
    const int32_t*, int64_t n_reads, const int64_t*, const int64_t*,
    const int32_t*, int32_t n_nodes, const int32_t*, const int64_t*,
    const int32_t*, const int64_t*, const int64_t*, int32_t, int64_t,
    const int64_t*, const int64_t*, const int32_t*, const uint8_t*, int32_t,
    int32_t, float, float, int32_t, int32_t, float, int32_t, int32_t,
    int32_t, int32_t, int32_t, int32_t, int32_t, int32_t, int32_t*, float*,
    uint8_t*, int64_t, int64_t*, int32_t*, int32_t*, int64_t*, int64_t,
    int64_t*, int32_t*, float*, int64_t*);
double tantan_lambda(double, double);
void tantan_mask(const uint8_t*, int64_t, int32_t, double, double, double,
                 double, double, double, uint8_t*);
int64_t pdg_train(const char*, int64_t);
void pdg_free(int64_t);
int64_t pdg_predict(int64_t, const char*, int64_t, int32_t*, int32_t*,
                    int32_t*, int64_t, int32_t);
uint64_t gp_xxh64(const char*, int64_t, uint64_t);
int64_t gp_minhash(const char*, int64_t, uint64_t*, int64_t);
int32_t gp_minhash_same_strand(const uint64_t*, int64_t, const uint64_t*,
                               int64_t, int64_t, int64_t);
int64_t fastx_open(const char*);
void fastx_close(int64_t);
int64_t fastx_block(int64_t, int64_t, int64_t, int64_t, uint8_t*, int64_t*,
                    uint8_t*, int64_t*, uint8_t*, uint8_t*);
void mtb_argsort_u64_pair(const uint64_t*, const uint64_t*, int64_t,
                          int64_t*);
}

namespace {

struct Dump {
  std::map<std::string, std::vector<char>> arrays;
  std::map<std::string, int64_t> scalars;
  std::map<std::string, double> fscalars;

  template <typename T>
  const T* arr(const std::string& name) const {
    auto it = arrays.find(name);
    if (it == arrays.end()) {
      fprintf(stderr, "missing array %s\n", name.c_str());
      exit(2);
    }
    return reinterpret_cast<const T*>(it->second.data());
  }
  int64_t s(const std::string& name) const {
    auto it = scalars.find(name);
    if (it == scalars.end()) {
      fprintf(stderr, "missing scalar %s\n", name.c_str());
      exit(2);
    }
    return it->second;
  }
  double f(const std::string& name) const { return fscalars.at(name); }
};

bool load_dump(const std::string& dir, Dump& d) {
  FILE* mf = fopen((dir + "/manifest.txt").c_str(), "r");
  if (!mf) return false;
  char kind[16], name[128];
  while (fscanf(mf, "%15s %127s", kind, name) == 2) {
    if (!strcmp(kind, "array")) {
      long itemsize, count;
      if (fscanf(mf, "%ld %ld", &itemsize, &count) != 2) break;
      std::vector<char> buf((size_t)itemsize * count);
      FILE* af = fopen((dir + "/" + name + ".bin").c_str(), "rb");
      if (!af) { fclose(mf); return false; }
      if (fread(buf.data(), 1, buf.size(), af) != buf.size()) {
        fclose(af); fclose(mf); return false;
      }
      fclose(af);
      d.arrays[name] = std::move(buf);
    } else if (!strcmp(kind, "scalar")) {
      long v; if (fscanf(mf, "%ld", &v) != 1) break;
      d.scalars[name] = v;
    } else {  // fscalar
      double v; if (fscanf(mf, "%lf", &v) != 1) break;
      d.fscalars[name] = v;
    }
  }
  fclose(mf);
  return true;
}

void check_taxonomer(const std::string& dir) {
  Dump d;
  if (!load_dump(dir, d)) {
    fprintf(stderr, "no taxonomer dump in %s\n", dir.c_str());
    exit(2);
  }
  int64_t n_matches = d.s("n_matches"), n_reads = d.s("n_reads");
  std::vector<int32_t> out_taxid(n_reads);
  std::vector<float> out_score(n_reads);
  std::vector<uint8_t> out_cls(n_reads);
  int64_t tc_cap = n_matches + n_reads + 1024;
  std::vector<int64_t> tc_read(tc_cap);
  std::vector<int32_t> tc_tax(tc_cap), tc_cnt(tc_cap);
  int64_t tc_used = 0;
  int64_t map_cap = d.s("em") ? 10 * n_reads : 1;
  std::vector<int64_t> mp_read(map_cap);
  std::vector<int32_t> mp_sp(map_cap);
  std::vector<float> mp_score(map_cap);
  int64_t mp_used = 0;
  int64_t rc = taxonomer_assign(
      n_matches, d.arr<int32_t>("qid"), d.arr<int32_t>("species"),
      d.arr<int32_t>("frame"), d.arr<int32_t>("pos"),
      d.arr<int32_t>("hamming"), d.arr<int32_t>("dna"),
      d.arr<int32_t>("taxid"), d.arr<int32_t>("h16"), n_reads,
      d.arr<int64_t>("read_start"), d.arr<int64_t>("read_end"),
      d.arr<int32_t>("read_len"), (int32_t)d.s("n_nodes"),
      d.arr<int32_t>("parent"), d.arr<int64_t>("euler_first"),
      d.arr<int32_t>("euler_node"), d.arr<int64_t>("sparse"),
      d.arr<int64_t>("euler_depth"), (int32_t)d.s("sparse_levels"),
      d.s("euler_len"), d.arr<int64_t>("tin"), d.arr<int64_t>("tout"),
      d.arr<int32_t>("species_of"), d.arr<uint8_t>("leafish"),
      (int32_t)d.s("eukaryota_id"), (int32_t)d.s("kmer_format"),
      (float)d.f("min_score"), (float)d.f("min_sp_score"),
      (int32_t)d.s("min_cons_cnt"), (int32_t)d.s("min_cons_cnt_euk"),
      (float)d.f("tie_ratio"), (int32_t)d.s("dna_shift"),
      (int32_t)d.s("max_codon_shift"), (int32_t)d.s("denominator"),
      (int32_t)d.s("accession_level"), (int32_t)d.s("em"),
      (int32_t)d.s("bits_per_codon"), /*threads=*/2,
      (int32_t)d.s("need_sort"), out_taxid.data(), out_score.data(),
      out_cls.data(), tc_cap, tc_read.data(), tc_tax.data(), tc_cnt.data(),
      &tc_used, map_cap, mp_read.data(), mp_sp.data(), mp_score.data(),
      &mp_used);
  if (rc != 0) { fprintf(stderr, "taxonomer_assign rc=%ld\n", (long)rc); exit(3); }
  int64_t classified = 0;
  for (int64_t i = 0; i < n_reads; i++) classified += out_cls[i];
  printf("taxonomer: %ld reads, %ld classified, %ld taxcnt rows\n",
         (long)n_reads, (long)classified, (long)tc_used);
}

std::string random_dna(std::mt19937& rng, size_t len, int repeat_every = 0) {
  static const char B[] = "ACGT";
  std::string s(len, 'A');
  for (size_t i = 0; i < len; i++) s[i] = B[rng() & 3];
  if (repeat_every > 0) {
    for (size_t i = 200; i + 40 < len; i += repeat_every)
      memcpy(&s[i], "ACGTACGTACGTACGTACGTACGTACGTACGT", 32);
  }
  return s;
}

void check_masker(std::mt19937& rng) {
  double lam = tantan_lambda(1.0, -1.0);
  std::string seq = random_dna(rng, 5000, 600);
  std::vector<uint8_t> codes(seq.size());
  for (size_t i = 0; i < seq.size(); i++)
    codes[i] = (uint8_t)(strchr("ACGT", seq[i]) - "ACGT" + 0) & 3;
  codes[17] = 7;  // neutral/N path
  std::vector<uint8_t> mask(seq.size());
  tantan_mask(codes.data(), (int64_t)codes.size(), 100, 0.005, 0.05, 0.9,
              0.5, lam * 1.0, lam * -1.0, mask.data());
  int64_t masked = 0;
  for (uint8_t m : mask) masked += m;
  printf("masker: %ld/%zu masked (lambda %.4f)\n", (long)masked,
         mask.size(), lam);
}

void check_prodigal(std::mt19937& rng) {
  std::string g = random_dna(rng, 24000);
  int64_t h = pdg_train(g.c_str(), (int64_t)g.size());
  if (h <= 0) { fprintf(stderr, "pdg_train failed\n"); exit(3); }
  std::vector<int32_t> b(4096), e(4096), st(4096);
  int64_t n = pdg_predict(h, g.c_str(), (int64_t)g.size(), b.data(),
                          e.data(), st.data(), 4096, 1);
  pdg_free(h);
  printf("prodigal: %ld genes\n", (long)n);
}

void check_genepred(std::mt19937& rng) {
  std::string a = random_dna(rng, 3000), b2 = random_dna(rng, 3000);
  uint64_t hx = gp_xxh64(a.c_str(), (int64_t)a.size(), 42);
  // cap + 1 slots: the sentinel occupies one until the first overflow
  std::vector<uint64_t> mh1(601), mh2(601);
  int64_t n1 = gp_minhash(a.c_str(), (int64_t)a.size(), mh1.data(), 600);
  int64_t n2 = gp_minhash(b2.c_str(), (int64_t)b2.size(), mh2.data(), 600);
  int32_t same = gp_minhash_same_strand(mh1.data(), n1, mh2.data(), n2,
                                        (int64_t)a.size(),
                                        (int64_t)b2.size());
  printf("genepred: xxh %016lx, minhash %ld/%ld, same %d\n",
         (unsigned long)hx, (long)n1, (long)n2, same);
}

void check_fastx(std::mt19937& rng, const std::string& dir) {
  std::string path = dir + "/san.fq";
  FILE* f = fopen(path.c_str(), "w");
  for (int i = 0; i < 64; i++) {
    std::string s = random_dna(rng, 80 + (rng() % 70));
    fprintf(f, "@r%d extra words\n%s\n+\n%s\n", i, s.c_str(),
            std::string(s.size(), 'I').c_str());
  }
  fclose(f);
  int64_t h = fastx_open(path.c_str());
  if (!h) { fprintf(stderr, "fastx_open failed\n"); exit(3); }
  std::vector<uint8_t> seq(1 << 16), name(1 << 14), qual(1 << 16);
  std::vector<int64_t> soff(257), noff(257);
  std::vector<uint8_t> has_qual(256, 0);  // one flag per record
  int64_t total = 0, got;
  while ((got = fastx_block(h, 256, (int64_t)seq.size(), (int64_t)name.size(),
                            seq.data(), soff.data(), name.data(), noff.data(),
                            qual.data(), has_qual.data())) > 0)
    total += got;
  fastx_close(h);
  printf("fastx: %ld records (qual=%d)\n", (long)total, (int)has_qual[0]);
}

void check_sortkeys(std::mt19937& rng) {
  const int64_t N = 300000;
  std::vector<uint64_t> k1(N), k2(N);
  for (int64_t i = 0; i < N; i++) { k1[i] = rng(); k2[i] = rng(); }
  std::vector<int64_t> out(N);
  mtb_argsort_u64_pair(k1.data(), k2.data(), N, out.data());
  for (int64_t i = 1; i < N; i++) {
    if (k1[out[i - 1]] > k1[out[i]]) { fprintf(stderr, "sort broken\n"); exit(3); }
  }
  mtb_argsort_u64_pair(k1.data(), nullptr, N, out.data());
  printf("sortkeys: %ld sorted\n", (long)N);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: sancheck <dump_dir>\n"); return 2; }
  std::mt19937 rng(7);
  check_taxonomer(argv[1]);
  check_masker(rng);
  check_prodigal(rng);
  check_genepred(rng);
  check_fastx(rng, argv[1]);
  check_sortkeys(rng);
  printf("SANCHECK-OK\n");
  return 0;
}
