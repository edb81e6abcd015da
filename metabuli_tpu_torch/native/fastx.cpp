// Native FASTA/FASTQ block reader (plain or gzip via zlib).
//
// Replaces the Python line parser on the hot input path — the counterpart
// of the reference's kseq-based KSeqWrapper (used by
// /root/reference/src/commons/KmerExtractor.cpp and QueryIndexer.cpp).
// Records are returned in bulk: one call fills caller-provided byte
// buffers (headers / sequences / qualities) plus offset arrays, so the
// Python layer does one ctypes call per batch instead of per line.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Rec {
  std::string hdr;  // without the '>' / '@' tag
  std::string seq;
  std::string qual;  // empty for FASTA
  bool is_fastq = false;
};

struct Reader {
  gzFile gz = nullptr;
  std::vector<char> buf;
  size_t pos = 0;
  size_t lim = 0;
  bool eof = false;
  int fmt = 0;  // 0 unknown, 1 fasta, 2 fastq
  Rec carry;
  bool have_carry = false;

  bool fill() {
    if (eof) return pos < lim;
    if (pos > 0) {
      memmove(buf.data(), buf.data() + pos, lim - pos);
      lim -= pos;
      pos = 0;
    }
    int n = gzread(gz, buf.data() + lim, (unsigned)(buf.size() - lim));
    if (n <= 0) {
      eof = true;
    } else {
      lim += (size_t)n;
    }
    return pos < lim;
  }

  bool getline(std::string& out) {
    out.clear();
    while (true) {
      if (pos >= lim && !fill()) return !out.empty();
      char* start = buf.data() + pos;
      size_t avail = lim - pos;
      char* nl = (char*)memchr(start, '\n', avail);
      if (nl) {
        size_t len = (size_t)(nl - start);
        out.append(start, len);
        pos += len + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(start, avail);
      pos = lim;
    }
  }

  // parse one full record; false at EOF
  bool next(Rec& rec) {
    if (have_carry) {
      rec = carry;
      have_carry = false;
      return true;
    }
    std::string hdr;
    do {
      if (!getline(hdr)) return false;
    } while (hdr.empty());
    if (fmt == 0) fmt = (hdr[0] == '@') ? 2 : 1;
    rec.hdr.assign(hdr, 1, hdr.size() - 1);
    rec.seq.clear();
    rec.qual.clear();
    rec.is_fastq = fmt == 2;
    std::string line;
    if (fmt == 2) {
      if (!getline(rec.seq)) return true;
      if (!getline(line)) return true;  // '+'
      while (rec.qual.size() < rec.seq.size() && getline(line))
        rec.qual += line;
    } else {
      while (true) {
        if (pos >= lim && !fill()) break;
        if (buf[pos] == '>') break;
        if (!getline(line)) break;
        rec.seq += line;
      }
    }
    return true;
  }
};

std::mutex g_mu;
std::map<int64_t, Reader*> g_readers;
int64_t g_next = 1;

}  // namespace

extern "C" {

int64_t fastx_open(const char* path) {
  gzFile gz = gzopen(path, "rb");
  if (!gz) return 0;
  gzbuffer(gz, 1 << 20);
  Reader* r = new Reader();
  r->gz = gz;
  r->buf.resize(1 << 20);
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t id = g_next++;
  g_readers[id] = r;
  return id;
}

void fastx_close(int64_t handle) {
  Reader* r = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_readers.find(handle);
    if (it == g_readers.end()) return;
    r = it->second;
    g_readers.erase(it);
  }
  gzclose(r->gz);
  delete r;
}

// Fill up to max_records (or until the byte caps or EOF).
// seq_off/name_off are [max_records+1] exclusive-prefix offsets; quality
// bytes (FASTQ) share the sequence offsets. Returns the record count
// (0 = EOF, -2 = a single record exceeds the caps: grow and retry).
int64_t fastx_block(int64_t handle, int64_t max_records, int64_t seq_cap,
                    int64_t name_cap, uint8_t* seq_buf, int64_t* seq_off,
                    uint8_t* name_buf, int64_t* name_off, uint8_t* qual_buf,
                    uint8_t* has_qual) {
  Reader* r;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_readers.find(handle);
    if (it == g_readers.end()) return -1;
    r = it->second;
  }
  int64_t n = 0, sp = 0, np_ = 0;
  seq_off[0] = 0;
  name_off[0] = 0;
  Rec rec;
  while (n < max_records) {
    if (!r->next(rec)) break;
    if ((int64_t)rec.seq.size() > seq_cap - sp ||
        (int64_t)rec.hdr.size() > name_cap - np_) {
      r->carry = rec;
      r->have_carry = true;
      return n > 0 ? n : -2;
    }
    memcpy(seq_buf + sp, rec.seq.data(), rec.seq.size());
    if (rec.is_fastq) {
      size_t qn = rec.qual.size() < rec.seq.size() ? rec.qual.size()
                                                   : rec.seq.size();
      memcpy(qual_buf + sp, rec.qual.data(), qn);
      has_qual[n] = 1;
    } else {
      has_qual[n] = 0;
    }
    memcpy(name_buf + np_, rec.hdr.data(), rec.hdr.size());
    sp += (int64_t)rec.seq.size();
    np_ += (int64_t)rec.hdr.size();
    seq_off[n + 1] = sp;
    name_off[n + 1] = np_;
    n++;
  }
  return n;
}

}  // extern "C"
