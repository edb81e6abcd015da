// Batch reader for classify: FASTA/FASTQ (plain or gzip, through zlib) to a
// batch's host arrays, with no Python object per read.
//
// Semantics are those of the Python record parser (io/fasta.py,
// _read_records_py) followed by the classifier's batching: the format from
// the stream's first byte ('>' FASTA, '@' FASTQ, else the caller's hint
// from the file name); lines split on '\n' with trailing '\r's dropped;
// blank lines skipped before a FASTQ header; multi-line FASTA, whose lines
// before the first header are dropped; a FASTQ header that does not start
// with '@', or a missing '+' line, is an error; a pair ends when file 1
// does, and file 2 ending first is an error. A batch ends at batch_reads
// reads, or before the read that would pass batch_bases bases (if set; at
// least one read a batch).
//
// Two calls a batch, both without the interpreter lock: br_read parses the
// batch into the reader's staging and returns its sizes; br_fill writes it
// into arrays of those sizes: the padded code matrix (through the caller's
// 256-entry code table, padding with the caller's pad code), row lengths,
// position offsets (0 for mate 1, usedLen(mate 1) + 3 for mate 2), qids,
// read lengths (usedLen(mate 1) + usedLen(mate 2)), mate 1's raw headers
// with offsets, and the names cut from plain printable-ASCII headers, each
// followed by '\n'. A header with any other byte is listed in `slow`, its
// name left empty, for the caller to cut.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

enum : int64_t {
  kEnd = 0,
  kErrHeader = -1,  // a FASTQ header that does not start with '@'
  kErrPlus = -2,    // a FASTQ record without its '+' line
  kErrPairs = -3,   // file 2 ended before file 1
  kErrRead = -4,    // zlib failed to read (a truncated or corrupt gzip)
  kErrSizes = -5,   // br_fill's arrays are not the batch's sizes
};

constexpr size_t kChunk = 1 << 20;

struct Rec {
  std::string hdr;  // without its '>' or '@'
  std::string seq;
};

// One input file: a buffer of decompressed bytes, read a line at a time.
struct Stream {
  gzFile gz = nullptr;
  std::vector<char> buf = std::vector<char>(kChunk);
  size_t pos = 0, lim = 0;  // unread bytes are buf[pos, lim)
  bool eof = false;
  bool failed = false;
  int fmt = 0;  // 0 not known yet, 1 FASTA, 2 FASTQ
  bool fastq_hint = false;  // the format when the first byte names none
  int64_t consumed = 0;
  // FASTA: the header that ended the previous record
  std::string next_hdr;
  bool have_next = false;

  // Read more into the buffer, moving the unread bytes to its front and
  // growing it when full; false at the end of the stream or on an error.
  bool more() {
    if (eof) return false;
    if (pos > 0) {
      memmove(buf.data(), buf.data() + pos, lim - pos);
      lim -= pos;
      pos = 0;
    }
    if (lim == buf.size()) buf.resize(buf.size() * 2);
    size_t room = std::min(buf.size() - lim, (size_t)INT_MAX);
    int got = gzread(gz, buf.data() + lim, (unsigned)room);
    if (got > 0) {
      lim += (size_t)got;
      return true;
    }
    eof = true;
    int err = Z_OK;
    gzerror(gz, &err);
    failed = got < 0 || (err != Z_OK && err != Z_STREAM_END);
    return false;
  }

  // The next line without its '\n' and its trailing '\r's, valid until the
  // next call; false at the end of the stream.
  bool line(const char*& p, size_t& n) {
    size_t scanned = 0;
    while (true) {
      char* s = buf.data() + pos;
      size_t avail = lim - pos;
      char* nl = avail > scanned
                     ? (char*)memchr(s + scanned, '\n', avail - scanned)
                     : nullptr;
      if (nl == nullptr) {
        scanned = avail;
        if (more()) continue;
        if (avail == 0) return false;
      }
      s = buf.data() + pos;
      size_t len = nl ? (size_t)(nl - s) : lim - pos;
      size_t step = len + (nl ? 1 : 0);
      pos += step;
      consumed += (int64_t)step;
      while (len > 0 && s[len - 1] == '\r') --len;
      p = s;
      n = len;
      return true;
    }
  }

  int format() {
    if (fmt == 0) {
      if (pos == lim) more();
      char c = pos < lim ? buf[pos] : 0;
      fmt = c == '>' ? 1 : c == '@' ? 2 : fastq_hint ? 2 : 1;
    }
    return fmt;
  }

  // The next record: 1, kEnd at the end of the stream, or an error.
  int64_t next(Rec& r, std::string& err) {
    int64_t k = format() == 2 ? next_fastq(r, err) : next_fasta(r);
    return failed ? kErrRead : k;
  }

  int64_t next_fastq(Rec& r, std::string& err) {
    const char* p;
    size_t n;
    do {
      if (!line(p, n)) return kEnd;
    } while (n == 0);
    if (p[0] != '@') {
      err.assign(p, std::min(n, (size_t)50));
      return kErrHeader;
    }
    r.hdr.assign(p + 1, n - 1);
    if (line(p, n))
      r.seq.assign(p, n);
    else
      r.seq.clear();
    if (!line(p, n) || n == 0 || p[0] != '+') return kErrPlus;
    line(p, n);  // the quality line
    return 1;
  }

  int64_t next_fasta(Rec& r) {
    const char* p;
    size_t n;
    while (!have_next) {
      if (!line(p, n)) return kEnd;
      if (n > 0 && p[0] == '>') {
        next_hdr.assign(p + 1, n - 1);
        have_next = true;
      }
    }
    r.hdr.swap(next_hdr);
    have_next = false;
    r.seq.clear();
    while (line(p, n)) {
      if (n > 0 && p[0] == '>') {
        next_hdr.assign(p + 1, n - 1);
        have_next = true;
        break;
      }
      r.seq.append(p, n);
    }
    return 1;
  }
};

int32_t used_len(size_t n) {
  return n < 2 ? 0 : (int32_t)(3 * ((n - 2) / 3));
}

struct Reader {
  Stream files[2];
  int n_files = 1;
  int64_t skip = 0;
  Rec rec[2];
  bool carry = false;  // rec holds a read left for the next batch
  std::string err;
  // the batch
  std::vector<uint8_t> seq;  // its rows' bases, one after another
  std::vector<int32_t> lens;  // a row's length
  std::vector<char> names, hdr;
  std::vector<int64_t> hdr_off;
  std::vector<int32_t> slow;
  int64_t bases = 0;
  int32_t max_len = 0;

  void clear() {
    seq.clear();
    lens.clear();
    names.clear();
    hdr.clear();
    hdr_off.assign(1, 0);
    slow.clear();
    bases = 0;
    max_len = 0;
  }

  int64_t reads() const { return (int64_t)hdr_off.size() - 1; }

  // The name of header h, as io/fasta.py's _split_header cuts it, where
  // every byte is printable ASCII or a tab: the header stripped of spaces
  // and tabs, up to its first space, or else its first tab. Other headers
  // go to `slow`.
  void add_name(const std::string& h) {
    for (unsigned char c : h) {
      if ((c < 0x20 && c != '\t') || c > 0x7e) {
        slow.push_back((int32_t)reads());
        names.push_back('\n');
        return;
      }
    }
    size_t a = 0, b = h.size();
    while (a < b && (h[a] == ' ' || h[a] == '\t')) ++a;
    while (b > a && (h[b - 1] == ' ' || h[b - 1] == '\t')) --b;
    size_t cut = h.find(' ', a);
    if (cut == std::string::npos || cut >= b) cut = h.find('\t', a);
    if (cut == std::string::npos || cut >= b) cut = b;
    names.insert(names.end(), h.begin() + a, h.begin() + cut);
    names.push_back('\n');
  }

  void add_read() {
    add_name(rec[0].hdr);
    hdr.insert(hdr.end(), rec[0].hdr.begin(), rec[0].hdr.end());
    hdr_off.push_back((int64_t)hdr.size());
    for (int f = 0; f < n_files; ++f) {
      const std::string& s = rec[f].seq;
      seq.insert(seq.end(), s.begin(), s.end());
      lens.push_back((int32_t)s.size());
      max_len = std::max(max_len, (int32_t)s.size());
      bases += (int64_t)s.size();
    }
  }

  // The next pair (or read) into rec: 1, kEnd, or an error.
  int64_t next_read() {
    int64_t k = files[0].next(rec[0], err);
    if (k != 1 || n_files == 1) return k;
    k = files[1].next(rec[1], err);
    return k == kEnd ? kErrPairs : k;
  }

  int64_t read(int64_t batch_reads, int64_t batch_bases) {
    clear();
    for (; skip > 0; --skip) {
      for (int f = 0; f < n_files; ++f) {
        int64_t k = files[f].next(rec[f], err);
        if (k < 0) return k;
      }
    }
    while (true) {
      if (!carry) {
        int64_t k = next_read();
        if (k < 0) return k;
        if (k == kEnd) break;
      }
      int64_t n = (int64_t)rec[0].seq.size() +
                  (n_files == 2 ? (int64_t)rec[1].seq.size() : 0);
      carry = batch_bases > 0 && reads() > 0 && bases + n > batch_bases;
      if (carry) break;
      add_read();
      if (reads() >= batch_reads) break;
    }
    return reads();
  }
};

}  // namespace

extern "C" {

// Open q1 (and q2, or null, for pairs); skip records a file are passed
// over by the first br_read. fastq1/fastq2: the format of a file whose
// first byte is neither '>' nor '@'. Null if a file does not open.
void* br_open(const char* q1, const char* q2, int32_t fastq1, int32_t fastq2,
              int64_t skip) {
  Reader* r = new Reader();
  const char* paths[2] = {q1, q2};
  int32_t hints[2] = {fastq1, fastq2};
  r->n_files = q2 ? 2 : 1;
  r->skip = skip;
  for (int f = 0; f < r->n_files; ++f) {
    r->files[f].gz = gzopen(paths[f], "rb");
    r->files[f].fastq_hint = hints[f] != 0;
    if (r->files[f].gz == nullptr) {
      if (f == 1) gzclose(r->files[0].gz);
      delete r;
      return nullptr;
    }
    gzbuffer(r->files[f].gz, kChunk);
  }
  r->clear();
  return r;
}

void br_close(void* h) {
  Reader* r = (Reader*)h;
  for (int f = 0; f < r->n_files; ++f) gzclose(r->files[f].gz);
  delete r;
}

// Parse the next batch. Returns its reads (0 at the end) or an error code;
// info gets [reads, rows, max_len, name bytes, header bytes, slow headers,
// bytes consumed from the files so far, bytes of err's detail]; on an
// error, err (err_cap bytes) gets its detail.
int64_t br_read(void* h, int64_t batch_reads, int64_t batch_bases,
                int64_t* info, char* err, int64_t err_cap) {
  Reader* r = (Reader*)h;
  int64_t k = r->read(batch_reads, batch_bases);
  info[0] = r->reads();
  info[1] = (int64_t)r->lens.size();
  info[2] = r->max_len;
  info[3] = (int64_t)r->names.size();
  info[4] = (int64_t)r->hdr.size();
  info[5] = (int64_t)r->slow.size();
  info[6] = r->files[0].consumed + (r->n_files == 2 ? r->files[1].consumed : 0);
  info[7] = 0;
  if (k < 0) {
    size_t n = std::min(r->err.size(), (size_t)std::max<int64_t>(err_cap, 0));
    memcpy(err, r->err.data(), n);
    info[7] = (int64_t)n;
  }
  return k;
}

// Write the batch br_read parsed into arrays of its sizes: codes
// [rows, width] (width = max_len), lens/pos/qid [rows], read_lens [reads],
// names [name bytes], hdr [header bytes], hdr_off [reads + 1], slow [slow
// headers]. Returns 0, or kErrSizes if a size is not the batch's.
int64_t br_fill(void* h, const uint8_t* table, uint8_t pad, int64_t reads,
                int64_t rows, int64_t width, int64_t name_bytes,
                int64_t hdr_bytes, int64_t n_slow, uint8_t* codes,
                int32_t* lens, int32_t* pos, int32_t* qid, int32_t* read_lens,
                char* names, char* hdr, int64_t* hdr_off, int32_t* slow) {
  Reader* r = (Reader*)h;
  if (reads != r->reads() || rows != (int64_t)r->lens.size() ||
      width != r->max_len || name_bytes != (int64_t)r->names.size() ||
      hdr_bytes != (int64_t)r->hdr.size() ||
      n_slow != (int64_t)r->slow.size())
    return kErrSizes;
  const uint8_t* s = r->seq.data();
  const int mates = r->n_files;
  for (int64_t i = 0; i < rows; ++i) {
    const int32_t n = r->lens[i];
    uint8_t* out = codes + i * width;
    for (int32_t j = 0; j < n; ++j) out[j] = table[s[j]];
    memset(out + n, pad, (size_t)(width - n));
    s += n;
    lens[i] = n;
    qid[i] = (int32_t)(i / mates);
    pos[i] = i % mates == 0 ? 0 : used_len((size_t)r->lens[i - 1]) + 3;
  }
  for (int64_t q = 0; q < reads; ++q) {
    int32_t rl = 0;
    for (int m = 0; m < mates; ++m)
      rl += used_len((size_t)r->lens[q * mates + m]);
    read_lens[q] = rl;
  }
  if (name_bytes) memcpy(names, r->names.data(), (size_t)name_bytes);
  if (hdr_bytes) memcpy(hdr, r->hdr.data(), (size_t)hdr_bytes);
  memcpy(hdr_off, r->hdr_off.data(), (size_t)(reads + 1) * sizeof(int64_t));
  if (n_slow) memcpy(slow, r->slow.data(), (size_t)n_slow * sizeof(int32_t));
  return 0;
}

}  // extern "C"
