// Native host I/O engine: streaming FASTQ parse + 2-bit encode + output.
//
// Replaces the Python ingest/output path with the same semantics as the
// reference's host pipeline stages:
//   - record parsing follows kseq (reference kseq.h:177-218): name is the
//     header token up to the first whitespace, sequences/qualities may span
//     multiple lines, gzip input supported (zlib);
//   - pair fusion and quality masking follow FastqSplitter (reference
//     FastqSplitter.hpp:47-113): pairs classify jointly as
//     seq1 + separator + seq2, bases with qual < minq+33 are masked
//     invalid, and the ORIGINAL seq/qual bytes are kept for output;
//   - output follows ReadOutput (reference ReadOutput.hpp:37-50): one
//     "id gene\n" ssv line per association, one 4-line FASTQ record per
//     emitted read per mate file, deduped per read.
//
// Exposed as a C ABI consumed via ctypes (shark_tpu/io/native.py). Batches
// live in a ring so several can be in flight while the device pipeline
// runs ahead.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC -o _shark_native.so
//        shark_native.cpp -lz

#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Record {
  std::string name, seq, qual;
};

// Buffered gz line reader (gzgets is slow; read big chunks ourselves).
class LineReader {
 public:
  explicit LineReader(const char* path) : gz_(gzopen(path, "rb")) {
    gzbuffer(gz_, 1 << 20);
  }
  ~LineReader() {
    if (gz_) gzclose(gz_);
  }
  bool ok() const { return gz_ != nullptr; }

  // Line boundaries of one complete 4-line FASTQ record in the buffer.
  struct Rec4 {
    char *l0, *n0, *l1, *n1, *l3, *n3;  // header/seq/qual line [start, \n)
  };

  // Validate a complete 4-line FASTQ record (@name / seq / +... / qual,
  // no CRLF, len(qual) == len(seq) > 0) at buffer offset `at`. No refill,
  // no copies. The general kseq-style path handles everything this
  // rejects: multi-line records, CRLF, FASTA headers, buffer-straddling
  // records.
  bool probe4_(size_t at, Rec4& o) {
    if ((int)at >= len_ || buf_[at] != '@') return false;
    char* end = buf_ + len_;
    o.l0 = buf_ + at;
    o.n0 = (char*)memchr(o.l0, '\n', end - o.l0);
    if (!o.n0) return false;
    o.l1 = o.n0 + 1;
    o.n1 = (char*)memchr(o.l1, '\n', end - o.l1);
    if (!o.n1) return false;
    char* l2 = o.n1 + 1;
    if (l2 >= end || *l2 != '+') return false;
    char* n2 = (char*)memchr(l2, '\n', end - l2);
    if (!n2) return false;
    o.l3 = n2 + 1;
    o.n3 = (char*)memchr(o.l3, '\n', end - o.l3);
    if (!o.n3) return false;
    size_t slen = (size_t)(o.n1 - o.l1), qlen = (size_t)(o.n3 - o.l3);
    if (slen == 0 || slen != qlen) return false;
    if (o.n0[-1] == '\r' || o.n1[-1] == '\r' || n2[-1] == '\r' ||
        o.n3[-1] == '\r')
      return false;
    return true;
  }

  // Fast path for the dominant FASTQ shape: a complete in-buffer 4-line
  // record is assigned in ONE pass with no per-line string churn. Returns
  // false (pos_ untouched) whenever the window doesn't match.
  bool fast_fastq(Record& r) {
    if (len_ - pos_ < (1 << 14) && gz_ && !src_eof_) refill_();
    Rec4 o;
    if (!probe4_(pos_, o)) return false;
    char* sp = o.l0 + 1;
    while (sp < o.n0 && *sp != ' ' && *sp != '\t') sp++;
    r.name.assign(o.l0 + 1, (size_t)(sp - (o.l0 + 1)));
    r.seq.assign(o.l1, (size_t)(o.n1 - o.l1));
    r.qual.assign(o.l3, (size_t)(o.n3 - o.l3));
    pos_ = (int)(o.n3 + 1 - buf_);
    return true;
  }

  // Structure-only fast path: sequence LENGTH of the next record, no
  // copies at all (the --max-read-len auto pre-scan is parse-bound).
  bool fast_len(long& out) {
    if (len_ - pos_ < (1 << 14) && gz_ && !src_eof_) refill_();
    Rec4 o;
    if (!probe4_(pos_, o)) return false;
    out = (long)(o.n1 - o.l1);
    pos_ = (int)(o.n3 + 1 - buf_);
    return true;
  }

  // Bulk structure scan: up to `maxn` complete 4-line records are
  // appended to `raw` as ONE verbatim span memcpy, with 5 uint32 offsets
  // per record pushed to `offs` — {name_off, name_len, seq_off, seq_len,
  // qual_off}, all relative to raw.data() (qual_len == seq_len). This is
  // the parse fast path: the producer thread does only memchr structure
  // validation plus one big copy; per-record string materialization never
  // happens (encode and emit read the spans in place). Returns records
  // scanned; 0 = next record needs the general path (or EOF).
  int fast_scan(std::vector<char>& raw, std::vector<uint32_t>& offs,
                int maxn) {
    int scanned = 0;
    size_t span_start = 0;
    size_t base = raw.size(), off0 = offs.size();
    // offsets are uint32 relative to raw.data(): refuse to scan past the
    // 4 GiB mark rather than silently wrap (batches are cleared per call
    // in practice, but the ABI must not depend on that)
    if (base + sizeof(buf_) > UINT32_MAX) return 0;
    while (scanned < maxn) {
      if (len_ - pos_ < (1 << 14) && gz_ && !src_eof_) {
        if (scanned) break;  // copy out before refill_ moves the buffer
        refill_();
      }
      Rec4 o;
      if (!probe4_(pos_, o)) break;
      if (!scanned) span_start = pos_;
      char* sp = o.l0 + 1;
      while (sp < o.n0 && *sp != ' ' && *sp != '\t') sp++;
      offs.push_back((uint32_t)(o.l0 + 1 - buf_));
      offs.push_back((uint32_t)(sp - (o.l0 + 1)));
      offs.push_back((uint32_t)(o.l1 - buf_));
      offs.push_back((uint32_t)(o.n1 - o.l1));
      offs.push_back((uint32_t)(o.l3 - buf_));
      pos_ = (int)(o.n3 + 1 - buf_);
      scanned++;
    }
    if (scanned) {
      raw.insert(raw.end(), buf_ + span_start, buf_ + pos_);
      // rebase this call's buffer offsets onto raw coordinates
      int64_t delta = (int64_t)base - (int64_t)span_start;
      for (size_t i = off0; i < offs.size(); i += 5) {
        offs[i] = (uint32_t)((int64_t)offs[i] + delta);
        offs[i + 2] = (uint32_t)((int64_t)offs[i + 2] + delta);
        offs[i + 4] = (uint32_t)((int64_t)offs[i + 4] + delta);
      }
    }
    return scanned;
  }

  // A truncated or corrupt gzip stream must surface as an ERROR, not a
  // clean EOF (the Python parser raises for the same input; silently
  // classifying a prefix would report a truncated run as success).
  // zlib detail: the final gzread of a truncated member returns 0 — not
  // -1 — with gzerror errnum Z_BUF_ERROR ("unexpected end of file"), so
  // every <=0 return must be interrogated, not just negatives.
  bool bad() const { return bad_; }

  // Returns false at EOF. Strips trailing \n / \r\n.
  bool getline(std::string& out) {
    out.clear();
    while (true) {
      if (pos_ == len_) {
        len_ = gzread(gz_, buf_, sizeof(buf_));
        pos_ = 0;
        if (len_ <= 0) {
          if (len_ < 0 || stream_err_()) bad_ = true;
          len_ = 0;  // never leave len_ negative
          return !out.empty();
        }
      }
      char* nl = (char*)memchr(buf_ + pos_, '\n', len_ - pos_);
      if (nl) {
        out.append(buf_ + pos_, nl - (buf_ + pos_));
        pos_ = (nl - buf_) + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(buf_ + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  // Compact the unread tail to the buffer start and top up from the
  // file, so fast_fastq keeps whole records in view near buffer edges.
  void refill_() {
    if (pos_ > 0 && len_ > pos_) memmove(buf_, buf_ + pos_, len_ - pos_);
    len_ -= pos_;
    pos_ = 0;
    int got = gzread(gz_, buf_ + len_, (unsigned)(sizeof(buf_) - len_));
    if (got > 0) {
      len_ += got;
    } else {
      if (got < 0 || stream_err_()) bad_ = true;
      src_eof_ = true;
    }
  }

  bool stream_err_() {
    int e = Z_OK;
    gzerror(gz_, &e);
    return e != Z_OK && e != Z_STREAM_END;
  }

  gzFile gz_ = nullptr;
  char buf_[1 << 20];
  int pos_ = 0, len_ = 0;
  bool src_eof_ = false;
  bool bad_ = false;
};

// kseq-style record reader over LineReader: FASTA ('>') and FASTQ ('@')
// records, possibly mixed per record (reference kseq.h:177-218). FASTA
// records yield an empty qual.
class FastxReader {
 public:
  explicit FastxReader(const char* path) : lr_(path) {}
  bool ok() const { return lr_.ok(); }

  // 1 = record parsed, 0 = EOF, -1 = malformed/corrupt input (never
  // silently truncates: a bad record OR a truncated/corrupt gzip stream
  // is an error, matching the Python parser).
  int next(Record& r) {
    if (!have_header_ && lr_.fast_fastq(r)) return 1;
    std::string line;
    if (!have_header_) {
      do {
        if (!lr_.getline(line)) return lr_.bad() ? -1 : 0;
      } while (line.empty());
      if (line[0] != '@' && line[0] != '>') return -1;
      header_ = line;
    }
    have_header_ = false;
    size_t sp = header_.find_first_of(" \t", 1);
    r.name.assign(header_, 1, (sp == std::string::npos ? header_.size() : sp) - 1);
    r.seq.clear();
    r.qual.clear();
    if (header_[0] == '>') {
      // FASTA: sequence lines until the next header or EOF
      while (lr_.getline(line)) {
        if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
          header_ = line;
          have_header_ = true;
          break;
        }
        r.seq += line;
      }
      // EOF mid-sequence is the normal last record — unless the stream
      // itself died (truncated gzip): more sequence may have followed
      return lr_.bad() ? -1 : 1;
    }
    // FASTQ: sequence lines until '+', quality until length matches
    while (lr_.getline(line)) {
      if (!line.empty() && line[0] == '+') {
        while (r.qual.size() < r.seq.size() && lr_.getline(line))
          r.qual += line;
        return r.qual.size() == r.seq.size() ? 1 : -1;
      }
      r.seq += line;
    }
    return -1;  // header without a '+' line: malformed
  }

  // Bulk structure scan (see LineReader::fast_scan). Only valid between
  // whole records (never after a lookahead header was buffered).
  int fast_scan(std::vector<char>& raw, std::vector<uint32_t>& offs,
                int maxn) {
    if (have_header_) return 0;
    return lr_.fast_scan(raw, offs, maxn);
  }

  // Sequence length of the next record without materializing it when the
  // fast path applies. Same 1/0/-1 contract as next().
  int next_len(long& out) {
    if (!have_header_ && lr_.fast_len(out)) return 1;
    Record r;
    int rc = next(r);
    if (rc == 1) out = (long)r.seq.size();
    return rc;
  }

  // Non-null iff the underlying stream failed (vs a malformed record).
  const char* stream_error() const {
    return lr_.bad() ? "truncated or corrupt input stream (gzip error)"
                     : nullptr;
  }

 private:
  LineReader lr_;
  std::string header_;
  bool have_header_ = false;
};

int8_t CODE[256];
struct CodeInit {
  CodeInit() {
    memset(CODE, 4, sizeof(CODE));
    CODE[(int)'A'] = CODE[(int)'a'] = 0;
    CODE[(int)'C'] = CODE[(int)'c'] = 1;
    CODE[(int)'G'] = CODE[(int)'g'] = 2;
    CODE[(int)'T'] = CODE[(int)'t'] = 3;
  }
} code_init;

// Rolling canonical k-mer scan: calls f(min(fwd, revcomp), end_pos) for
// every all-valid window (reference semantics, KmerBuilder.hpp:52-67).
template <typename F>
void scan_canonical(const std::string& seq, int k, F&& f) {
  const size_t n = seq.size();
  if ((int)n < k) return;
  uint64_t fwd = 0, rc = 0;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const int top = 2 * (k - 1);
  int run = 0;
  for (size_t i = 0; i < n; i++) {
    uint8_t c = (uint8_t)CODE[(uint8_t)seq[i]];
    if (c >= 4) {
      run = 0;
      continue;
    }
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | ((uint64_t)(3 - c) << top);
    if (++run >= k) f(fwd < rc ? fwd : rc, i);
  }
}

// Borrowed view of one record's fields — either spans into a Batch's raw
// byte block (fast-scanned records; zero string churn) or into a
// materialized Record (general-path records). Valid while the ring slot
// stays pinned.
struct RecView {
  const char* name;
  uint32_t name_len;
  const char* seq;
  uint32_t seq_len;
  const char* qual;
  uint32_t qual_len;
};

struct Batch {
  std::vector<Record> r1, r2;
  // fast-path storage: the first n_rawX records of side X live as
  // verbatim spans in rawX with 5 uint32 offsets per record in offsX
  // (LineReader::fast_scan layout); records past the raw prefix are
  // materialized in r1/r2 by the producer's general path
  std::vector<char> raw1, raw2;
  std::vector<uint32_t> offs1, offs2;
  int n_raw1 = 0, n_raw2 = 0;
  std::vector<uint8_t> codes;  // [batch_size, max_len] byte codes
  std::vector<uint8_t> packed;  // [batch_size, max_len/4] 2-bit codes
  std::vector<uint8_t> vmask;  // [batch_size, max_len/8] validity bits
  int n = 0;

  RecView view(int side, int i) const {
    const std::vector<char>& raw = side ? raw2 : raw1;
    const std::vector<uint32_t>& offs = side ? offs2 : offs1;
    int n_raw = side ? n_raw2 : n_raw1;
    if (i < n_raw) {
      const uint32_t* o = offs.data() + 5 * (size_t)i;
      return {raw.data() + o[0], o[1], raw.data() + o[2], o[3],
              raw.data() + o[4], o[3]};
    }
    const Record& r = side ? r2[i] : r1[i];
    return {r.name.data(), (uint32_t)r.name.size(),
            r.seq.data(),  (uint32_t)r.seq.size(),
            r.qual.data(), (uint32_t)r.qual.size()};
  }
  // slot lifecycle: the parser thread takes FREE slots in order and marks
  // them PARSED; an encoder thread claims a PARSED slot (ENCODING) and
  // encodes/masks/packs it into FILLED — with several encoder threads
  // slots may FILL out of order, but the consumer takes FILLED slots in
  // ring order so the stream stays deterministic; shk_next marks the slot
  // CONSUMED (pinned: records stay available to shk_emit) and
  // shk_emit/shk_release frees it
  enum State { FREE, PARSED, ENCODING, FILLED, CONSUMED } state = FREE;
};

// Must cover: the pipeline's fetch group (config caps it at 6) + queued
// groups (~8 batches of lookahead) + the group being drained, with
// margin; shk_next errors out (never re-consumes) if a caller pins the
// whole ring anyway.
constexpr int kRing = 20;

// Output file that transparently gzip-compresses when the name ends .gz
// (capability beyond the reference, which writes plain FASTQ only).
struct OutFile {
  FILE* f = nullptr;
  gzFile gz = nullptr;
  bool werr = false;  // latched write failure (disk full, I/O error)
  std::string buf;  // batch small writes into ~1MB flushes (tie-heavy
                    // panels emit hundreds of thousands of records/batch)
  bool open_path(const char* path, bool append = false) {
    size_t n = strlen(path);
    if (n > 3 && strcmp(path + n - 3, ".gz") == 0) {
      // append would start a new gzip member, but resume also needs
      // mid-member truncation, which gzip cannot do — callers refuse
      // resume for .gz outputs before getting here
      if (append) return false;
      gz = gzopen(path, "wb");
      return gz != nullptr;
    }
    f = fopen(path, append ? "ab" : "wb");
    return f != nullptr;
  }
  bool is_open() const { return f || gz; }
  void write(const char* d, size_t n) {
    buf.append(d, n);
    if (buf.size() >= (1u << 20)) flush();
  }
  void put(char c) {
    buf.push_back(c);
    if (buf.size() >= (1u << 20)) flush();
  }
  void flush() {
    if (buf.empty()) return;
    if (gz) {
      if (gzwrite(gz, buf.data(), (unsigned)buf.size()) != (int)buf.size())
        werr = true;
    } else if (f) {
      if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) werr = true;
    }
    buf.clear();
  }
  // Returns false if any write (or the close itself) failed.
  bool close() {
    flush();
    bool ok = !werr;
    if (gz && gzclose(gz) != Z_OK) ok = false;
    if (f) {
      if (ferror(f)) ok = false;
      if (fclose(f) != 0) ok = false;
    }
    gz = nullptr;
    f = nullptr;
    werr = !ok;
    return ok;
  }
};

struct Stream {
  FastxReader* f1 = nullptr;
  FastxReader* f2 = nullptr;
  int batch_size = 0, max_len = 0, min_quality = 0;
  bool paired = false;
  bool pack_mode = false;
  // producer-thread-private high-water marks for the raw span buffers
  // (read/written only from parse_batch)
  size_t raw_hwm1 = 0, raw_hwm2 = 0;
  Batch ring[kRing];
  long produce_id = 0;  // next slot the parser fills
  long encode_id = 0;  // next slot the encoder processes
  long consume_id = 0;  // next slot the consumer takes
  bool eof = false;
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_free, cv_parsed, cv_filled;
  std::thread producer;
  std::vector<std::thread> encoders;

  FILE* ssv = nullptr;
  std::string ssv_buf;
  OutFile out1, out2;
  bool own_ssv = false;
  std::vector<std::string> gene_names;
  long n_associations = 0;
  long n_reads_out = 0;
  std::string err;
  // batch id of a latched ENCODER error (-1 = err is empty or came from a
  // non-encoder site): with several encoder threads, batch N+2's failure
  // can publish before batch N's slower one, and the consumer — which
  // fails at the lowest bad batch — would read a message describing a
  // different batch. Lowest-batch-id wins among encoder errors.
  long err_batch_id = -1;
};

void encode_into(const char* s, int n, uint8_t* dst, int cap, int off,
                 bool* overflow) {
  if (off + n > cap) {
    *overflow = true;
    n = cap - off;
    if (n <= 0) return;
  }
  for (int i = 0; i < n; i++) dst[off + i] = CODE[(uint8_t)s[i]];
}

// Quality masking in FUSED QUAL coordinates (reference mask_seq,
// FastqSplitter.hpp:84-90, 104-113): position i of the fused read is masked
// iff i < len(fused qual) and fused_qual[i] < cut, where fused qual =
// qual1 (+ '\33' + qual2 for pairs). For FASTQ input qual length equals seq
// length so this is per-base; FASTA records have empty qual (no masking for
// single-end; pairs mask exactly fused position len(qual1)).
void mask_row(const RecView& r1, const RecView* r2, int min_quality,
              uint8_t* dst, int cap) {
  char cut = (char)(min_quality + 33);
  int n1 = (int)std::min((uint32_t)cap, r1.qual_len);
  const char* q1 = r1.qual;
  for (int i = 0; i < n1; i++)
    if (q1[i] < cut) dst[i] = 4;
  if (!r2) return;
  int j = (int)r1.qual_len;  // fused junction byte '\33' always < cut
  if (j < cap) dst[j] = 4;
  const char* q2 = r2->qual;
  int n2 = (int)r2->qual_len;
  for (int i = 0; i < n2 && j + 1 + i < cap; i++)
    if (q2[i] < cut) dst[j + 1 + i] = 4;
}

// codes row -> 2-bit packed row + validity bitmask row, PLANAR layout:
// packed byte j holds positions {j, j+L/4, j+2L/4, j+3L/4} in 2-bit
// planes, vmask byte j holds positions {j + r*L/8} in bit planes. Planar
// unpacking is a cheap shift+concat on the TPU (no cross-lane shuffle).
void pack_row(const uint8_t* codes, int L, uint8_t* packed, uint8_t* vmask) {
  int L4 = L / 4, L8 = L / 8;
  memset(packed, 0, L4);
  memset(vmask, 0, L8);
  // Plane-major loops: no per-byte div/mod, and each inner loop is a
  // branch-free masked shift-or that the compiler autovectorizes (the
  // byte-major form cost ~45 ms per 64k batch — the single hottest host
  // loop in the pipeline).
  for (int r = 0; r < 4; r++) {
    const uint8_t* src = codes + r * L4;
    int shift = 2 * r;
    for (int j = 0; j < L4; j++) {
      uint8_t c = src[j];
      packed[j] |= (uint8_t)((c < 4 ? c : 0) << shift);
    }
  }
  for (int r = 0; r < 8; r++) {
    const uint8_t* src = codes + r * L8;
    for (int j = 0; j < L8; j++)
      vmask[j] |= (uint8_t)((src[j] < 4 ? 1 : 0) << r);
  }
}

// Parse one batch of records into `b` (no encoding — that runs on the
// encoder thread so parse and encode/pack pipeline against each other).
int parse_batch(Stream* s, Batch& b) {
  b.r1.resize(s->batch_size);
  if (s->paired) b.r2.resize(s->batch_size);
  b.raw1.clear();
  b.offs1.clear();
  b.raw2.clear();
  b.offs2.clear();
  // adaptive span reservation: grow-by-doubling mid-batch would memcpy +
  // page-fault the whole span; after the first batch the previous batch's
  // high-water mark is the right size
  if (b.raw1.capacity() < s->raw_hwm1) b.raw1.reserve(s->raw_hwm1);
  if (s->paired && b.raw2.capacity() < s->raw_hwm2)
    b.raw2.reserve(s->raw_hwm2);
  // Fast path: bulk structure scans fill a span prefix per side with no
  // per-record string materialization (the producer does only memchr
  // validation + one big memcpy per scan). Each side's prefix length is
  // independent; view() serves spans below n_rawX and Records above.
  b.n_raw1 = 0;
  while (b.n_raw1 < s->batch_size) {
    int got = s->f1->fast_scan(b.raw1, b.offs1, s->batch_size - b.n_raw1);
    if (got <= 0) break;
    b.n_raw1 += got;
  }
  b.n_raw2 = 0;
  if (s->paired) {
    // never scan side 2 past side 1's count: reference semantics stop at
    // either EOF, and over-consumed side-2 records would be lost to the
    // next batch if side 1 (the batch-count side) came up short here
    while (b.n_raw2 < b.n_raw1) {
      int got = s->f2->fast_scan(b.raw2, b.offs2, b.n_raw1 - b.n_raw2);
      if (got <= 0) break;
      b.n_raw2 += got;
    }
  }
  int n = 0;
  int rc1 = 0, rc2 = 0;
  while (n < s->batch_size) {
    if (n >= b.n_raw1 && (rc1 = s->f1->next(b.r1[n])) <= 0) break;
    if (s->paired && n >= b.n_raw2 &&
        (rc2 = s->f2->next(b.r2[n])) <= 0)
      break;  // reference stops when either file ends
    n++;
  }
  if (b.raw1.size() > s->raw_hwm1) s->raw_hwm1 = b.raw1.size();
  if (b.raw2.size() > s->raw_hwm2) s->raw_hwm2 = b.raw2.size();
  if (rc1 < 0 || rc2 < 0) {
    const char* se = rc1 < 0 ? s->f1->stream_error()
                             : s->f2->stream_error();
    // first error wins; all Stream::err writers take the mutex (encoder
    // threads, this producer thread, and the emit-side consumer)
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->err.empty()) s->err = se ? se : "malformed FASTA/FASTQ record";
    b.n = -1;
    return -1;
  }
  b.n = n;
  return n;
}

// Encode + quality-mask + 2-bit-pack one parsed batch. Returns b.n; sets
// `err` (and b.n = -1) on overflow. `err` is a caller-local string so
// concurrent encoder threads never race on Stream::err — the caller
// publishes it under the stream mutex.
int encode_batch_rows(Stream* s, Batch& b, std::string& err) {
  if (b.n <= 0) return b.n;
  size_t row_bytes = (size_t)s->max_len;
  bool overflow = false;
  if (s->pack_mode) {
    // Fused encode+mask+pack through one row-sized scratch buffer: the
    // consumer only reads packed/vmask in pack mode, so materializing the
    // full [batch, max_len] codes array would cost three avoidable
    // full-batch memory passes per batch (6.8 MB fill + write + read at
    // the default geometry) plus its first-touch page faults — measured
    // ~2.4 GB/s cold on this VM class (bench/native_stage_bench.cpp).
    b.packed.resize((size_t)s->batch_size * (s->max_len / 4));
    b.vmask.resize((size_t)s->batch_size * (s->max_len / 8));
    std::vector<uint8_t> row((size_t)s->max_len);
    for (int i = 0; i < b.n; i++) {
      memset(row.data(), 4, row.size());
      RecView v1 = b.view(0, i);
      RecView v2{};
      if (s->paired) v2 = b.view(1, i);
      encode_into(v1.seq, (int)v1.seq_len, row.data(), s->max_len, 0,
                  &overflow);
      if (s->paired) {
        int off = (int)v1.seq_len + 1;  // invalid separator column
        encode_into(v2.seq, (int)v2.seq_len, row.data(), s->max_len, off,
                    &overflow);
      }
      if (s->min_quality > 0)
        mask_row(v1, s->paired ? &v2 : nullptr, s->min_quality, row.data(),
                 s->max_len);
      pack_row(row.data(), s->max_len,
               b.packed.data() + (size_t)i * (s->max_len / 4),
               b.vmask.data() + (size_t)i * (s->max_len / 8));
    }
    // rows past b.n (short final batch) must stay invalid/zero for the
    // device kernel's padding contract
    size_t tail = (size_t)(s->batch_size - b.n);
    if (tail) {
      memset(b.packed.data() + (size_t)b.n * (s->max_len / 4), 0,
             tail * (s->max_len / 4));
      memset(b.vmask.data() + (size_t)b.n * (s->max_len / 8), 0,
             tail * (s->max_len / 8));
    }
  } else {
    b.codes.assign((size_t)s->batch_size * row_bytes, 4);
    for (int i = 0; i < b.n; i++) {
      uint8_t* row = b.codes.data() + (size_t)i * row_bytes;
      RecView v1 = b.view(0, i);
      RecView v2{};
      if (s->paired) v2 = b.view(1, i);
      encode_into(v1.seq, (int)v1.seq_len, row, s->max_len, 0, &overflow);
      if (s->paired) {
        int off = (int)v1.seq_len + 1;  // invalid separator column
        encode_into(v2.seq, (int)v2.seq_len, row, s->max_len, off,
                    &overflow);
      }
      if (s->min_quality > 0)
        mask_row(v1, s->paired ? &v2 : nullptr, s->min_quality, row,
                 s->max_len);
    }
  }
  if (overflow) {
    err = "read longer than max_len";
    b.n = -1;
    return -1;
  }
  return b.n;
}

void producer_loop(Stream* s) {
  while (true) {
    long id;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_free.wait(lk, [&] {
        return s->stop || s->ring[s->produce_id % kRing].state == Batch::FREE;
      });
      if (s->stop) return;
      id = s->produce_id;
    }
    Batch& b = s->ring[id % kRing];
    int n = parse_batch(s, b);
    {
      std::unique_lock<std::mutex> lk(s->mu);
      b.state = Batch::PARSED;
      s->produce_id++;
      if (n <= 0) s->eof = true;
      s->cv_parsed.notify_all();
      if (n <= 0) return;
    }
  }
}

void encoder_loop(Stream* s) {
  while (true) {
    long id;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_parsed.wait(lk, [&] {
        return s->stop || s->ring[s->encode_id % kRing].state == Batch::PARSED;
      });
      if (s->stop) return;
      // claim-and-advance under the lock so concurrent encoder threads
      // each take a distinct slot; encoding then runs unlocked
      id = s->encode_id++;
      s->ring[id % kRing].state = Batch::ENCODING;
      s->cv_parsed.notify_all();  // wake peers for the next PARSED slot
    }
    Batch& b = s->ring[id % kRing];
    std::string err;
    int n = encode_batch_rows(s, b, err);
    {
      std::unique_lock<std::mutex> lk(s->mu);
      if (!err.empty() &&
          (s->err.empty() ||
           (s->err_batch_id >= 0 && id < s->err_batch_id))) {
        s->err = err;
        s->err_batch_id = id;
      }
      b.state = Batch::FILLED;
      s->cv_filled.notify_all();
      // the EOF/error batch ends this thread; peers sleep on cv_parsed
      // until shk_close sets stop
      if (n <= 0) return;
    }
  }
}

}  // namespace

extern "C" {

void* shk_open(const char* fq1, const char* fq2, int batch_size, int max_len,
               int min_quality, int pack_mode, int encode_threads) {
  if (pack_mode && max_len % 8 != 0) return nullptr;  // planes need %8
  Stream* s = new Stream;
  s->batch_size = batch_size;
  s->max_len = max_len;
  s->min_quality = min_quality;
  s->pack_mode = pack_mode != 0;
  s->f1 = new FastxReader(fq1);
  if (!s->f1->ok()) {
    delete s->f1;
    delete s;
    return nullptr;
  }
  if (fq2 && fq2[0]) {
    s->f2 = new FastxReader(fq2);
    if (!s->f2->ok()) {
      delete s->f1;
      delete s->f2;
      delete s;
      return nullptr;
    }
    s->paired = true;
  }
  // Parallel first-touch of the ring buffers BEFORE work starts: this VM
  // class faults fresh anonymous pages at ~2.4 GB/s single-threaded but
  // ~9 GB/s across 4 threads (bench/native_stage_bench.cpp notes), and a
  // cold ring otherwise pays those faults inside the timed pipeline — on
  // short runs (a 500k-read bench pass is 8 batches) the ring never warms
  // up at all. The warm-up is scoped to the slots the input can actually
  // fill (stat-based batch estimate, gz sizes scaled by a typical 4x
  // FASTQ ratio, +2 slack): a tiny sample previously pre-committed
  // batch_size*240 bytes per side for ALL kRing slots plus full
  // packed/codes buffers (~600-900 MB RSS at batch_size=65536 paired)
  // before reading a single record. Unwarmed slots allocate on demand in
  // the producer/encoder (their per-batch resize/reserve is
  // unconditional), so this is purely a fault-placement optimization.
  {
    size_t raw_cap = (size_t)batch_size * 240;  // ~100bp records; the
    // producer's high-water reservation takes over from batch 2
    size_t est_bytes = 0;
    bool unknown = false;
    for (const char* p : {fq1, fq2}) {
      if (!p || !p[0]) continue;
      struct stat st;
      if (::stat(p, &st) != 0 || st.st_size == 0) {
        unknown = true;  // pipe/special input: warm everything
        break;
      }
      size_t sz = (size_t)st.st_size;
      size_t len = std::strlen(p);
      if (len > 3 && std::strcmp(p + len - 3, ".gz") == 0) sz *= 4;
      est_bytes += sz;
    }
    int warm_slots = kRing;
    if (!unknown) {
      size_t per_batch = raw_cap * (s->paired ? 2 : 1);
      size_t need = est_bytes / per_batch + 2;
      if (need < (size_t)kRing) warm_slots = (int)need;
    }
    int nw = 4;
    std::vector<std::thread> warm;
    std::atomic<int> next_slot{0};
    for (int w = 0; w < nw; w++)
      warm.emplace_back([s, raw_cap, warm_slots, &next_slot] {
        while (true) {
          int i = next_slot.fetch_add(1);
          if (i >= warm_slots) return;
          Batch& b = s->ring[i];
          size_t BL = (size_t)s->batch_size * s->max_len;
          if (s->pack_mode) {
            b.packed.resize(BL / 4);
            b.vmask.resize(BL / 8);
          } else {
            b.codes.assign(BL, 4);
          }
          b.raw1.resize(raw_cap);
          b.raw1.clear();
          b.offs1.reserve((size_t)s->batch_size * 5);
          b.r1.resize(s->batch_size);
          if (s->paired) {
            b.raw2.resize(raw_cap);
            b.raw2.clear();
            b.offs2.reserve((size_t)s->batch_size * 5);
            b.r2.resize(s->batch_size);
          }
        }
      });
    for (auto& t : warm) t.join();
  }
  s->producer = std::thread(producer_loop, s);
  int ne = encode_threads > 0 ? encode_threads : 1;
  for (int i = 0; i < ne; i++) s->encoders.emplace_back(encoder_loop, s);
  return s;
}

// Take the next parsed batch from the prefetch ring. Copies byte codes
// into `codes` (if non-null) and, in pack mode, the 2-bit codes +
// validity bitmask into `packed`/`vmask` (if non-null). Returns reads in
// the batch (0 = EOF, -1 = error) and the ring slot via *slot_out. The
// slot stays pinned (records available to shk_emit) until shk_emit or
// shk_release frees it.
int shk_next(void* h, uint8_t* codes, uint8_t* packed, uint8_t* vmask,
             int* slot_out) {
  Stream* s = (Stream*)h;
  long id;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_filled.wait(lk, [&] {
      Batch::State st = s->ring[s->consume_id % kRing].state;
      return st == Batch::FILLED || st == Batch::CONSUMED;
    });
    id = s->consume_id;
    if (s->ring[id % kRing].state == Batch::CONSUMED) {
      // the consumer wrapped onto a slot it already took but never
      // released: every ring slot is pinned (the caller's fetch
      // group/lookahead exceeds kRing). Without this guard the stale
      // batch would be silently re-consumed as new data.
      if (s->err.empty())
        s->err =
            "prefetch ring exhausted: too many unreleased batches "
            "(fetch_group x lookahead must stay below the ring size)";
      return -1;
    }
  }
  int slot = (int)(id % kRing);
  Batch& b = s->ring[slot];
  if (b.n < 0) return -1;
  if (b.n == 0) {  // EOF marker; recycle immediately
    std::unique_lock<std::mutex> lk(s->mu);
    b.state = Batch::FREE;
    s->consume_id++;
    s->cv_free.notify_all();
    return 0;
  }
  // pack mode no longer materializes the byte-codes array (encode+mask+
  // pack fuse through a row scratch buffer), so a codes request there is
  // a caller contract violation — fail loudly instead of handing back an
  // uninitialized buffer as a successful batch
  if (codes && s->pack_mode) {
    if (s->err.empty())
      s->err = "codes output requested from a pack-mode stream";
    return -1;
  }
  if (codes)
    memcpy(codes, b.codes.data(), (size_t)s->batch_size * s->max_len);
  if (s->pack_mode && packed)
    memcpy(packed, b.packed.data(), (size_t)s->batch_size * (s->max_len / 4));
  if (s->pack_mode && vmask)
    memcpy(vmask, b.vmask.data(), (size_t)s->batch_size * (s->max_len / 8));
  {
    std::unique_lock<std::mutex> lk(s->mu);
    b.state = Batch::CONSUMED;
    s->consume_id++;
  }
  *slot_out = slot;
  return b.n;
}

// Free a ring slot without emitting (e.g. a batch with no verdicts).
void shk_release(void* h, int slot) {
  Stream* s = (Stream*)h;
  std::unique_lock<std::mutex> lk(s->mu);
  s->ring[slot].state = Batch::FREE;
  s->cv_free.notify_all();
}

// Parse-only pre-pass: longest FUSED read length (len1, or len1+1+len2
// paired — FastqSplitter.hpp:63's 'N' junction) over the whole sample,
// honoring the reference's stop-at-either-EOF pairing. Lets the driver
// pick the native engine's static batch geometry without a user flag
// (the reference streams arbitrary lengths; the TPU path needs static
// shapes). Runs at parse speed — no encode, no batching. Returns the max
// length (0 = empty sample), -1 = cannot open, -2 = malformed/corrupt.
long shk_scan_max_fused(const char* fq1, const char* fq2) {
  FastxReader f1(fq1);
  if (!f1.ok()) return -1;
  bool paired = fq2 && fq2[0];
  std::unique_ptr<FastxReader> f2;
  if (paired) {
    f2.reset(new FastxReader(fq2));
    if (!f2->ok()) return -1;
  }
  long best = 0;
  while (true) {
    long len1 = 0, len2 = 0;
    int rc1 = f1.next_len(len1);
    if (rc1 < 0) return -2;
    if (rc1 == 0) break;
    long fused = len1;
    if (paired) {
      int rc2 = f2->next_len(len2);
      if (rc2 < 0) return -2;
      if (rc2 == 0) break;  // reference stops when either file ends
      fused += 1 + len2;
    }
    if (fused > best) best = fused;
  }
  return best;
}

int shk_set_output(void* h, int ssv_fd, const char* ssv_path,
                   const char* out1, const char* out2, int append) {
  Stream* s = (Stream*)h;
  if (ssv_path && ssv_path[0]) {
    s->ssv = fopen(ssv_path, append ? "ab" : "wb");
    s->own_ssv = true;
  } else {
    s->ssv = fdopen(dup(ssv_fd), "wb");
    s->own_ssv = true;
  }
  if (!s->ssv) return -1;
  if (out1 && out1[0] && !s->out1.open_path(out1, append != 0)) return -1;
  if (out2 && out2[0] && !s->out2.open_path(out2, append != 0)) return -1;
  return 0;
}

// Flush all output buffers and report current byte offsets (ssv, out1,
// out2; -1 where the output is absent or not seekable, e.g. gzip).
// Checkpoint support: the offsets are valid truncate targets for resume.
int shk_tell(void* h, long* offs) {
  Stream* s = (Stream*)h;
  offs[0] = offs[1] = offs[2] = -1;
  if (s->ssv) {
    if (fflush(s->ssv) != 0) return -1;
    offs[0] = ftell(s->ssv);
  }
  OutFile* outs[2] = {&s->out1, &s->out2};
  for (int i = 0; i < 2; i++) {
    OutFile& o = *outs[i];
    if (!o.is_open()) continue;
    o.flush();
    if (o.werr) return -1;
    if (o.f) {
      if (fflush(o.f) != 0) return -1;
      offs[1 + i] = ftell(o.f);
    }
  }
  return 0;
}

void shk_register_genes(void* h, const char** names, int n) {
  Stream* s = (Stream*)h;
  s->gene_names.assign(names, names + n);
}

static void write_fastq(OutFile& f, const RecView& r) {
  f.put('@');
  f.write(r.name, r.name_len);
  f.put('\n');
  f.write(r.seq, r.seq_len);
  f.write("\n+\n", 3);
  f.write(r.qual, r.qual_len);
  f.put('\n');
}

// Emit associations for one batch: (read_idx, gene_idx) pairs, grouped by
// read in ascending read order (multiple genes per read allowed, the read's
// FASTQ records are written once).
int shk_emit(void* h, int slot, const int32_t* read_idx,
             const int32_t* gene_idx, int n_assoc) {
  Stream* s = (Stream*)h;
  Batch& b = s->ring[slot];
  // validate EVERY index before writing anything: a mid-loop failure
  // would leave the FASTQ outputs holding part of the batch with its ssv
  // lines dropped (inconsistent outputs), and the pinned slot would
  // eventually exhaust the ring with a misleading error far from the
  // real cause
  for (int i = 0; i < n_assoc; i++) {
    if (read_idx[i] < 0 || read_idx[i] >= b.n || gene_idx[i] < 0 ||
        gene_idx[i] >= (int)s->gene_names.size()) {
      shk_release(h, slot);
      return -1;
    }
  }
  int prev = -1;
  std::string& line = s->ssv_buf;  // one big fwrite per batch
  line.clear();
  for (int i = 0; i < n_assoc; i++) {
    int r = read_idx[i];
    int g = gene_idx[i];
    RecView rec = b.view(0, r);
    line.append(rec.name, rec.name_len);
    line.push_back(' ');
    line.append(s->gene_names[g]);
    line.push_back('\n');
    s->n_associations++;
    if (r != prev) {
      s->n_reads_out++;
      if (s->out1.is_open()) write_fastq(s->out1, rec);
      if (s->out2.is_open() && s->paired) write_fastq(s->out2, b.view(1, r));
      prev = r;
    }
  }
  bool werr = !line.empty() &&
              fwrite(line.data(), 1, line.size(), s->ssv) != line.size();
  shk_release(h, slot);
  // Surface write failures (disk full, I/O error) instead of reporting a
  // truncated run as success: -2 distinguishes them from bad indices (-1).
  if (werr || ferror(s->ssv) || s->out1.werr || s->out2.werr) {
    std::unique_lock<std::mutex> lk(s->mu);
    if (s->err.empty()) s->err = "output write error";
    return -2;
  }
  return 0;
}

// Ring capacity for callers sizing their lookahead (and for tests that
// exercise the exhaustion guard without hardcoding the constant).
int shk_ring_capacity() { return kRing; }

}  // extern "C" (reopened below — the host-classify helpers need
   // templates/namespaces, which C linkage forbids)

// ---- host classify backend (--backend native) ----------------------------
//
// Pure-CPU classification against the dense index arrays — the production
// no-accelerator path (the jax-on-CPU fallback runs the gather-shaped
// device kernel ~8x slower than this on the same cores, docs/PERF.md
// "CPU-backend fallback"). Semantics are the executable spec's
// (classify/oracle.py = reference ReadAnalyzer.hpp:39-109): canonical
// k-mers with non-ACGT window restarts, XXH64(8B, seed 0) % size, per-gene
// cov += min(k, pos - last) with every FIRST hit of a gene contributing k
// (the reference's first-probe pos+1 and the rolling first-touch both
// reduce to k — see classify/step.py's head-equivalence note), (cov, hits)
// lexicographic argmax with ties kept (std::map ascending order =
// reference emission order), and the float64 `cov >= c*len` compare
// (ReadAnalyzer.hpp:104). Probes hit the SAME index arrays the device
// uses: bf_words bit test, word_rank + popcount -> CSR rank, gene list =
// gene_ids[offsets[r]..offsets[r+1]] (index/structure.py).

namespace {

// XXH64 of one 8-byte key, seed 0 — the reference's probe hash
// (kmer_utils.hpp:81-83); shared by the index build below and the host
// classify path. Bit-exactness is pinned by known-answer tests through
// both the build and the ops/xxh64.py limb implementation.
constexpr uint64_t kP1 = 11400714785074694791ULL;
constexpr uint64_t kP2 = 14029467366897019727ULL;
constexpr uint64_t kP3 = 1609587929392839161ULL;
constexpr uint64_t kP4 = 9650029242287828579ULL;
constexpr uint64_t kP5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh64_8(uint64_t x) {
  uint64_t h = kP5 + 8;
  uint64_t k1 = rotl64(x * kP2, 31) * kP1;
  h ^= k1;
  h = rotl64(h, 27) * kP1 + kP4;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

struct HostGeneState {
  int cov = 0, hits = 0, last = 0;
};

// scan_canonical over 2-bit code rows (0..3 valid, >=4 breaks the window)
// instead of ACGT chars — the encode stage already applied pair fusion and
// quality masking, exactly like the device front end.
template <typename F>
void scan_canonical_codes(const uint8_t* row, int L, int k, F&& f) {
  uint64_t fwd = 0, rc = 0;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const int top = 2 * (k - 1);
  int run = 0;
  for (int i = 0; i < L; i++) {
    uint8_t c = row[i];
    if (c >= 4) {
      run = 0;
      continue;
    }
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | ((uint64_t)(3 - c) << top);
    if (++run >= k) f(fwd < rc ? fwd : rc, (size_t)i);
  }
}

struct HostClassifyResult {
  std::vector<int32_t> ri, gi;
};

}  // namespace

extern "C" {

// Classify n_rows of a [*, L] byte-code batch. Returns a result handle;
// fetch the pair count with shk_host_pairs, copy out with shk_host_fill,
// free with shk_host_free. Rows split into `threads` contiguous chunks
// (deterministic read-ascending output regardless of thread count).
void* shk_host_classify(const uint8_t* codes, int n_rows, int L, int k,
                        double c, int single_mode,
                        const uint32_t* bf_words, const uint32_t* word_rank,
                        const int32_t* offsets, const uint16_t* gene_ids,
                        uint64_t size_bits, int threads) {
  auto* res = new HostClassifyResult;
  int t = threads > 0 ? threads : 1;
  if (t > n_rows) t = std::max(1, n_rows);
  std::vector<HostClassifyResult> parts(t);
  std::vector<std::thread> pool;
  int per = t ? (n_rows + t - 1) / t : 0;
  for (int w = 0; w < t; w++) {
    int lo = w * per, hi = std::min(n_rows, lo + per);
    if (lo >= hi) continue;
    pool.emplace_back([&, w, lo, hi] {
      auto& out = parts[w];
      std::map<int, HostGeneState> st;
      for (int i = lo; i < hi; i++) {
        const uint8_t* row = codes + (size_t)i * L;
        int len = 0;
        for (int j = 0; j < L; j++) len += row[j] < 4;
        if (len < k) continue;
        st.clear();
        bool first = true;
        scan_canonical_codes(row, L, k, [&](uint64_t canon, size_t e) {
          uint64_t p = xxh64_8(canon) % size_bits;
          uint32_t word = bf_words[p >> 5];
          uint32_t bit = (uint32_t)(p & 31);
          if (!((word >> bit) & 1)) return;
          uint32_t r =
              word_rank[p >> 5] +
              (uint32_t)__builtin_popcount(word & ((1u << bit) - 1));
          int pos_eff = first ? (int)e + 1 : (int)e;
          for (int32_t a = offsets[r]; a < offsets[r + 1]; a++) {
            HostGeneState& s = st[gene_ids[a]];
            s.cov += std::min(k, pos_eff - s.last);
            s.hits = first ? 1 : s.hits + 1;
            s.last = (int)e;
          }
          first = false;
        });
        int best_cov = 0, best_hits = 0, n_win = 0;
        for (auto& kv : st) {
          if (kv.second.cov > best_cov ||
              (kv.second.cov == best_cov &&
               kv.second.hits > best_hits)) {
            best_cov = kv.second.cov;
            best_hits = kv.second.hits;
            n_win = 1;
          } else if (kv.second.cov == best_cov &&
                     kv.second.hits == best_hits && best_cov > 0) {
            n_win++;
          }
        }
        if (n_win == 0 || (double)best_cov < c * (double)len) continue;
        if (single_mode && n_win != 1) continue;
        for (auto& kv : st)
          if (kv.second.cov == best_cov && kv.second.hits == best_hits) {
            out.ri.push_back(i);
            out.gi.push_back(kv.first);
          }
      }
    });
  }
  for (auto& th : pool) th.join();
  size_t total = 0;
  for (auto& p : parts) total += p.ri.size();
  res->ri.reserve(total);
  res->gi.reserve(total);
  for (auto& p : parts) {  // chunk order == read-ascending order
    res->ri.insert(res->ri.end(), p.ri.begin(), p.ri.end());
    res->gi.insert(res->gi.end(), p.gi.begin(), p.gi.end());
  }
  return res;
}

int64_t shk_host_pairs(void* h) {
  return (int64_t)((HostClassifyResult*)h)->ri.size();
}

void shk_host_fill(void* h, int32_t* ri, int32_t* gi) {
  auto* r = (HostClassifyResult*)h;
  if (!r->ri.empty()) {
    memcpy(ri, r->ri.data(), r->ri.size() * sizeof(int32_t));
    memcpy(gi, r->gi.data(), r->gi.size() * sizeof(int32_t));
  }
}

void shk_host_free(void* h) { delete (HostClassifyResult*)h; }

long shk_n_associations(void* h) { return ((Stream*)h)->n_associations; }
long shk_n_reads_out(void* h) { return ((Stream*)h)->n_reads_out; }

const char* shk_error(void* h) { return ((Stream*)h)->err.c_str(); }

// Returns 0 on success, -1 if any output write/close failed (so callers
// never report a truncated run as success).
int shk_close(void* h) {
  Stream* s = (Stream*)h;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->stop = true;
    s->cv_free.notify_all();
    s->cv_parsed.notify_all();
  }
  if (s->producer.joinable()) s->producer.join();
  for (auto& t : s->encoders)
    if (t.joinable()) t.join();
  int rc = 0;
  if (s->ssv) {
    if (ferror(s->ssv)) rc = -1;
    if (fclose(s->ssv) != 0) rc = -1;
  }
  if (!s->out1.close()) rc = -1;
  if (!s->out2.close()) rc = -1;
  delete s->f1;
  delete s->f2;
  delete s;
  return rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native index builder: FASTA -> bit-vector + per-word rank + CSR arrays.
//
// Same construction as shark_tpu/index/build.py (semantics per reference
// bloomfilter.h:57-75, 111-188: per Bloom position, the ascending
// duplicate-free list of genes touching it), in C++ for transcriptome-scale
// inputs. Two-phase ABI: shk_build() parses the FASTA and sorts the
// (position, gene) pairs — no GiB-scale arrays; shk_build_fill() then
// assembles the bit-vector / rank / CSR DIRECTLY into caller-provided
// numpy buffers; shk_build_free() releases. The fill-in-place design
// matters: this class of VM faults fresh anonymous pages at only
// ~0.2-1 GB/s, so the old build-internally-then-memcpy ABI paid the
// ~2 GiB of dense arrays TWICE (measured 50s for a 500-gene panel; the
// direct fill is ~3-8s). bf_words must arrive zeroed (np.zeros = calloc:
// untouched pages stay zero; only set words are written).
// ---------------------------------------------------------------------------

namespace {

struct BuildResult {
  uint64_t size_bits = 0;
  // sorted packed keys: (bloom position << 16) | gene id. pos < 2^33 at
  // the CLI's -b <= 2^15 cap and gene < 2^16, so one uint64 carries both
  // — half the bytes of a (u64, u32) pair, radix-partitionable, and the
  // natural integer order IS the required (pos asc, gene asc) order.
  std::vector<uint64_t> keys;
  uint64_t n_set = 0;  // distinct positions
  std::string names;   // '\n'-joined gene names in id order
  std::string err;
  int threads = 1;  // parallelism carried into shk_build_fill
};

// Build-phase wall-clock trace to stderr when SHARK_BUILD_TRACE is set.
struct PhaseTrace {
  bool on = getenv("SHARK_BUILD_TRACE") != nullptr;
  std::chrono::steady_clock::time_point t0 = std::chrono::steady_clock::now();
  void mark(const char* tag) {
    if (!on) return;
    auto t1 = std::chrono::steady_clock::now();
    fprintf(stderr, "[shk_build] %-12s %6.2f s\n", tag,
            std::chrono::duration<double>(t1 - t0).count());
    t0 = t1;
  }
};

// Parallel-for over [0, n) in T contiguous chunks (T=1 runs inline).
template <typename F>
void parallel_chunks(uint64_t n, int t, F&& f) {
  if (t <= 1 || n < 2) {
    f(0, n);
    return;
  }
  std::vector<std::thread> pool;
  uint64_t chunk = (n + t - 1) / t;
  for (int i = 0; i < t; i++) {
    uint64_t lo = (uint64_t)i * chunk;
    uint64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&f, lo, hi] { f(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Build phase. Deterministic for ANY thread count: per-gene position
// lists are dedup'd independently (the reference's within-gene dedup,
// bloomfilter.h:68-73), and the global order is a full (pos, gene) sort —
// gene ids ascend within each position exactly as the reference's
// sequential inserts produce (bloomfilter.h:61-75).
void* shk_build(const char* fasta_path, int k, uint64_t size_bits,
                int threads) {
  BuildResult* r = new BuildResult;
  PhaseTrace tr;
  r->size_bits = size_bits;
  r->threads = threads > 0 ? threads : 1;
  if (size_bits == 0 || size_bits % 64 != 0) {
    // matches the Python builder's guard (index/build.py): a non-multiple
    // of 32 would let shk_build_fill write past the size_bits/32-word
    // bf_words buffer, and 0 would divide by zero in the hash modulo
    r->err = "size_bits must be a positive multiple of 64";
    return r;
  }
  FastxReader fr(fasta_path);
  if (!fr.ok()) {
    r->err = "cannot open fasta";
    return r;
  }
  // read all records up front (sequence bytes only; a human transcriptome
  // is a few hundred MB), then scan/hash/dedup genes in parallel. Records
  // come through the kseq-equivalent FastxReader so a FASTQ-format
  // reference (kseq parity: main.cpp:31-32 runs FastaSplitter on kseq)
  // indexes identically to the Python builder — a raw line loop would
  // append '+'/quality lines as sequence and mint phantom genes from
  // quality lines starting with '@' or '>'
  std::vector<std::string> seqs;
  Record rec;
  int prc;
  while ((prc = fr.next(rec)) == 1) {
    seqs.emplace_back(std::move(rec.seq));
    r->names.append(rec.name);
    r->names.push_back('\n');
  }
  if (prc < 0) {
    // an index silently built from a truncated/malformed reference would
    // classify against a partial gene set and still report success
    const char* se = fr.stream_error();
    r->err = se ? se : "malformed FASTA/FASTQ record in reference";
    return r;
  }
  if (seqs.size() > 65536) {
    r->err = "too many genes (uint16 gene-id capacity is 65536)";
    return r;
  }
  tr.mark("read");
  if (size_bits > (1ULL << 47)) {
    r->err = "bloom size exceeds packed-key capacity (2^47 bits)";
    return r;
  }
  int t = r->threads;
  // per-thread key vectors, each kept radix-partitionable: out[b] holds
  // keys whose top byte (key >> 41) == b
  constexpr int kBuckets = 256;
  std::vector<std::vector<uint64_t>> parts(std::max(t, 1));
  {
    std::atomic<int> next_part{0};
    parallel_chunks(seqs.size(), t, [&](uint64_t lo, uint64_t hi) {
      auto& out = parts[next_part.fetch_add(1)];
      std::vector<uint64_t> pos;
      for (uint64_t g = lo; g < hi; g++) {
        pos.clear();
        scan_canonical(seqs[g], k, [&](uint64_t canon, size_t) {
          pos.push_back(xxh64_8(canon) % size_bits);
        });
        std::sort(pos.begin(), pos.end());
        pos.erase(std::unique(pos.begin(), pos.end()), pos.end());
        for (uint64_t p : pos) out.push_back((p << 16) | (uint64_t)g);
      }
    });
  }
  tr.mark("scan+hash");
  uint64_t total = 0;
  for (auto& p : parts) total += p.size();
  if (total > 0x7FFFFFFFULL) {
    r->err = "association overflow: more than 2^31 (position, gene) pairs";
    return r;
  }
  // MSB radix partition into 256 position ranges, then sort each bucket
  // independently (buckets are disjoint in position, so concatenation is
  // globally sorted) — no serial merge pass, no inplace_merge buffers.
  // The radix byte sits above the 16 gene bits + low position bits; with
  // size_bits <= 2^41 several top bits are zero, which only means some
  // buckets stay empty (the partition is still balanced via lower bits
  // when size_bits >= 2^25... for small filters one bucket gets all keys
  // and a single std::sort handles it, which is fine at that scale).
  int key_bits = 17;  // 16 gene bits + at least 1 position bit
  while ((1ULL << (key_bits - 16)) < size_bits) key_bits++;
  const int shift = std::max(16, key_bits - 8);
  r->keys.resize(total);
  {
    // histogram per part, then exclusive global offsets [part][bucket]
    int np = (int)parts.size();
    std::vector<std::vector<uint64_t>> hist(
        np, std::vector<uint64_t>(kBuckets, 0));
    parallel_chunks(np, t, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++)
        for (uint64_t key : parts[i]) hist[i][(int)(key >> shift)]++;
    });
    std::vector<uint64_t> bucket_off(kBuckets + 1, 0);
    for (int b = 0; b < kBuckets; b++) {
      uint64_t s = 0;
      for (int i = 0; i < np; i++) s += hist[i][b];
      bucket_off[b + 1] = bucket_off[b] + s;
    }
    // scatter: each part writes its keys at its own cursor per bucket
    std::vector<std::vector<uint64_t>> cursor(
        np, std::vector<uint64_t>(kBuckets, 0));
    for (int b = 0; b < kBuckets; b++) {
      uint64_t at = bucket_off[b];
      for (int i = 0; i < np; i++) {
        cursor[i][b] = at;
        at += hist[i][b];
      }
    }
    parallel_chunks(np, t, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++) {
        for (uint64_t key : parts[i])
          r->keys[cursor[i][(int)(key >> shift)]++] = key;
        parts[i].clear();
        parts[i].shrink_to_fit();
      }
    });
    tr.mark("partition");
    // sort buckets, fattest first so threads stay busy
    std::vector<int> order(kBuckets);
    for (int b = 0; b < kBuckets; b++) order[b] = b;
    std::sort(order.begin(), order.end(), [&](int a, int b2) {
      return bucket_off[a + 1] - bucket_off[a] >
             bucket_off[b2 + 1] - bucket_off[b2];
    });
    std::atomic<int> next{0};
    int nw = std::max(1, t);
    std::vector<std::thread> pool;
    for (int w = 0; w < nw; w++)
      pool.emplace_back([&] {
        while (true) {
          int i = next.fetch_add(1);
          if (i >= kBuckets) return;
          int b = order[i];
          std::sort(r->keys.begin() + bucket_off[b],
                    r->keys.begin() + bucket_off[b + 1]);
        }
      });
    for (auto& th : pool) th.join();
  }
  tr.mark("sort");
  // distinct-position count (parallel: chunk counts + boundary fix-up)
  {
    size_t n = r->keys.size();
    int nt = std::max(1, t);
    std::vector<uint64_t> cnt(nt, 0);
    std::vector<size_t> bounds(nt + 1);
    for (int i = 0; i <= nt; i++) bounds[i] = n * (uint64_t)i / nt;
    parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t c = 0;
        uint64_t prev =
            i == 0 || bounds[i] == 0 ? ~0ULL : r->keys[bounds[i] - 1] >> 16;
        for (size_t j = bounds[i]; j < bounds[i + 1]; j++) {
          c += (r->keys[j] >> 16) != prev;
          prev = r->keys[j] >> 16;
        }
        cnt[i] = c;
      }
    });
    for (int i = 0; i < nt; i++) r->n_set += cnt[i];
  }
  tr.mark("count");
  if (r->n_set > 0xFFFFFFFFULL) {
    // uint32 rank capacity (matches the Python builder's guard,
    // index/build.py): a dense multi-GiB filter can exceed 2^32 set bits
    r->err = "rank overflow: more than 2^32 set bits";
  }
  return r;
}

// Sizes: n_words, n_offsets, n_assoc, names_bytes; returns 0 ok, -1 error.
int shk_build_sizes(void* h, int64_t* out4) {
  BuildResult* r = (BuildResult*)h;
  if (!r->err.empty()) return -1;
  out4[0] = (int64_t)(r->size_bits / 32);
  out4[1] = (int64_t)(r->n_set + 1);
  out4[2] = (int64_t)r->keys.size();
  out4[3] = (int64_t)r->names.size();
  return 0;
}

const char* shk_build_error(void* h) { return ((BuildResult*)h)->err.c_str(); }

// Assemble the index directly into caller-owned buffers (sized per
// shk_build_sizes). bf_words MUST arrive zeroed (np.zeros); word_rank,
// offsets, gene_ids are fully overwritten.
void shk_build_fill(void* h, uint32_t* bf_words, uint32_t* word_rank,
                    int32_t* offsets, uint16_t* gene_ids, char* names) {
  BuildResult* r = (BuildResult*)h;
  PhaseTrace tr;
  int t = r->threads;
  size_t n = r->keys.size();
  // bit-set: keys are position-sorted, so chunks split at WORD
  // boundaries touch disjoint bf_words ranges (no atomics needed)
  {
    int nt = std::max(1, t);
    std::vector<size_t> cut(nt + 1, n);
    cut[0] = 0;
    for (int i = 1; i < nt; i++) {
      size_t target = n * (uint64_t)i / nt;
      // advance past keys sharing the boundary key's WORD
      uint64_t w = target < n ? (r->keys[target] >> 21) : ~0ULL;
      while (target < n && (r->keys[target] >> 21) == w) target++;
      cut[i] = std::max(cut[i - 1], target);
    }
    parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++)
        for (size_t j = cut[i]; j < cut[i + 1]; j++) {
          uint64_t p = r->keys[j] >> 16;
          bf_words[p >> 5] |= 1u << (p & 31);
        }
    });
  }
  tr.mark("bitset");
  // exclusive prefix popcount: per-block sums, serial block prefix,
  // parallel fill (the serial pass over 2^28 words was ~1s of the build)
  uint64_t n_words = r->size_bits / 32;
  {
    int nt = std::max(1, t);
    std::vector<uint64_t> bsum(nt, 0);
    std::vector<uint64_t> wb(nt + 1);
    for (int i = 0; i <= nt; i++) wb[i] = n_words * (uint64_t)i / nt;
    parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t s = 0;
        for (uint64_t w = wb[i]; w < wb[i + 1]; w++)
          s += __builtin_popcount(bf_words[w]);
        bsum[i] = s;
      }
    });
    std::vector<uint64_t> base(nt + 1, 0);
    for (int i = 0; i < nt; i++) base[i + 1] = base[i] + bsum[i];
    parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t acc = base[i];
        for (uint64_t w = wb[i]; w < wb[i + 1]; w++) {
          word_rank[w] = (uint32_t)acc;
          acc += __builtin_popcount(bf_words[w]);
        }
      }
    });
  }
  tr.mark("rank");
  // CSR: gene_ids[j] is a pure map of keys[j]; offsets[d] = first key
  // index of the d-th distinct position. Distinct ranks come from
  // per-chunk counts + an exclusive prefix, so both fills parallelize.
  {
    int nt = std::max(1, t);
    std::vector<size_t> bounds(nt + 1);
    for (int i = 0; i <= nt; i++) bounds[i] = n * (uint64_t)i / nt;
    std::vector<uint64_t> dcnt(nt, 0);
    parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t c = 0;
        uint64_t prev = i == 0 || bounds[i] == 0
                            ? ~0ULL
                            : r->keys[bounds[i] - 1] >> 16;
        for (size_t j = bounds[i]; j < bounds[i + 1]; j++) {
          c += (r->keys[j] >> 16) != prev;
          prev = r->keys[j] >> 16;
        }
        dcnt[i] = c;
      }
    });
    std::vector<uint64_t> dbase(nt + 1, 0);
    for (int i = 0; i < nt; i++) dbase[i + 1] = dbase[i] + dcnt[i];
    offsets[0] = 0;
    parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t d = dbase[i];
        uint64_t prev = i == 0 || bounds[i] == 0
                            ? ~0ULL
                            : r->keys[bounds[i] - 1] >> 16;
        for (size_t j = bounds[i]; j < bounds[i + 1]; j++) {
          uint64_t key = r->keys[j];
          uint64_t p = key >> 16;
          if (p != prev) offsets[d++] = (int32_t)j;
          gene_ids[j] = (uint16_t)(key & 0xFFFF);
          prev = p;
        }
      }
    });
    if (n) offsets[dbase[nt]] = (int32_t)n;
  }
  tr.mark("csr");
  memcpy(names, r->names.data(), r->names.size());
}

void shk_build_free(void* h) { delete (BuildResult*)h; }

// Ascending positions of set bits of a Bloom bit-vector (uint32 words,
// LSB-first within a word — the layout shk_build_fill/index.structure
// use). Parallel: each thread scans a word range and writes into its
// exclusive-prefix-popcount slice of `out`, so the result is identical
// for any thread count. Serves the hashed/xl table packers
// (shark_tpu/classify/hashed.py _set_bit_positions): the numpy paths
// measured 20-25 s at transcriptome scale (72M set bits / 1 GiB vector,
// docs/PERF.md "XL build cost") vs ~1-2 s here — this is a pure
// bandwidth scan. Returns the number of positions written (== the
// vector's total popcount); `out` must hold at least that many u64.
int64_t shk_set_positions(const uint32_t* words, uint64_t n_words,
                          uint64_t* out, int64_t out_cap, int threads) {
  int nt = std::max(1, threads);
  std::vector<uint64_t> wb(nt + 1);
  for (int i = 0; i <= nt; i++) wb[i] = n_words * (uint64_t)i / nt;
  std::vector<uint64_t> csum(nt, 0);
  parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++) {
      uint64_t s = 0;
      for (uint64_t w = wb[i]; w < wb[i + 1]; w++)
        s += __builtin_popcount(words[w]);
      csum[i] = s;
    }
  });
  std::vector<uint64_t> base(nt + 1, 0);
  for (int i = 0; i < nt; i++) base[i + 1] = base[i] + csum[i];
  // the caller sizes `out` from its index metadata; if the vector's true
  // popcount disagrees (corrupt/mixed index files), report it WITHOUT
  // writing — the Python wrapper raises instead of overflowing the heap
  if ((int64_t)base[nt] > out_cap) return (int64_t)base[nt];
  parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++) {
      uint64_t* o = out + base[i];
      for (uint64_t w = wb[i]; w < wb[i + 1]; w++) {
        uint32_t v = words[w];
        uint64_t p = w << 5;
        while (v) {
          *o++ = p + (uint64_t)__builtin_ctz(v);
          v &= v - 1;
        }
      }
    }
  });
  return (int64_t)base[nt];
}

// Hashed-probe-table pack (shark_tpu/classify/hashed.py _pack_table),
// entry streams + bucket fill in one native pass. The numpy pack
// allocates ~15 fresh 72M-element temporaries at transcriptome scale and
// this VM class faults fresh pages at 0.1-1 GB/s with heavy weather
// variance — the xl table build measured 80-97 s host-side. Here:
// threads own disjoint BUCKET ranges and each scans the whole
// bit-vector, so per-bucket slot cursors are thread-private and entry
// order within a bucket is ascending-position by construction (~4-6 s
// at 4 threads; equality-tested against the numpy pack in
// tests/test_native.py).
//
// Semantics are EXACTLY hashed.py's: one entry per set Bloom bit in
// ascending position (== CSR rank) order; bucket = pos & (2^lgB - 1);
// entries take a bucket's slot words first-come in position order — one
// word when the CSR degree is 1, two otherwise. entry16 layout:
// meta16 = ((tag << 14) | pos >> lgB) << 16 with the payload halves in
// the word lows; entry8 layout (planar [n_buckets, 2, 8]): w0 =
// tag << 30 | pos >> lgB, w1 = payload. Entries that do not fit append
// to the spill list as (pos_lo, pos_hi, tag, payload) rows, merged
// across threads back into global position order. tag/payload carry the
// reference association semantics (bloomfilter.h:61-75): deg 1 ->
// (1, gene); deg 2 -> (2, g0 | g1 << 16); deg >= 3 ->
// (3, d3_payload[rank among deg>=3 bits]) with d3_payload precomputed
// by the caller (compacted rows3 index + group-id bits).
//
// Returns the spill count, or -1 when it exceeds spill_cap (caller
// declines the geometry and retries a larger one). `table` must arrive
// zeroed: n_buckets*slots u32 (entry16) or n_buckets*16 u32 (entry8,
// slots fixed at 8).
int64_t shk_pack_xl(const uint32_t* bf_words, uint64_t n_words,
                    const int32_t* offsets, int64_t n_set,
                    const uint16_t* gene_ids, const uint32_t* d3_payload,
                    int lgB, int slots, int entry16, uint32_t* table,
                    uint32_t* spill_out, int64_t spill_cap, int threads) {
  int nt = std::max(1, threads);
  // same corrupt-index guard class as shk_set_positions: offsets/gene_ids
  // are sized by the caller's index metadata (n_set = offsets entries - 1);
  // if the bit-vector's popcount disagrees, reading CSR rows past n_set
  // would be UB — check up front (parallel scan) and report -2 so Python
  // raises.
  {
    std::vector<uint64_t> pcs(nt, 0);
    parallel_chunks(nt, nt, [&](uint64_t lo, uint64_t hi) {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t a = n_words * i / nt, b = n_words * (i + 1) / nt;
        uint64_t s = 0;
        for (uint64_t w = a; w < b; w++)
          s += __builtin_popcount(bf_words[w]);
        pcs[i] = s;
      }
    });
    uint64_t pc = 0;
    for (int i = 0; i < nt; i++) pc += pcs[i];
    if ((int64_t)pc != n_set) return -2;
  }
  uint64_t n_buckets = 1ULL << lgB;
  uint64_t mask = n_buckets - 1;
  std::vector<std::vector<uint32_t>> spills(nt);
  std::atomic<int64_t> spill_total{0};
  parallel_chunks(nt, nt, [&](uint64_t tlo, uint64_t thi) {
    for (uint64_t t = tlo; t < thi; t++) {
      uint64_t b_lo = n_buckets * t / nt;
      uint64_t b_hi = n_buckets * (t + 1) / nt;
      std::vector<uint8_t> cursor(b_hi - b_lo, 0);
      auto& sp = spills[t];
      uint64_t r = 0, d3r = 0;
      for (uint64_t w = 0; w < n_words; w++) {
        uint32_t v = bf_words[w];
        if (!v) continue;
        uint64_t pbase = w << 5;
        while (v) {
          uint64_t p = pbase + (uint64_t)__builtin_ctz(v);
          v &= v - 1;
          uint64_t rr = r++;
          int32_t o0 = offsets[rr];
          int deg = offsets[rr + 1] - o0;
          uint64_t my_d3 = d3r;
          if (deg >= 3) d3r++;
          uint64_t b = p & mask;
          if (b < b_lo || b >= b_hi) continue;
          uint32_t tag, pay;
          if (deg == 1) {
            tag = 1u;
            pay = gene_ids[o0];
          } else if (deg == 2) {
            tag = 2u;
            pay = (uint32_t)gene_ids[o0] |
                  ((uint32_t)gene_ids[o0 + 1] << 16);
          } else if (deg >= 3) {
            tag = 3u;
            pay = d3_payload[my_d3];
          } else {
            // deg == 0: a set bit with an EMPTY CSR row only occurs in a
            // corrupt index (the popcount guard cannot see it) — emit a
            // deterministic in-bounds row-tag with a zero payload rather
            // than reading d3_payload past its end (my_d3 was not
            // advanced for this bit)
            tag = 3u;
            pay = 0;
          }
          // slot demand: entry16 splits a 32-bit payload across two
          // words; entry8 stores every entry in one (w0, w1) slot pair
          int need = (entry16 && deg != 1) ? 2 : 1;
          int cur = cursor[b - b_lo];
          // the numpy pack assigns slots by the prefix of ALL needs in
          // the bucket — a spilled entry still advances the cursor and
          // its hole is never reused; saturate far above max slots so
          // overfull buckets keep spilling without uint8 wraparound
          cursor[b - b_lo] = (uint8_t)std::min(cur + need, 64);
          if (cur + need <= slots) {
            uint32_t rest = (uint32_t)(p >> lgB);
            if (entry16) {
              uint32_t meta16 = ((tag << 14) | rest) << 16;
              uint32_t* row = table + b * (uint64_t)slots;
              row[cur] = meta16 | (pay & 0xFFFF);
              if (need == 2) row[cur + 1] = meta16 | (pay >> 16);
            } else {
              // entry8 is planar and single-word-per-entry (need
              // collapses to 1 slot: tag word + payload word pair)
              uint32_t* row = table + b * 16;
              row[cur] = (tag << 30) | rest;
              row[8 + cur] = pay;
            }
          } else {
            sp.push_back((uint32_t)(p & 0xFFFFFFFFu));
            sp.push_back((uint32_t)(p >> 32));
            sp.push_back(tag);
            sp.push_back(pay);
          }
        }
      }
      spill_total.fetch_add((int64_t)(sp.size() / 4));
    }
  });
  int64_t total = spill_total.load();
  if (total > spill_cap) return -1;
  // numpy emits spill rows in (bucket, position) order — its stable
  // argsort is bucket-major with position order within a bucket. Each
  // thread's list is position-ascending over ITS bucket range, so a
  // stable per-thread sort by bucket plus concatenation in (ascending)
  // thread-range order reproduces that exactly. Spill counts are tiny.
  uint32_t* out = spill_out;
  for (auto& sp : spills) {
    size_t n = sp.size() / 4;
    if (!n) continue;
    std::vector<uint32_t> idx(n);
    for (size_t i = 0; i < n; i++) idx[i] = (uint32_t)i;
    std::stable_sort(idx.begin(), idx.end(),
                     [&](uint32_t a, uint32_t b) {
                       uint64_t pa = (uint64_t)sp[a * 4] |
                                     ((uint64_t)sp[a * 4 + 1] << 32);
                       uint64_t pb = (uint64_t)sp[b * 4] |
                                     ((uint64_t)sp[b * 4 + 1] << 32);
                       return (pa & mask) < (pb & mask);
                     });
    for (size_t i = 0; i < n; i++) {
      memcpy(out, sp.data() + idx[i] * 4, 16);
      out += 4;
    }
  }
  return total;
}

}  // extern "C"
