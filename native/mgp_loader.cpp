// Native host-side data pipeline: mmap'd CSV numeric parsing and a
// seeded epoch shuffler.
//
// Role: the reference's input pipeline is tf.data's C++ runtime
// (reference demos/demo_tf2.py:53-56); this is the equivalent native layer
// for this framework — the device compute path stays in XLA, host IO
// and batch assembly stay off the Python interpreter.
//
// Exposed C ABI (consumed via ctypes from modulatedgps_tpu/data/native.py):
//   mgp_csv_open / mgp_csv_dims / mgp_csv_read_columns / mgp_csv_close
//   mgp_shuffle_epoch(seed, epoch, n, out_idx)   — SplitMix64 Fisher-Yates
//   mgp_gather_rows(src, n_rows, n_cols, idx, n_idx, dst)
//
// Build: make -C native   (produces libmgploader.so)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct MgpCsv {
  char* data = nullptr;      // mmap'd file
  size_t size = 0;
  int64_t n_rows = 0;        // data rows (excluding header)
  int64_t n_cols = 0;
  std::vector<std::string>* header = nullptr;
  std::vector<size_t>* row_offsets = nullptr;  // offset of each data row
};

// ---------------------------------------------------------------- open

MgpCsv* mgp_csv_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;

  auto* csv = new MgpCsv;
  csv->data = static_cast<char*>(mem);
  csv->size = st.st_size;
  csv->header = new std::vector<std::string>;
  csv->row_offsets = new std::vector<size_t>;

  // header
  size_t pos = 0;
  size_t line_start = 0;
  while (pos < csv->size && csv->data[pos] != '\n') pos++;
  {
    std::string field;
    for (size_t i = line_start; i < pos; i++) {
      char c = csv->data[i];
      if (c == ',') { csv->header->push_back(field); field.clear(); }
      else if (c != '\r') field.push_back(c);
    }
    csv->header->push_back(field);
  }
  csv->n_cols = static_cast<int64_t>(csv->header->size());
  pos++;  // past newline

  // index data rows
  while (pos < csv->size) {
    // skip blank lines
    if (csv->data[pos] == '\n' || csv->data[pos] == '\r') { pos++; continue; }
    csv->row_offsets->push_back(pos);
    while (pos < csv->size && csv->data[pos] != '\n') pos++;
    pos++;
  }
  csv->n_rows = static_cast<int64_t>(csv->row_offsets->size());
  return csv;
}

void mgp_csv_dims(MgpCsv* csv, int64_t* n_rows, int64_t* n_cols) {
  *n_rows = csv->n_rows;
  *n_cols = csv->n_cols;
}

int64_t mgp_csv_col_index(MgpCsv* csv, const char* name) {
  for (size_t i = 0; i < csv->header->size(); i++)
    if ((*csv->header)[i] == name) return static_cast<int64_t>(i);
  return -1;
}

int mgp_csv_header_name(MgpCsv* csv, int64_t i, char* out, int64_t cap) {
  if (i < 0 || i >= csv->n_cols) return -1;
  const std::string& s = (*csv->header)[i];
  if (static_cast<int64_t>(s.size()) + 1 > cap) return -1;
  std::memcpy(out, s.c_str(), s.size() + 1);
  return 0;
}

// Parse selected columns into a dense double matrix [n_rows, n_sel]
// (column-major per selected column). Non-numeric cells parse as NaN;
// the string values the John Doe filters need are matched via
// mgp_csv_match_column instead.
int mgp_csv_read_columns(MgpCsv* csv, const int64_t* cols, int64_t n_sel,
                         double* out /* [n_rows * n_sel] row-major */) {
  const char* base = csv->data;
  for (int64_t r = 0; r < csv->n_rows; r++) {
    size_t pos = (*csv->row_offsets)[r];
    int64_t col = 0, sel = 0;
    // walk fields; cols must be ascending
    while (pos <= csv->size && sel < n_sel) {
      // find end of this field
      size_t start = pos;
      while (pos < csv->size && base[pos] != ',' && base[pos] != '\n' &&
             base[pos] != '\r')
        pos++;
      if (col == cols[sel]) {
        char buf[64];
        size_t len = pos - start;
        if (len >= sizeof(buf)) len = sizeof(buf) - 1;
        std::memcpy(buf, base + start, len);
        buf[len] = 0;
        char* end = nullptr;
        double v = strtod(buf, &end);
        out[r * n_sel + sel] = (end == buf) ? NAN : v;
        sel++;
      }
      col++;
      if (pos >= csv->size || base[pos] == '\n' || base[pos] == '\r') break;
      pos++;  // skip comma
    }
    for (; sel < n_sel; sel++) out[r * n_sel + sel] = NAN;
  }
  return 0;
}

// mask[r] = 1 if row r's column `col` equals any of the `n_vals` strings
// (passed as a single \0-joined buffer).
int mgp_csv_match_column(MgpCsv* csv, int64_t col, const char* vals,
                         int64_t n_vals, uint8_t* mask) {
  std::vector<std::string> targets;
  const char* p = vals;
  for (int64_t i = 0; i < n_vals; i++) {
    targets.emplace_back(p);
    p += targets.back().size() + 1;
  }
  const char* base = csv->data;
  for (int64_t r = 0; r < csv->n_rows; r++) {
    size_t pos = (*csv->row_offsets)[r];
    int64_t c = 0;
    size_t start = pos;
    while (pos <= csv->size) {
      if (pos == csv->size || base[pos] == ',' || base[pos] == '\n' ||
          base[pos] == '\r') {
        if (c == col) break;
        c++;
        start = pos + 1;
      }
      pos++;
    }
    std::string cell(base + start, pos - start);
    uint8_t hit = 0;
    for (const auto& t : targets)
      if (cell == t) { hit = 1; break; }
    mask[r] = hit;
  }
  return 0;
}

void mgp_csv_close(MgpCsv* csv) {
  if (!csv) return;
  if (csv->data) munmap(csv->data, csv->size);
  delete csv->header;
  delete csv->row_offsets;
  delete csv;
}

// ------------------------------------------------------------- shuffler

static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Deterministic per-(seed, epoch) Fisher-Yates permutation of [0, n).
void mgp_shuffle_epoch(uint64_t seed, uint64_t epoch, int64_t n,
                       int32_t* out_idx) {
  for (int64_t i = 0; i < n; i++) out_idx[i] = static_cast<int32_t>(i);
  uint64_t s = seed * 0x9e3779b97f4a7c15ULL + epoch + 1;
  for (int64_t i = n - 1; i > 0; i--) {
    uint64_t j = splitmix64(s) % static_cast<uint64_t>(i + 1);
    int32_t t = out_idx[i];
    out_idx[i] = out_idx[j];
    out_idx[j] = t;
  }
}

// Gather rows of a row-major [n_rows, n_cols] double matrix.
void mgp_gather_rows(const double* src, int64_t n_rows, int64_t n_cols,
                     const int32_t* idx, int64_t n_idx, double* dst) {
  for (int64_t i = 0; i < n_idx; i++) {
    const double* row = src + static_cast<int64_t>(idx[i]) * n_cols;
    std::memcpy(dst + i * n_cols, row, sizeof(double) * n_cols);
  }
}

}  // extern "C"
