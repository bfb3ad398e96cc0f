// Native sequence packer: the hot host-side loop of the input pipeline
// (the port's own copy of torchacc_tpu/data/_native/pack.cc).
//
// Documents are packed into fixed-length rows with segment ids, and the
// flash-attention kernels mask across segment boundaries, so every step
// sees one shape.  Packing runs per batch on the host data path, so it
// is implemented natively.  This is host C++, not a device kernel.
//
// Algorithm: first-fit-decreasing bin packing over row capacity, stable
// within equal lengths.  Exposed via a C ABI for ctypes; compiled by g++
// at first use into torchacc_tpu_torch/_build/ (ops/_build.py load_host).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Plan the packing: given doc lengths and row capacity, assign each doc a
// (row, offset).  Returns the number of rows used, or -1 on error.
// docs longer than seq_len are truncated to seq_len.
int64_t pack_plan(const int64_t* lengths, int64_t n_docs, int64_t seq_len,
                  int64_t* row_of_doc, int64_t* offset_of_doc) {
  if (n_docs <= 0 || seq_len <= 0) return -1;
  std::vector<int64_t> order(n_docs);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) {
                     return lengths[a] > lengths[b];
                   });
  std::vector<int64_t> space;  // free space per row
  for (int64_t idx : order) {
    int64_t len = std::min<int64_t>(lengths[idx], seq_len);
    if (len <= 0) len = 0;
    // first fit
    int64_t row = -1;
    for (size_t r = 0; r < space.size(); ++r) {
      if (space[r] >= len) { row = static_cast<int64_t>(r); break; }
    }
    if (row < 0) {
      row = static_cast<int64_t>(space.size());
      space.push_back(seq_len);
    }
    row_of_doc[idx] = row;
    offset_of_doc[idx] = seq_len - space[row];
    space[row] -= len;
  }
  return static_cast<int64_t>(space.size());
}

// Materialise the packed batch. tokens: concatenated docs; doc_starts has
// n_docs+1 entries.  out_* are [n_rows, seq_len], pre-filled by caller
// with pad_id / -1 / 0.  Returns 0 on success.
int64_t pack_fill(const int32_t* tokens, const int64_t* doc_starts,
                  int64_t n_docs, int64_t seq_len,
                  const int64_t* row_of_doc, const int64_t* offset_of_doc,
                  int32_t* out_tokens, int32_t* out_segments,
                  int32_t* out_positions) {
  for (int64_t d = 0; d < n_docs; ++d) {
    int64_t len = doc_starts[d + 1] - doc_starts[d];
    if (len > seq_len) len = seq_len;
    int64_t row = row_of_doc[d];
    int64_t off = offset_of_doc[d];
    if (off + len > seq_len) return -1;
    int32_t* trow = out_tokens + row * seq_len + off;
    int32_t* srow = out_segments + row * seq_len + off;
    int32_t* prow = out_positions + row * seq_len + off;
    std::memcpy(trow, tokens + doc_starts[d], len * sizeof(int32_t));
    for (int64_t i = 0; i < len; ++i) {
      srow[i] = static_cast<int32_t>(d);
      prow[i] = static_cast<int32_t>(i);
    }
  }
  return 0;
}

}  // extern "C"
