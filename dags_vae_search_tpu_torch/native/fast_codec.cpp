// Host C++ edge codec of the corpus schema, for the port's graphs/codec.py.
//
// Counterpart of dags_vae_search_tpu/native/fast_codec.cpp, with the same
// C ABI.  A corpus stores, for every slot i >= 1, the column e{i}: each
// row's in-edges from slots j < i as i bytes of '0'/'1'.  Decoding scatters
// those bytes into dense float32 adjacency rows; encoding is the reverse.
// One pass over contiguous byte buffers, no Python objects per row.
//
// Built by dags_vae_search_tpu_torch/native/__init__.py at first use:
//   g++ -O3 -shared -fPIC -std=c++17 -o <build>/libfast_codec_<hash>.so fast_codec.cpp

#include <cstdint>

extern "C" {

// adj[rows, n, n] (row-major float32) from the edge columns: cols[i] (i >= 1)
// points at rows * i bytes, row r's bits at cols[i] + r * i, and
// adj[r, j, i] = bits[j] - '0'; every other entry is zero.  cols[0] is not
// read; a null column leaves its entries at zero.  adj is written once, in
// order, one matrix row at a time: the JAX package's column-by-column
// scatter writes with a stride of n floats, and at n = 724 it ran slower
// than the numpy decode (chip_smoke.py phase 12).
void decode_edges(const char** cols, int64_t n, int64_t rows, float* adj) {
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t j = 0; j < n; ++j) {
      float* dst = adj + (r * n + j) * n;
      for (int64_t i = 0; i <= j; ++i) dst[i] = 0.0f;
      for (int64_t i = j + 1; i < n; ++i) {
        const char* col = cols[i];
        dst[i] = col == nullptr ? 0.0f : static_cast<float>(col[r * i + j] - '0');
      }
    }
  }
}

// The edge columns of adj[rows, n, n]: out[i] (i >= 1) receives rows * i
// bytes, '1' where adj[r, j, i] > 0 and '0' elsewhere.  A null out[i] is
// skipped.
void encode_edges(const float* adj, int64_t n, int64_t rows, char** out) {
  const int64_t nn = n * n;
  for (int64_t i = 1; i < n; ++i) {
    char* col = out[i];
    if (col == nullptr) continue;
    for (int64_t r = 0; r < rows; ++r) {
      const float* src = adj + r * nn + i;
      char* bits = col + r * i;
      for (int64_t j = 0; j < i; ++j) bits[j] = src[j * n] > 0.0f ? '1' : '0';
    }
  }
}

}  // extern "C"
