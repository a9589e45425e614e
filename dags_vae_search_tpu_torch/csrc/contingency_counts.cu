// Contingency-count kernels for batched BIC scoring, CUDA C++ for sm_90a.
//
// Replaces: dags_vae_search_tpu/ops/bic_pallas.py::_counts_kernel, the TPU
// kernel launched by contingency_counts_pallas, together with the
// configuration product that feeds it there (bic_pallas.py:108-121).  For
// every row r = (candidate b, node i) both entries compute the weighted
// histogram
//
//     out[r, s] = sum_u w[u] * [cell(r, u) == s],   s in [0, S = q_cap * r_max)
//
// over the U unique dataset rows, with w[u] the row's multiplicity and
//
//     cell(r, u) = min(cfg, q_cap - 1) * r_max + codes[u, i],
//     cfg        = sum_m stride[b, m, i] * codes[u, m].
//
// - contingency_counts_fused_kernel computes cell itself from the strides and
//   the column-major codes; the [B, n, U] cell table is never written.
// - contingency_counts_kernel takes the cell table (seg) ready-made: the
//   one-to-one counterpart of the Pallas kernel's contract.
// Cells outside the row's range (padding sentinels) are skipped.
//
// Bound.  The fused entry reads the strides (B*n*n f32), the codes (n*U
// bytes, L2-resident) and w, and writes R*S f32 counts: at the alarm search
// shape about 167 MB, 0.05 ms at 3.35 TB/s.  Its integer work, about
// U * (parents + 2) operations per row, is the larger bound there.  The seg
// entry reads R*U int32 cells and is bound by those bytes.
//
// Design.  The TPU kernel turns counting into a dense [U, S] compare-select
// because its vector unit has no scatter.  Here one warp owns one row at a
// time and keeps the row's histogram in its own slice of shared memory, so
// no other warp ever touches it:
// - Bins are uint32 and the weights integers: shared-memory integer atomics
//   are native instructions (float ones are compare-and-swap loops), and any
//   order of integer adds is exact.  Converted to float on the way out, the
//   counts equal the plain float scatter-add bit for bit while every bin
//   stays below 2^24.
// - Strides are compacted per row into a parent list (offset, stride), each
//   stride saturated at q_cap.  Every term is non-negative and a saturated
//   term with a nonzero code already gives cfg >= q_cap, so
//   min(cfg, q_cap - 1) equals the clip of the exact product: int32 math
//   gives the plain path's cells exactly, with no float product to keep out
//   of TF32.
// - A row whose reachable cells all lie below small_span (few parents, few
//   levels: binary data sends a node with k parents to 2^(k+1) cells) gets
//   one private sub-histogram per lane, laid out lane-minor (bin s of lane l
//   at s * 32 + l): every lane hits its own bank, adds with no atomic, and a
//   bank-rotated sum over the lanes follows.  Other rows, and every seg row,
//   take shared atomics on the S bins, where a warp's 32 cells rarely
//   collide.
// - Each lane handles 4 consecutive rows u per step: one 32-bit load brings
//   their uint8 codes of one parent column (one 16-byte load for int32).
// - All S bins are written, zeros included, with float4 stores when S % 4 == 0.
//
// Wide rows.  A row whose S bins do not fit one warp's share of a block
// (S > 58,112, e.g. q_cap 4,096 x 16 states) takes the wide kernels, one per
// entry, with the same contract.  They tile S over blocks: a block owns one
// (row, tile) pair, all of its warps scan the row's U cells and add those
// that fall in the tile to one shared histogram (shared integer atomics, as
// above), then the block stores the tile.  The fused wide kernel recomputes
// the row's configurations for every tile; that integer work is small beside
// the output it writes, R*S*4 bytes, which bounds this route.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
// Most dynamic shared memory one block can take on Hopper (227 KB).
constexpr int kMaxSharedBytes = 232448;
// The wide kernels: threads per block and the most bins of one tile (64 KB,
// so three blocks share an SM).  ops/bic_kernel.py mirrors kWideTileBins.
constexpr int kWideThreads = 512;
constexpr int kWideTileBins = 16384;

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

// ---- the histogram core, shared by both entries ---------------------------

// Zero `words` (a multiple of 4) 32-bit words at the 16-byte aligned `p`.
__device__ __forceinline__ void warp_zero(uint32_t* p, int words, int lane) {
  uint4* v = reinterpret_cast<uint4*>(p);
  for (int k = lane; k < words / 4; k += kWarp) v[k] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void hist_add(uint32_t* hist, int cell, int bound, uint32_t w) {
  if (static_cast<unsigned>(cell) < static_cast<unsigned>(bound)) atomicAdd(&hist[cell], w);
}

// Write the S bins of `hist` (16-byte aligned, at least round_up4(S) words)
// to one output row.  Counts below 2^24 convert to float exactly.
__device__ __forceinline__ void warp_store_bins(const uint32_t* hist, float* out_row, int S,
                                                int lane) {
  if ((S & 3) == 0) {
    const uint4* h = reinterpret_cast<const uint4*>(hist);
    float4* o = reinterpret_cast<float4*>(out_row);
    for (int k = lane; k < S / 4; k += kWarp) {
      const uint4 c = h[k];
      o[k] = make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                         static_cast<float>(c.z), static_cast<float>(c.w));
    }
  } else {
    for (int s = lane; s < S; s += kWarp) out_row[s] = static_cast<float>(hist[s]);
  }
}

// Sum of the 32 lanes' private counts of cell s (s < span), read from the
// lane-minor layout with the lane index rotated so the warp hits 32 banks.
__device__ __forceinline__ uint32_t lane_minor_sum(const uint32_t* priv, int s, int span,
                                                   int lane) {
  if (s >= span) return 0u;
  const uint32_t* col = priv + s * kWarp;
  uint32_t sum = 0u;
#pragma unroll
  for (int j = 0; j < kWarp; ++j) sum += col[(j + lane) & (kWarp - 1)];
  return sum;
}

__device__ __forceinline__ void warp_store_lane_minor(const uint32_t* priv, int span,
                                                      float* out_row, int S, int lane) {
  if ((S & 3) == 0) {
    float4* o = reinterpret_cast<float4*>(out_row);
    for (int k = lane; k < S / 4; k += kWarp) {
      const int s = 4 * k;
      o[k] = make_float4(static_cast<float>(lane_minor_sum(priv, s, span, lane)),
                         static_cast<float>(lane_minor_sum(priv, s + 1, span, lane)),
                         static_cast<float>(lane_minor_sum(priv, s + 2, span, lane)),
                         static_cast<float>(lane_minor_sum(priv, s + 3, span, lane)));
    }
  } else {
    for (int s = lane; s < S; s += kWarp) {
      out_row[s] = static_cast<float>(lane_minor_sum(priv, s, span, lane));
    }
  }
}

// ---- the seg entry --------------------------------------------------------

__global__ void __launch_bounds__(kMaxWarps * kWarp)
contingency_counts_kernel(const uint32_t* __restrict__ w, const int32_t* __restrict__ seg,
                          float* __restrict__ out, int64_t R, int U, int S,
                          int region_words) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (row >= R) return;  // whole warps leave; no block barrier follows
  uint32_t* hist = smem + warp * region_words;
  warp_zero(hist, round_up4(S), lane);
  __syncwarp();

  const int32_t* seg_row = seg + row * static_cast<int64_t>(U);
  int u = lane;
  // four independent loads in flight per lane before their atomics
  for (; u + 3 * kWarp < U; u += 4 * kWarp) {
    int s[4];
    uint32_t wu[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = __ldg(seg_row + u + j * kWarp);
      wu[j] = __ldg(w + u + j * kWarp);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) hist_add(hist, s[j], S, wu[j]);
  }
  for (; u < U; u += kWarp) {
    hist_add(hist, __ldg(seg_row + u), S, __ldg(w + u));
  }
  __syncwarp();
  warp_store_bins(hist, out + row * static_cast<int64_t>(S), S, lane);
}

// ---- the fused entry ------------------------------------------------------

// Four consecutive codes of one column from one aligned load: 32 bits of
// uint8 codes or 128 bits of int32 codes.
template <typename Code>
struct Codes4;

template <>
struct Codes4<uint8_t> {
  uint32_t word;
  __device__ __forceinline__ explicit Codes4(const uint8_t* p)
      : word(__ldg(reinterpret_cast<const unsigned int*>(p))) {}
  __device__ __forceinline__ int operator[](int j) const {
    return static_cast<int>(__byte_perm(word, 0u, 0x4440u + j));
  }
};

template <>
struct Codes4<int32_t> {
  int4 v;
  __device__ __forceinline__ explicit Codes4(const int32_t* p)
      : v(__ldg(reinterpret_cast<const int4*>(p))) {}
  __device__ __forceinline__ int operator[](int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

// Count one row: parents[p] = (element offset of parent column p, saturated
// stride); cells at or above `bound` are skipped.
template <bool kLaneMinor, typename Code>
__device__ __forceinline__ void count_row(const int2* parents, int num_parents,
                                          const Code* codes_cm, const Code* child_col,
                                          const uint32_t* w, int U, int q_cap, int r_max,
                                          uint32_t* hist, int bound, int lane) {
  for (int u0 = 4 * lane; u0 < U; u0 += 4 * kWarp) {
    int cfg[4] = {0, 0, 0, 0};
#pragma unroll 2
    for (int p = 0; p < num_parents; ++p) {
      const int2 par = parents[p];
      const Codes4<Code> c(codes_cm + par.x + u0);
#pragma unroll
      for (int j = 0; j < 4; ++j) cfg[j] += par.y * c[j];
    }
    const Codes4<Code> child(child_col + u0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (u0 + j < U) {
        const int cell = min(cfg[j], q_cap - 1) * r_max + child[j];
        const uint32_t wu = __ldg(w + u0 + j);
        if (kLaneMinor) {
          if (static_cast<unsigned>(cell) < static_cast<unsigned>(bound)) {
            hist[cell * kWarp + lane] += wu;
          }
        } else {
          hist_add(hist, cell, bound, wu);
        }
      }
    }
  }
}

// strides_t: f32[R, n], row r = b*n + i holding stride[b, m, i] at m.
// codes_cm: Code[n, ldc], column m of the unique rows, zero beyond U.
// At most 40 registers, so 6 blocks of 8 warps fit an SM (64 registers held
// it to 4 and cost more time than the spill-free cap does).
template <typename Code>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 6)
contingency_counts_fused_kernel(const float* __restrict__ strides_t,
                                const Code* __restrict__ codes_cm,
                                const uint32_t* __restrict__ w, float* __restrict__ out,
                                int64_t R, int n, int U, int ldc, int q_cap, int r_max,
                                int region_words, int small_span) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (row >= R) return;  // whole warps leave; no block barrier follows
  uint32_t* hist = smem + warp * region_words;
  int2* parents = reinterpret_cast<int2*>(smem + warps * region_words) + warp * n;

  // Compact the row's parents; `reach` bounds the configuration they can form.
  const float* srow = strides_t + row * n;
  int num_parents = 0, reach = 0;
  for (int base = 0; base < n; base += kWarp) {
    const int m = base + lane;
    const float s = m < n ? srow[m] : 0.0f;
    const bool is_parent = s > 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, is_parent);
    if (is_parent) {
      // s * (r_max - 1) < q_cap * r_max = S, so no product here overflows
      const int sat = s >= static_cast<float>(q_cap) ? q_cap : static_cast<int>(s);
      parents[num_parents + __popc(mask & ((1u << lane) - 1u))] = make_int2(m * ldc, sat);
      reach = min(reach + sat * (r_max - 1), q_cap);
    }
    num_parents += __popc(mask);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) reach += __shfl_xor_sync(0xffffffffu, reach, off);
  // every cell of this row lies below span
  const int span = (min(reach, q_cap - 1) + 1) * r_max;
  const int S = q_cap * r_max;
  const Code* child_col = codes_cm + static_cast<int64_t>(row % n) * ldc;
  float* out_row = out + row * static_cast<int64_t>(S);

  if (span <= small_span) {
    warp_zero(hist, span * kWarp, lane);
    __syncwarp();
    count_row<true>(parents, num_parents, codes_cm, child_col, w, U, q_cap, r_max, hist, span,
                    lane);
    __syncwarp();
    warp_store_lane_minor(hist, span, out_row, S, lane);
  } else {
    warp_zero(hist, round_up4(S), lane);
    __syncwarp();
    count_row<false>(parents, num_parents, codes_cm, child_col, w, U, q_cap, r_max, hist, S,
                     lane);
    __syncwarp();
    warp_store_bins(hist, out_row, S, lane);
  }
}

// ---- the wide-row route ---------------------------------------------------

// Add w to the tile bin of `cell` when it lies in [t0, t0 + len); unsigned
// arithmetic sends every other cell, negative ones included, out of range.
__device__ __forceinline__ void tile_add(uint32_t* hist, int cell, int t0, int len, uint32_t w) {
  const unsigned local = static_cast<unsigned>(cell) - static_cast<unsigned>(t0);
  if (local < static_cast<unsigned>(len)) atomicAdd(&hist[local], w);
}

// Zero `words` (a multiple of 4) 32-bit words at the 16-byte aligned `p`.
__device__ __forceinline__ void block_zero(uint32_t* p, int words) {
  uint4* v = reinterpret_cast<uint4*>(p);
  for (int k = threadIdx.x; k < words / 4; k += blockDim.x) v[k] = make_uint4(0u, 0u, 0u, 0u);
}

// Store the tile's `len` bins at out_tile; float4 stores when `vec` (S and
// the tile's start are multiples of 4, so out_tile is 16-byte aligned).
__device__ __forceinline__ void block_store_bins(const uint32_t* hist, float* out_tile, int len,
                                                 bool vec) {
  if (vec) {
    const uint4* h = reinterpret_cast<const uint4*>(hist);
    float4* o = reinterpret_cast<float4*>(out_tile);
    for (int k = threadIdx.x; k < len / 4; k += blockDim.x) {
      const uint4 c = h[k];
      o[k] = make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                         static_cast<float>(c.z), static_cast<float>(c.w));
    }
  } else {
    for (int s = threadIdx.x; s < len; s += blockDim.x) out_tile[s] = static_cast<float>(hist[s]);
  }
}

// Block b counts row b / tiles into tile b % tiles (bins [t0, t0 + len)).
__global__ void __launch_bounds__(kWideThreads)
contingency_counts_wide_kernel(const uint32_t* __restrict__ w, const int32_t* __restrict__ seg,
                               float* __restrict__ out, int U, int S, int tile, int tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t row = static_cast<int64_t>(blockIdx.x) / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * tile;
  const int len = min(tile, S - t0);
  block_zero(smem, round_up4(len));
  __syncthreads();
  const int32_t* seg_row = seg + row * static_cast<int64_t>(U);
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    tile_add(smem, __ldg(seg_row + u), t0, len, __ldg(w + u));
  }
  __syncthreads();
  block_store_bins(smem, out + row * static_cast<int64_t>(S) + t0, len, (S & 3) == 0);
}

// strides_t, codes_cm: as contingency_counts_fused_kernel.  Shared memory:
// round_up4(tile) bins, then the row's parent list (n int2).
template <typename Code>
__global__ void __launch_bounds__(kWideThreads)
contingency_counts_fused_wide_kernel(const float* __restrict__ strides_t,
                                     const Code* __restrict__ codes_cm,
                                     const uint32_t* __restrict__ w, float* __restrict__ out,
                                     int n, int U, int ldc, int q_cap, int r_max, int tile,
                                     int tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int num_parents;
  uint32_t* hist = smem;
  int2* parents = reinterpret_cast<int2*>(smem + round_up4(tile));
  const int64_t row = static_cast<int64_t>(blockIdx.x) / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * tile;
  const int S = q_cap * r_max;
  const int len = min(tile, S - t0);

  // warp 0 compacts the row's parents (offset, stride saturated at q_cap)
  if (threadIdx.x < kWarp) {
    const int lane = threadIdx.x;
    const float* srow = strides_t + row * n;
    int count = 0;
    for (int base = 0; base < n; base += kWarp) {
      const int m = base + lane;
      const float s = m < n ? srow[m] : 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, s > 0.0f);
      if (s > 0.0f) {
        const int sat = s >= static_cast<float>(q_cap) ? q_cap : static_cast<int>(s);
        parents[count + __popc(mask & ((1u << lane) - 1u))] = make_int2(m * ldc, sat);
      }
      count += __popc(mask);
    }
    if (lane == 0) num_parents = count;
  }
  block_zero(hist, round_up4(len));
  __syncthreads();

  const int np = num_parents;
  const Code* child_col = codes_cm + static_cast<int64_t>(row % n) * ldc;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    int cfg = 0;  // below n * S < 2^31: every term is below S
    for (int p = 0; p < np; ++p) {
      const int2 par = parents[p];
      cfg += par.y * static_cast<int>(__ldg(codes_cm + par.x + u));
    }
    const int cell = min(cfg, q_cap - 1) * r_max + static_cast<int>(__ldg(child_col + u));
    tile_add(hist, cell, t0, len, __ldg(w + u));
  }
  __syncthreads();
  block_store_bins(hist, out + row * static_cast<int64_t>(S) + t0, len, (S & 3) == 0);
}

// Tiles of at most kWideTileBins bins, as even as multiples of 4 allow; every
// tile starts below S.
void wide_tiles(int S, int* tile, int* tiles) {
  const int64_t even = (static_cast<int64_t>(S) + kWideTileBins - 1) / kWideTileBins;
  *tile = round_up4(static_cast<int>((S + even - 1) / even));
  *tiles = static_cast<int>((static_cast<int64_t>(S) + *tile - 1) / *tile);
}

// One block per (row, tile); 0 blocks if that count leaves the grid's range.
int64_t wide_blocks(int64_t R, int tiles) {
  const int64_t blocks = R * tiles;
  return blocks < 0x7fffffff ? blocks : 0;
}

// Warps per block for a per-warp shared-memory need; 0 if one warp does not fit.
int warps_for(int per_warp_bytes) {
  const int warps = kMaxSharedBytes / per_warp_bytes;
  return warps < kMaxWarps ? warps : kMaxWarps;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Code>
int launch_fused(const void* strides_t, const void* codes_cm, const void* w, void* out,
                 int64_t R, int n, int U, int ldc, int q_cap, int r_max, int small_span,
                 cudaStream_t stream) {
  const int S = q_cap * r_max;
  const int lane_minor_words = kWarp * (small_span < S ? small_span : S);
  const int region_words = round_up4(S > lane_minor_words ? S : lane_minor_words);
  const int warps = warps_for(region_words * 4 + n * static_cast<int>(sizeof(int2)));
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warps) * (region_words * 4 + n * sizeof(int2));
  cudaError_t err = allow_shared(contingency_counts_fused_kernel<Code>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (R + warps - 1) / warps;
  contingency_counts_fused_kernel<Code><<<static_cast<unsigned>(blocks), warps * kWarp, smem,
                                          stream>>>(
      static_cast<const float*>(strides_t), static_cast<const Code*>(codes_cm),
      static_cast<const uint32_t*>(w), static_cast<float*>(out), R, n, U, ldc, q_cap, r_max,
      region_words, small_span);
  return static_cast<int>(cudaGetLastError());
}

template <typename Code>
int launch_fused_wide(const void* strides_t, const void* codes_cm, const void* w, void* out,
                      int64_t R, int n, int U, int ldc, int q_cap, int r_max,
                      cudaStream_t stream) {
  int tile, tiles;
  wide_tiles(q_cap * r_max, &tile, &tiles);
  const int64_t blocks = wide_blocks(R, tiles);
  const size_t smem = static_cast<size_t>(round_up4(tile)) * 4 + n * sizeof(int2);
  if (blocks == 0 || smem > static_cast<size_t>(kMaxSharedBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_shared(contingency_counts_fused_wide_kernel<Code>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  contingency_counts_fused_wide_kernel<Code><<<static_cast<unsigned>(blocks), kWideThreads, smem,
                                               stream>>>(
      static_cast<const float*>(strides_t), static_cast<const Code*>(codes_cm),
      static_cast<const uint32_t*>(w), static_cast<float*>(out), n, U, ldc, q_cap, r_max, tile,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interfaces for ctypes.  All tensors contiguous on the current device;
// stream is a cudaStream_t.  Each returns the cudaError_t of the launch (0 on
// success).  Weights are the multiplicities as uint32, their total below
// 2^24.  The Python wrappers check shapes and sizes before calling.

// w: uint32[U], seg: int32[R, U], out: f32[R, S].  Needs 0 < R and S * 4 bytes
// of shared memory per warp (at most 232448).
extern "C" int contingency_counts_launch(const void* w, const void* seg, void* out, int64_t R,
                                         int U, int S, void* stream) {
  const int region_words = round_up4(S);
  const int warps = warps_for(region_words * 4);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warps) * region_words * 4;
  cudaError_t err = allow_shared(contingency_counts_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (R + warps - 1) / warps;
  contingency_counts_kernel<<<static_cast<unsigned>(blocks), warps * kWarp, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const int32_t*>(seg),
      static_cast<float*>(out), R, U, S, region_words);
  return static_cast<int>(cudaGetLastError());
}

// strides_t: f32[R, n] (R = B*n, row b*n + i holds stride[b, :, i]),
// codes_cm: uint8 (code_bytes 1) or int32 (code_bytes 4) [n, ldc] with
// ldc % 4 == 0 and ldc >= U, zero-padded, 16-byte aligned; w: uint32[U];
// out: f32[R, q_cap*r_max].
// Rows whose cells all lie below small_span take lane-private bins.
extern "C" int contingency_counts_fused_launch(const void* strides_t, const void* codes_cm,
                                               int code_bytes, const void* w, void* out,
                                               int64_t R, int n, int U, int ldc, int q_cap,
                                               int r_max, int small_span, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1) {
    return launch_fused<uint8_t>(strides_t, codes_cm, w, out, R, n, U, ldc, q_cap, r_max,
                                 small_span, s);
  }
  if (code_bytes == 4) {
    return launch_fused<int32_t>(strides_t, codes_cm, w, out, R, n, U, ldc, q_cap, r_max,
                                 small_span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide route of the seg entry: the contract of contingency_counts_launch
// for any S in [1, 2^31); R * ceil(S / 16384) blocks must stay below 2^31.
extern "C" int contingency_counts_wide_launch(const void* w, const void* seg, void* out, int64_t R,
                                              int U, int S, void* stream) {
  int tile, tiles;
  wide_tiles(S, &tile, &tiles);
  const int64_t blocks = wide_blocks(R, tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(round_up4(tile)) * 4;
  cudaError_t err = allow_shared(contingency_counts_wide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  contingency_counts_wide_kernel<<<static_cast<unsigned>(blocks), kWideThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const int32_t*>(seg),
      static_cast<float*>(out), U, S, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The wide route of the fused entry: the contract of
// contingency_counts_fused_launch (small_span aside) for any S = q_cap*r_max.
extern "C" int contingency_counts_fused_wide_launch(const void* strides_t, const void* codes_cm,
                                                    int code_bytes, const void* w, void* out,
                                                    int64_t R, int n, int U, int ldc, int q_cap,
                                                    int r_max, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1) {
    return launch_fused_wide<uint8_t>(strides_t, codes_cm, w, out, R, n, U, ldc, q_cap, r_max, s);
  }
  if (code_bytes == 4) {
    return launch_fused_wide<int32_t>(strides_t, codes_cm, w, out, R, n, U, ldc, q_cap, r_max, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
