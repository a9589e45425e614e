// Contingency-count kernels for batched BIC scoring, CUDA C++ for sm_90a.
//
// Replaces: dags_vae_search_tpu/ops/bic_pallas.py::_counts_kernel, the TPU
// kernel launched by contingency_counts_pallas, together with the
// configuration product that feeds it there (bic_pallas.py:108-121) or in
// the family scorer (dags_vae_search_tpu/scoring/family_batch.py:129-159,
// whose counts XLA's segment_sum takes under the same contract,
// bic_pallas.py:46-83).  For every row r the entries compute the weighted
// histogram
//
//     out[r, s] = sum_u w[u] * [cell(r, u) == s],   s in [0, S = q_cap * r_max)
//
// over the U unique dataset rows, with w[u] the row's multiplicity and
//
//     cell(r, u) = min(cfg, q_cap - 1) * r_max + codes[u, child(r)],
//     cfg        = sum_p stride(r, p) * codes[u, parent(r, p)].
//
// - The fused entry: row r = (candidate b, node i), child i, the parents and
//   strides read from the strides stride[b, m, i] (bic_pallas.py:108-121).
// - The family entry: row r = family f, child children[f], parents the
//   filled slots of parents[f, :] (padded with -1 anywhere), the stride of
//   slot p the product of the cards of the filled slots before it.
// - The seg entry (contingency_counts_kernel) takes the cell table ready-made:
//   the one-to-one counterpart of the Pallas kernel's contract.
// The fused and family entries compute cell themselves from the column-major
// codes, so the [R, U] cell table is never written; they share one counting
// core and differ only in how a row's parent list is built.  Cells outside
// the row's range (padding sentinels) are skipped.
//
// Bound.  The fused entry reads the strides (B*n*n f32), the codes (n*U
// bytes, L2-resident) and w, and writes R*S f32 counts: at the alarm search
// shape about 167 MB, 0.05 ms at 3.35 TB/s.  Its integer work, about
// U * (parents + 2) operations per row, is the larger bound there.  The
// family entry reads F*(P+1) int32 of families and writes F*S f32 counts;
// its integer work is F*U*(P+2): the work bounds it at binary widths (S =
// 512), the counts it writes at S >= 12,288.  The seg entry reads R*U int32
// cells and is bound by those bytes.
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
// - A row's parents are compacted into a list (offset, stride), each stride
//   saturated at q_cap.  Every term is non-negative and a saturated term with
//   a nonzero code already gives cfg >= q_cap, so min(cfg, q_cap - 1) equals
//   the clip of the exact product: int32 math gives the plain path's cells
//   exactly, with no float product to keep out of TF32.  For a family the
//   strides are a saturating product scan over the warp's lanes (lane p holds
//   slot p; saturation commutes with the product of factors >= 0, so any
//   grouping of the scan gives min(product, q_cap)).  The plain version's
//   float32 cumprod and float32 sum (family_batch.py) give the same clipped
//   cells: below q_cap every product and sum is an integer under 2^24, exact
//   in float32, and at or above it the float value stays above q_cap - 1
//   while q_cap * P < 2^23 and the product of a family's cards is finite in
//   float32 (below 2^128).
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
// The family entry's narrow kernel.  The delta climbs send it mostly small
// calls: a refresh is the n - 1 families of one child (36 at alarm, 723 at
// link), where one warp a family leaves most of the card idle and each warp
// walks all U rows alone.  So a family's U rows are split over a thread-block
// cluster of c blocks (c in {1, 2, 4, 8}, picked on the host from F, U and
// the occupancy: ops/bic_kernel.py::family_cluster_size).  Each block's eight
// warps scan its share of the rows into the block's bins; the cluster then
// merges its c partial histograms through distributed shared memory, each
// block summing and storing 1/c of the row's S bins, so every count is
// written once, with no global atomics and no second pass.  A family of at
// most private_span cells (16 on the path: binary data, up to 3 parents)
// counts in lane-private bins, the others in the block's shared atomics:
// wider lane-private bins cost more in blocks per SM than they save in
// collisions.  The bins are zeroed while warp 0 reads the family; four
// multiplicities come in one 16-byte load beside the codes' one load.
//
// Wide rows.  Each entry has a wide kernel with the same contract, which
// ops/bic_kernel.py::route picks past the crossover measured on the H100
// (rows of more than 2,048 bins for the fused entry, 4,096 for the family
// entry and 512 for the seg entry; always past the bins one block can hold).
// The narrow kernel loses there because a warp zeroes, scans and stores a
// whole row alone while few warps fit an SM.  The wide kernels tile S
// over blocks: a block owns one (row, tile) pair, all of its warps scan the
// row's U cells and add those that fall in the tile to one shared histogram
// (shared integer atomics, as above), then the block stores the tile.  The
// fused and family wide kernels recompute the row's configurations for
// every tile; that integer work is small beside the output they write,
// R*S*4 bytes, which bounds this route.
//
// The score entry (node_scores_fused_*).  The fused entry's counts exist to
// be reduced to node scores (bic_pallas.py:179 hands them to
// bic_xla.node_scores_from_counts), and writing R*S counts for that
// reduction to read back costs more than counting them.  The score entry
// counts a (candidate, node) row exactly as the fused entry does, then,
// still on chip, reduces the row's bins to its node score and writes one
// float a row: for the likelihood metrics sum c * log(c / n_j) over the
// cells with c > 0 (the ratio form of ops/bic_torch.py, accurate in
// float32), then the penalty from q and the child's cardinality; for BDeu
// lgamma over the cells and configurations that hold a count (every other
// term of the plain version is exactly 0).  The narrow kernel does it in
// the warp that owns the row, after its count (a policy in place of the
// store: StoreCounts / ReduceScore).  The wide kernel tiles a row at whole
// configurations (a multiple of r_max bins, since r_max need not divide a
// power of two), skips the tiles past the row's reach (they hold no
// count), reduces each tile in its block, and writes R x tiles partials
// that a second small kernel sums in tile order.  (Holding a row's tiles
// in one thread-block cluster and summing them from distributed shared
// memory gave the same floats 2.9x slower on the H100 at S = 65,536:
// PERF.md.)  Every sum is over a fixed order, so two launches give
// bit-equal scores.
// Bound: the inputs read once and R floats written, or the integer work of
// the count, whichever is larger; far below the count entry's R*S*4 bytes
// at S >= 12,288.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
// Most dynamic shared memory one block can take on Hopper (227 KB).
constexpr int kMaxSharedBytes = 232448;
// The wide kernels: threads per block and the most bins of one tile (64 KB,
// so three blocks share an SM).  ops/bic_kernel.py mirrors kWideTileBins.
constexpr int kWideThreads = 512;
constexpr int kWideTileBins = 16384;

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

// ---- the histogram core, shared by every entry -----------------------------

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

// ---- rows that compute their own cells: the fused and the family entry ----

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

// Geometry shared by both row kinds: codes_cm is Code[n, ldc], column m of
// the unique rows, zero beyond U.
struct Layout {
  int U, ldc, q_cap, r_max;
};

// The fused entry's rows: row r = b*n + i of strides_t f32[R, n], which holds
// stride[b, m, i] at m; child i; a parent list of up to n entries.
struct StrideRows {
  const float* strides_t;
  int n;

  __host__ __device__ int list_len() const { return n; }
  __device__ __forceinline__ int child(int64_t row) const { return static_cast<int>(row % n); }

  // Called by all 32 lanes of one warp: the row's parent list (element offset
  // of the parent's column, stride saturated at q_cap) in `parents`; returns
  // its length and gives every lane `reach`, a bound on the row's cfg.
  __device__ __forceinline__ int parent_list(int64_t row, const Layout& g, int2* parents,
                                             int lane, int* reach) const {
    const float* srow = strides_t + row * n;
    int count = 0, r = 0;
    for (int base = 0; base < n; base += kWarp) {
      const int m = base + lane;
      const float s = m < n ? srow[m] : 0.0f;
      const bool is_parent = s > 0.0f;
      const unsigned mask = __ballot_sync(kFull, is_parent);
      if (is_parent) {
        // s * (r_max - 1) < q_cap * r_max = S, so no product here overflows
        const int sat = s >= static_cast<float>(g.q_cap) ? g.q_cap : static_cast<int>(s);
        parents[count + __popc(mask & ((1u << lane) - 1u))] = make_int2(m * g.ldc, sat);
        r = min(r + sat * (g.r_max - 1), g.q_cap);
      }
      count += __popc(mask);
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) r += __shfl_xor_sync(kFull, r, off);
    *reach = r;
    return count;
  }
};

// The family entry's rows: family f, child children[f], parent slots
// slots[f, 0:P] (P <= 32; -1, or any negative, is an empty slot) of
// variables with cards[m] levels.
struct FamilyRows {
  const int32_t* children;
  const int32_t* slots;
  const int32_t* cards;
  int P;

  __host__ __device__ int list_len() const { return P; }
  __device__ __forceinline__ int child(int64_t row) const { return __ldg(children + row); }

  // As StrideRows::parent_list.  Lane p holds slot p; the stride of a filled
  // slot is the product of the cards of the filled slots before it, as a
  // saturating inclusive scan over the lanes shifted by one.
  __device__ __forceinline__ int parent_list(int64_t row, const Layout& g, int2* parents,
                                             int lane, int* reach) const {
    const int m = lane < P ? __ldg(slots + row * P + lane) : -1;
    const bool filled = m >= 0;
    int prod = filled ? min(__ldg(cards + m), g.q_cap) : 1;
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) {
      const int up = __shfl_up_sync(kFull, prod, off);
      if (lane >= off) {
        prod = static_cast<int>(min(static_cast<long long>(prod) * up,
                                    static_cast<long long>(g.q_cap)));
      }
    }
    int stride = __shfl_up_sync(kFull, prod, 1);
    if (lane == 0) stride = 1;
    const unsigned mask = __ballot_sync(kFull, filled);
    if (filled) parents[__popc(mask & ((1u << lane) - 1u))] = make_int2(m * g.ldc, stride);
    // stride <= q_cap, so each term is below S and the sum below P * S < 2^31
    int r = filled ? stride * (g.r_max - 1) : 0;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) r += __shfl_xor_sync(kFull, r, off);
    *reach = r;
    return __popc(mask);
  }
};

// Count one row: parents[p] = (element offset of parent column p, saturated
// stride); cells at or above `bound` are skipped.
template <bool kLaneMinor, typename Code>
__device__ __forceinline__ void count_row(const int2* parents, int num_parents,
                                          const Code* codes_cm, const Code* child_col,
                                          const uint32_t* w, const Layout& g, uint32_t* hist,
                                          int bound, int lane) {
  for (int u0 = 4 * lane; u0 < g.U; u0 += 4 * kWarp) {
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
      if (u0 + j < g.U) {
        const int cell = min(cfg[j], g.q_cap - 1) * g.r_max + child[j];
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

// ---- the score epilogue ---------------------------------------------------

// Metrics, numbered as ops/bic_kernel.py::SCORE_METRICS numbers them.
constexpr int kBic = 0, kAic = 1, kLoglik = 2, kBde = 3;

// What the score epilogue reads beside the counts, and where it writes.
struct ScoreArgs {
  const float* q;        // f32[R]: the row's configuration-space size
  const int32_t* cards;  // int32[n]: cardinality of each variable
  float* out;            // f32[R]: node scores
  int metric;
  float half_log_n;  // log(N) / 2: BIC's penalty per parameter
  float iss;         // BDeu's imaginary sample size
};

// Sum over the warp's lanes; every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// BDeu's priors of one row: a_jk = iss / (q * card), a_j = iss / q.
struct RowPrior {
  float a_jk, a_j;
};

__device__ __forceinline__ RowPrior row_prior(const ScoreArgs& sa, int64_t row, int child) {
  const float q = __ldg(sa.q + row);
  const float card = static_cast<float>(__ldg(sa.cards + child));
  return RowPrior{__fdiv_rn(sa.iss, __fmul_rn(q, card)), __fdiv_rn(sa.iss, q)};
}

// The score terms of configurations j = first, first + step, ... below
// `configs`, whose r_max bins are bins[j * r_max + k]: c * log(c / n_j) over
// the cells with c > 0, or for BDeu lgamma(a_jk + c) - lgamma(a_jk) over
// them and lgamma(a_j) - lgamma(a_j + n_j) over the configurations with
// n_j > 0.  Counts below 2^24 convert to float exactly.
template <bool kBdeu>
__device__ __forceinline__ float score_terms(const uint32_t* bins, int configs, int first,
                                             int step, int r_max, RowPrior prior) {
  float acc = 0.0f;
  for (int j = first; j < configs; j += step) {
    const uint32_t* b = bins + j * r_max;
    uint32_t total = 0u;
    for (int k = 0; k < r_max; ++k) total += b[k];
    if (total == 0u) continue;
    const float n_j = static_cast<float>(total);
    for (int k = 0; k < r_max; ++k) {
      const uint32_t c = b[k];
      if (c == 0u) continue;
      const float cf = static_cast<float>(c);
      if (kBdeu) {
        acc += lgammaf(prior.a_jk + cf) - lgammaf(prior.a_jk);
      } else {
        acc += __fmul_rn(cf, logf(__fdiv_rn(cf, n_j)));
      }
    }
    if (kBdeu) acc += lgammaf(prior.a_j) - lgammaf(prior.a_j + n_j);
  }
  return acc;
}

// A row's node score from the sum of its terms: BIC ll - (card - 1) q
// log(N) / 2, AIC ll - (card - 1) q, the log-likelihood and BDeu the sum.
__device__ __forceinline__ float finish_score(const ScoreArgs& sa, int64_t row, int child,
                                              float sum) {
  if (sa.metric == kLoglik || sa.metric == kBde) return sum;
  const float card = static_cast<float>(__ldg(sa.cards + child));
  const float df = __fmul_rn(card - 1.0f, __ldg(sa.q + row));
  return __fsub_rn(sum, sa.metric == kAic ? df : __fmul_rn(df, sa.half_log_n));
}

// The end of a row in the narrow kernel, after its count: store the S bins
// (the count entries) ...
struct StoreCounts {
  float* out;  // f32[R, S]

  __device__ __forceinline__ void lane_minor(uint32_t* priv, int span, int64_t row, int child,
                                             const Layout& g, int lane) const {
    const int S = g.q_cap * g.r_max;
    warp_store_lane_minor(priv, span, out + row * static_cast<int64_t>(S), S, lane);
  }
  __device__ __forceinline__ void bins(uint32_t* hist, int span, int64_t row, int child,
                                       const Layout& g, int lane) const {
    const int S = g.q_cap * g.r_max;
    warp_store_bins(hist, out + row * static_cast<int64_t>(S), S, lane);
  }
};

// ... or reduce them to the row's node score (the score entry).  Every
// cell of the row lies below span, a multiple of r_max.
template <bool kBdeu>
struct ReduceScore {
  ScoreArgs sa;

  __device__ __forceinline__ void bins(uint32_t* hist, int span, int64_t row, int child,
                                       const Layout& g, int lane) const {
    const RowPrior prior = kBdeu ? row_prior(sa, row, child) : RowPrior{0.0f, 0.0f};
    const float sum =
        warp_sum(score_terms<kBdeu>(hist, span / g.r_max, lane, kWarp, g.r_max, prior));
    if (lane == 0) sa.out[row] = finish_score(sa, row, child, sum);
  }
  // Lane-private bins (span <= 32): lane s folds the 32 copies of bin s,
  // and the totals take the first span words once every copy is read.
  __device__ __forceinline__ void lane_minor(uint32_t* priv, int span, int64_t row, int child,
                                             const Layout& g, int lane) const {
    const uint32_t total = lane_minor_sum(priv, lane, span, lane);
    __syncwarp();
    if (lane < span) priv[lane] = total;
    __syncwarp();
    bins(priv, span, row, child, g, lane);
  }
};

// The narrow route: one warp a row, its histogram in the warp's region of
// shared memory (region_words words), then its parent list (list_len int2);
// the epilogue `epi` ends the row.  At most 40 registers, so 6 blocks of 8
// warps fit an SM (64 registers held the fused kernel to 4 and cost more
// time than the spill-free cap does).
template <typename Rows, typename Code, typename Epi>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 6)
contingency_counts_rows_kernel(Rows rows, const Code* __restrict__ codes_cm,
                               const uint32_t* __restrict__ w, Epi epi, int64_t R, Layout g,
                               int region_words, int small_span) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (row >= R) return;  // whole warps leave; no block barrier follows
  uint32_t* hist = smem + warp * region_words;
  int2* parents = reinterpret_cast<int2*>(smem + warps * region_words) + warp * rows.list_len();

  int reach;
  const int num_parents = rows.parent_list(row, g, parents, lane, &reach);
  // every cell of this row lies below span
  const int span = (min(reach, g.q_cap - 1) + 1) * g.r_max;
  const int S = g.q_cap * g.r_max;
  const int child = rows.child(row);
  const Code* child_col = codes_cm + static_cast<int64_t>(child) * g.ldc;

  if (span <= small_span) {
    warp_zero(hist, span * kWarp, lane);
    __syncwarp();
    count_row<true>(parents, num_parents, codes_cm, child_col, w, g, hist, span, lane);
    __syncwarp();
    epi.lane_minor(hist, span, row, child, g, lane);
  } else {
    warp_zero(hist, round_up4(S), lane);
    __syncwarp();
    count_row<false>(parents, num_parents, codes_cm, child_col, w, g, hist, S, lane);
    __syncwarp();
    epi.bins(hist, span, row, child, g, lane);
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

// The wide route of rows that compute their own cells.  Shared memory:
// round_up4(tile) bins, then the row's parent list (list_len int2), built
// by warp 0.
template <typename Rows, typename Code>
__global__ void __launch_bounds__(kWideThreads)
contingency_counts_rows_wide_kernel(Rows rows, const Code* __restrict__ codes_cm,
                                    const uint32_t* __restrict__ w, float* __restrict__ out,
                                    Layout g, int tile, int tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int num_parents;
  uint32_t* hist = smem;
  int2* parents = reinterpret_cast<int2*>(smem + round_up4(tile));
  const int64_t row = static_cast<int64_t>(blockIdx.x) / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * tile;
  const int S = g.q_cap * g.r_max;
  const int len = min(tile, S - t0);

  if (threadIdx.x < kWarp) {
    int reach;
    const int count = rows.parent_list(row, g, parents, threadIdx.x, &reach);
    if (threadIdx.x == 0) num_parents = count;
  }
  block_zero(hist, round_up4(len));
  __syncthreads();

  const int np = num_parents;
  const Code* child_col = codes_cm + static_cast<int64_t>(rows.child(row)) * g.ldc;
  for (int u = threadIdx.x; u < g.U; u += blockDim.x) {
    int cfg = 0;  // below list_len * S < 2^31: every term is below S
    for (int p = 0; p < np; ++p) {
      const int2 par = parents[p];
      cfg += par.y * static_cast<int>(__ldg(codes_cm + par.x + u));
    }
    const int cell = min(cfg, g.q_cap - 1) * g.r_max + static_cast<int>(__ldg(child_col + u));
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

// The score entry's tiles: whole configurations, at most kWideTileBins bins
// (at least one configuration), as even as whole configurations allow;
// every tile starts below q_cap.  ops/bic_kernel.py::score_tiles mirrors it.
void score_tiles(int q_cap, int r_max, int* configs, int* tiles) {
  const int most = kWideTileBins / r_max > 1 ? kWideTileBins / r_max : 1;
  *tiles = (q_cap + most - 1) / most;
  *configs = (q_cap + *tiles - 1) / *tiles;
}

// The score entry's wide route: block b counts row b / tiles into the bins
// of its tile t = b % tiles (configurations [t * configs, ...), whole), sums
// the tile's score terms over the block (each warp's, then the warps' in
// order), and writes the score when the row has one tile, else its sum to
// partials[row * tiles + t] for node_scores_finish_kernel.  A tile past the
// row's reach holds no count: it adds 0 without a scan.  Shared memory:
// round_up4(configs * r_max) bins, then the parent list.
template <typename Code, bool kBdeu>
__global__ void __launch_bounds__(kWideThreads)
node_scores_wide_kernel(StrideRows rows, const Code* __restrict__ codes_cm,
                        const uint32_t* __restrict__ w, ScoreArgs sa,
                        float* __restrict__ partials, Layout g, int configs, int tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int num_parents, row_reach;
  __shared__ float warp_part[kWideThreads / kWarp];
  uint32_t* hist = smem;
  int2* parents = reinterpret_cast<int2*>(smem + round_up4(configs * g.r_max));
  const int64_t row = static_cast<int64_t>(blockIdx.x) / tiles;
  const int t = static_cast<int>(blockIdx.x % tiles);
  const int j0 = t * configs;
  const int held = min(configs, g.q_cap - j0);
  const int child = rows.child(row);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  if (warp == 0) {
    int reach;
    const int count = rows.parent_list(row, g, parents, lane, &reach);
    if (lane == 0) {
      num_parents = count;
      row_reach = reach;
    }
  }
  block_zero(hist, round_up4(held * g.r_max));
  __syncthreads();

  // the configurations of this tile that can hold a count (uniform)
  const int live = min(held, min(row_reach, g.q_cap - 1) + 1 - j0);
  float x = 0.0f;
  if (live > 0) {
    const int t0 = j0 * g.r_max, len = live * g.r_max, np = num_parents;
    const Code* child_col = codes_cm + static_cast<int64_t>(child) * g.ldc;
    for (int u = threadIdx.x; u < g.U; u += blockDim.x) {
      int cfg = 0;  // below list_len * S < 2^31: every term is below S
      for (int p = 0; p < np; ++p) {
        const int2 par = parents[p];
        cfg += par.y * static_cast<int>(__ldg(codes_cm + par.x + u));
      }
      const int cell = min(cfg, g.q_cap - 1) * g.r_max + static_cast<int>(__ldg(child_col + u));
      tile_add(hist, cell, t0, len, __ldg(w + u));
    }
    __syncthreads();
    const RowPrior prior = kBdeu ? row_prior(sa, row, child) : RowPrior{0.0f, 0.0f};
    x = score_terms<kBdeu>(hist, live, threadIdx.x, blockDim.x, g.r_max, prior);
  }
  x = warp_sum(x);
  if (lane == 0) warp_part[warp] = x;
  __syncthreads();
  if (warp == 0) x = warp_sum(lane < kWideThreads / kWarp ? warp_part[lane] : 0.0f);

  if (threadIdx.x == 0) {
    if (tiles == 1) {
      sa.out[row] = finish_score(sa, row, child, x);
    } else {
      partials[row * tiles + t] = x;
    }
  }
}

// The partials' second pass: row r's tiles summed in tile order, then the
// metric's penalty.  One thread a row.
__global__ void node_scores_finish_kernel(const float* __restrict__ partials, ScoreArgs sa,
                                          int64_t R, int n, int tiles) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float sum = 0.0f;
  for (int t = 0; t < tiles; ++t) sum += partials[row * tiles + t];
  sa.out[row] = finish_score(sa, row, static_cast<int>(row % n), sum);
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

template <typename Rows, typename Code, typename Epi>
int launch_rows(const Rows& rows, const void* codes_cm, const void* w, const Epi& epi, int64_t R,
                const Layout& g, int small_span, cudaStream_t stream) {
  const int S = g.q_cap * g.r_max;
  const int lane_minor_words = kWarp * (small_span < S ? small_span : S);
  const int region_words = round_up4(S > lane_minor_words ? S : lane_minor_words);
  const int list_bytes = rows.list_len() * static_cast<int>(sizeof(int2));
  const int warps = warps_for(region_words * 4 + list_bytes);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warps) * (region_words * 4 + list_bytes);
  cudaError_t err = allow_shared(contingency_counts_rows_kernel<Rows, Code, Epi>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (R + warps - 1) / warps;
  contingency_counts_rows_kernel<Rows, Code, Epi><<<static_cast<unsigned>(blocks), warps * kWarp,
                                                    smem, stream>>>(
      rows, static_cast<const Code*>(codes_cm), static_cast<const uint32_t*>(w), epi, R, g,
      region_words, small_span);
  return static_cast<int>(cudaGetLastError());
}

template <typename Rows, typename Code>
int launch_rows_wide(const Rows& rows, const void* codes_cm, const void* w, void* out,
                     int64_t R, const Layout& g, cudaStream_t stream) {
  int tile, tiles;
  wide_tiles(g.q_cap * g.r_max, &tile, &tiles);
  const int64_t blocks = wide_blocks(R, tiles);
  const size_t smem = static_cast<size_t>(round_up4(tile)) * 4 + rows.list_len() * sizeof(int2);
  if (blocks == 0 || smem > static_cast<size_t>(kMaxSharedBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_shared(contingency_counts_rows_wide_kernel<Rows, Code>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  contingency_counts_rows_wide_kernel<Rows, Code><<<static_cast<unsigned>(blocks), kWideThreads,
                                                    smem, stream>>>(
      rows, static_cast<const Code*>(codes_cm), static_cast<const uint32_t*>(w),
      static_cast<float*>(out), g, tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Either route for uint8 (code_bytes 1) or int32 (code_bytes 4) codes;
// small_span < 0 asks for the wide route.
template <typename Rows>
int launch_any(const Rows& rows, const void* codes_cm, int code_bytes, const void* w, void* out,
               int64_t R, const Layout& g, int small_span, cudaStream_t stream) {
  const bool wide = small_span < 0;
  if (code_bytes == 1) {
    return wide ? launch_rows_wide<Rows, uint8_t>(rows, codes_cm, w, out, R, g, stream)
                : launch_rows<Rows, uint8_t>(rows, codes_cm, w,
                                             StoreCounts{static_cast<float*>(out)}, R, g,
                                             small_span, stream);
  }
  if (code_bytes == 4) {
    return wide ? launch_rows_wide<Rows, int32_t>(rows, codes_cm, w, out, R, g, stream)
                : launch_rows<Rows, int32_t>(rows, codes_cm, w,
                                             StoreCounts{static_cast<float*>(out)}, R, g,
                                             small_span, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The score entry on either route, for one code type and one metric kind;
// small_span < 0 asks for the wide route, whose tiles are summed from
// `partials` (f32[R * tiles], unused at one tile).
template <typename Code, bool kBdeu>
int launch_scores(const StrideRows& rows, const void* codes_cm, const void* w,
                  const ScoreArgs& sa, void* partials, int64_t R, const Layout& g, int small_span,
                  cudaStream_t stream) {
  if (small_span >= 0) {
    // the lane-private bins fold into one bin a lane
    if (small_span > kWarp) return static_cast<int>(cudaErrorInvalidValue);
    return launch_rows<StrideRows, Code, ReduceScore<kBdeu>>(rows, codes_cm, w,
                                                             ReduceScore<kBdeu>{sa}, R, g,
                                                             small_span, stream);
  }
  int configs, tiles;
  score_tiles(g.q_cap, g.r_max, &configs, &tiles);
  const int64_t blocks = wide_blocks(R, tiles);
  // dynamic bins and list, and the kernel's static words
  const size_t smem = static_cast<size_t>(round_up4(configs * g.r_max)) * 4 +
                      rows.list_len() * sizeof(int2);
  if (blocks == 0 || smem + 256 > static_cast<size_t>(kMaxSharedBytes) ||
      (tiles > 1 && partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* part = static_cast<float*>(partials);
  cudaError_t err = allow_shared(node_scores_wide_kernel<Code, kBdeu>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  node_scores_wide_kernel<Code, kBdeu><<<static_cast<unsigned>(blocks), kWideThreads, smem,
                                         stream>>>(rows, static_cast<const Code*>(codes_cm),
                                                   static_cast<const uint32_t*>(w), sa, part, g,
                                                   configs, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  constexpr int kFinishThreads = 256;
  node_scores_finish_kernel<<<static_cast<unsigned>((R + kFinishThreads - 1) / kFinishThreads),
                              kFinishThreads, 0, stream>>>(part, sa, R, rows.n, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---- the family entry's narrow route: one family over a cluster ----------

constexpr int kFamilyThreads = 256;
constexpr int kFamilyWarps = kFamilyThreads / kWarp;

// Four consecutive multiplicities from the 16-byte aligned w: one 16-byte
// load inside [0, U), scalar loads at the ragged end, zero past U.
__device__ __forceinline__ uint4 weights4(const uint32_t* w, int u0, int U) {
  if (u0 + 4 <= U) return __ldg(reinterpret_cast<const uint4*>(w + u0));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (u0 < U) v.x = __ldg(w + u0);
  if (u0 + 1 < U) v.y = __ldg(w + u0 + 1);
  if (u0 + 2 < U) v.z = __ldg(w + u0 + 2);
  return v;
}

// Shared memory of one block: round_up4(S) bins of the block's histogram,
// then kFamilyWarps lane-minor regions of private_span x 32 bins, then the
// family's parent list (P int2).
__host__ __device__ inline size_t family_cluster_smem(int S, int P, int private_span) {
  return 4 * (static_cast<size_t>(round_up4(S)) +
              static_cast<size_t>(kFamilyWarps) * private_span * kWarp) +
         sizeof(int2) * P;
}

// Cluster k counts family k.  Thread t of its block of rank b scans the
// groups of 4 rows b * kFamilyThreads + t + i * c * kFamilyThreads into the
// block's bins; then the block sums bins [b * share, (b + 1) * share) over
// the c blocks and stores them.
template <typename Code>
__global__ void __launch_bounds__(kFamilyThreads)
contingency_counts_family_cluster_kernel(FamilyRows rows, const Code* __restrict__ codes_cm,
                                         const uint32_t* __restrict__ w,
                                         float* __restrict__ out, Layout g, int private_span) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int list_len, row_span;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row = static_cast<int64_t>(blockIdx.x) / c;
  const int S = g.q_cap * g.r_max;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  uint32_t* hist = smem;
  uint32_t* priv = smem + round_up4(S);
  uint32_t* mine = priv + warp * private_span * kWarp;
  int2* parents = reinterpret_cast<int2*>(priv + kFamilyWarps * private_span * kWarp);

  // the bins are zeroed while warp 0 waits on the family's slots and cards
  block_zero(hist, round_up4(S));
  warp_zero(mine, private_span * kWarp, lane);
  if (warp == 0) {
    int reach;
    const int count = rows.parent_list(row, g, parents, lane, &reach);
    if (lane == 0) {
      list_len = count;
      row_span = (min(reach, g.q_cap - 1) + 1) * g.r_max;
    }
  }
  __syncthreads();
  // every cell of this family lies below span, the same in every block
  const int num_parents = list_len, span = row_span;
  const int span4 = round_up4(span);
  const bool lane_private = span <= private_span;  // uniform over the cluster

  const Code* child_col = codes_cm + static_cast<int64_t>(rows.child(row)) * g.ldc;
  const int step = 4 * c * kFamilyThreads;
  for (int u0 = 4 * (rank * kFamilyThreads + static_cast<int>(threadIdx.x)); u0 < g.U;
       u0 += step) {
    int cfg[4] = {0, 0, 0, 0};
#pragma unroll 2
    for (int p = 0; p < num_parents; ++p) {
      const int2 par = parents[p];
      const Codes4<Code> cd(codes_cm + par.x + u0);
#pragma unroll
      for (int j = 0; j < 4; ++j) cfg[j] += par.y * cd[j];
    }
    const Codes4<Code> child(child_col + u0);
    const uint4 wv = weights4(w, u0, g.U);
    const uint32_t wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cell = min(cfg[j], g.q_cap - 1) * g.r_max + child[j];
      // rows past U weigh 0 and add nothing
      if (static_cast<unsigned>(cell) < static_cast<unsigned>(span) && wj[j] != 0u) {
        if (lane_private) {
          mine[cell * kWarp + lane] += wj[j];
        } else {
          atomicAdd(&hist[cell], wj[j]);
        }
      }
    }
  }

  if (lane_private) {
    // the block's bins: warp v sums bins v, v + 8, ... over the 8 warps'
    // lanes, one lane-minor column per warp read, then across the lanes
    __syncthreads();
    for (int s = warp; s < span4; s += kFamilyWarps) {
      uint32_t x = 0u;
      if (s < span) {
#pragma unroll
        for (int v = 0; v < kFamilyWarps; ++v) x += priv[(v * private_span + s) * kWarp + lane];
      }
      x = __reduce_add_sync(kFull, x);
      if (lane == 0) hist[s] = x;
    }
  }
  // every block's bins [0, span4) are final and visible to the cluster (a
  // cluster of one block needs only the block's barrier)
  if (c == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }

  const int share = round_up4((S + c - 1) / c);
  const int lo = min(S, rank * share), hi = min(S, lo + share);
  float* out_row = out + row * static_cast<int64_t>(S);
  if ((S & 3) == 0) {
    float4* o = reinterpret_cast<float4*>(out_row);
    for (int k = lo / 4 + static_cast<int>(threadIdx.x); k < hi / 4; k += kFamilyThreads) {
      uint4 sum = make_uint4(0u, 0u, 0u, 0u);
      if (4 * k < span) {
        for (int r = 0; r < c; ++r) {
          const uint32_t* h = c == 1 ? hist : cluster.map_shared_rank(hist, r);
          const uint4 v = reinterpret_cast<const uint4*>(h)[k];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
      }
      o[k] = make_float4(static_cast<float>(sum.x), static_cast<float>(sum.y),
                         static_cast<float>(sum.z), static_cast<float>(sum.w));
    }
  } else {
    for (int s = lo + static_cast<int>(threadIdx.x); s < hi; s += kFamilyThreads) {
      uint32_t sum = 0u;
      if (s < span) {
        for (int r = 0; r < c; ++r) sum += (c == 1 ? hist : cluster.map_shared_rank(hist, r))[s];
      }
      out_row[s] = static_cast<float>(sum);
    }
  }
  // no block leaves while another still reads its bins
  if (c > 1) cluster.sync();
}

template <typename Code>
int launch_family_cluster(const FamilyRows& rows, const void* codes_cm, const void* w, void* out,
                          int64_t F, const Layout& g, int cluster, int private_span,
                          cudaStream_t stream) {
  const size_t smem = family_cluster_smem(g.q_cap * g.r_max, rows.P, private_span);
  const int64_t blocks = F * cluster;
  if (cluster < 1 || private_span < 0 || blocks >= 0x7fffffff ||
      smem > static_cast<size_t>(kMaxSharedBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(FamilyRows, const Code*, const uint32_t*, float*, Layout, int) =
      contingency_counts_family_cluster_kernel<Code>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kFamilyThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, rows, static_cast<const Code*>(codes_cm),
                           static_cast<const uint32_t*>(w), static_cast<float*>(out), g,
                           private_span);
  // read (and clear) the last error also after a refused launch, so that it
  // does not surface at the next one
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename Code>
int family_cluster_occupancy(int S, int P, int private_span, int* blocks) {
  const size_t smem = family_cluster_smem(S, P, private_span);
  if (smem > static_cast<size_t>(kMaxSharedBytes)) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(FamilyRows, const Code*, const uint32_t*, float*, Layout, int) =
      contingency_counts_family_cluster_kernel<Code>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kFamilyThreads, smem));
}

FamilyRows family_rows(const void* children, const void* parents, const void* cards, int P) {
  return FamilyRows{static_cast<const int32_t*>(children), static_cast<const int32_t*>(parents),
                    static_cast<const int32_t*>(cards), P};
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
  return launch_any(StrideRows{static_cast<const float*>(strides_t), n}, codes_cm, code_bytes, w,
                    out, R, Layout{U, ldc, q_cap, r_max}, small_span < 0 ? 0 : small_span,
                    static_cast<cudaStream_t>(stream));
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
  return launch_any(StrideRows{static_cast<const float*>(strides_t), n}, codes_cm, code_bytes, w,
                    out, R, Layout{U, ldc, q_cap, r_max}, -1, static_cast<cudaStream_t>(stream));
}

namespace {

// The score entry for either code type and metric; small_span < 0 asks for
// the wide route.
int launch_scores_any(const void* strides_t, const void* q, const void* cards,
                      const void* codes_cm, int code_bytes, const void* w, void* out,
                      void* partials, int64_t R, int n, int U, int ldc, int q_cap, int r_max,
                      int metric, float half_log_n, float iss, int small_span, void* stream) {
  if (metric < kBic || metric > kBde) return static_cast<int>(cudaErrorInvalidValue);
  const StrideRows rows{static_cast<const float*>(strides_t), n};
  const ScoreArgs sa{static_cast<const float*>(q), static_cast<const int32_t*>(cards),
                     static_cast<float*>(out), metric, half_log_n, iss};
  const Layout g{U, ldc, q_cap, r_max};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bde = metric == kBde;
  if (code_bytes == 1) {
    return bde ? launch_scores<uint8_t, true>(rows, codes_cm, w, sa, partials, R, g, small_span, s)
               : launch_scores<uint8_t, false>(rows, codes_cm, w, sa, partials, R, g, small_span, s);
  }
  if (code_bytes == 4) {
    return bde ? launch_scores<int32_t, true>(rows, codes_cm, w, sa, partials, R, g, small_span, s)
               : launch_scores<int32_t, false>(rows, codes_cm, w, sa, partials, R, g, small_span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The score entry's narrow route: the rows of contingency_counts_fused_launch
// (strides_t, codes_cm, w, R, n, U, ldc, q_cap, r_max as there), each reduced
// to its node score out[r] (f32[R]) instead of stored.  q: f32[R], row b*n +
// i's configuration-space size (the product of its parents' cards); cards:
// int32[n]; metric 0 BIC, 1 AIC, 2 log-likelihood, 3 BDeu; half_log_n =
// log(N) / 2; iss BDeu's imaginary sample size.  Rows whose cells all lie
// below small_span (at most 32) take lane-private bins.
extern "C" int node_scores_fused_launch(const void* strides_t, const void* q, const void* cards,
                                        const void* codes_cm, int code_bytes, const void* w,
                                        void* out, int64_t R, int n, int U, int ldc, int q_cap,
                                        int r_max, int metric, float half_log_n, float iss,
                                        int small_span, void* stream) {
  return launch_scores_any(strides_t, q, cards, codes_cm, code_bytes, w, out, nullptr, R, n, U,
                           ldc, q_cap, r_max, metric, half_log_n, iss,
                           small_span < 0 ? 0 : small_span, stream);
}

// The score entry's wide route: the contract of node_scores_fused_launch
// (small_span aside) for any q_cap and r_max whose tile (score_tiles) fits a
// block, with R * tiles blocks below 2^31.  With more than one tile a row's
// tile sums go through partials, f32[R * tiles] of scratch.
extern "C" int node_scores_fused_wide_launch(const void* strides_t, const void* q,
                                             const void* cards, const void* codes_cm,
                                             int code_bytes, const void* w, void* out,
                                             void* partials, int64_t R, int n, int U, int ldc,
                                             int q_cap, int r_max, int metric, float half_log_n,
                                             float iss, void* stream) {
  return launch_scores_any(strides_t, q, cards, codes_cm, code_bytes, w, out, partials, R, n, U,
                           ldc, q_cap, r_max, metric, half_log_n, iss, -1, stream);
}

// The family entry's narrow route.  children: int32[F] in [0, n); parents:
// int32[F, P], 1 <= P <= 32, each in [0, n) or negative (an empty slot);
// cards: int32[n]; codes_cm: as contingency_counts_fused_launch (n rows of
// codes); w: uint32[U], 16-byte aligned; out: f32[F, q_cap*r_max].  Needs
// P * q_cap * r_max < 2^31, n * ldc < 2^31, F * cluster < 2^31 and
// family_cluster_smem(S, P, private_span) <= 232448.  Each family is counted by
// a cluster of `cluster` blocks (a size the card refuses fails the launch);
// families whose cells all lie below private_span take lane-private bins.
extern "C" int contingency_counts_family_launch(const void* children, const void* parents,
                                                const void* cards, const void* codes_cm,
                                                int code_bytes, const void* w, void* out,
                                                int64_t F, int P, int U, int ldc, int q_cap,
                                                int r_max, int cluster, int private_span,
                                                void* stream) {
  if (P < 1 || P > kWarp) return static_cast<int>(cudaErrorInvalidValue);
  const FamilyRows rows = family_rows(children, parents, cards, P);
  const Layout g{U, ldc, q_cap, r_max};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1) {
    return launch_family_cluster<uint8_t>(rows, codes_cm, w, out, F, g, cluster, private_span, s);
  }
  if (code_bytes == 4) {
    return launch_family_cluster<int32_t>(rows, codes_cm, w, out, F, g, cluster, private_span, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the family narrow kernel that fit one SM at S bins, P slots and
// private_span, into *blocks (the card's occupancy calculator).
extern "C" int contingency_counts_family_blocks_per_sm(int code_bytes, int S, int P,
                                                       int private_span, int* blocks) {
  if (code_bytes == 1) return family_cluster_occupancy<uint8_t>(S, P, private_span, blocks);
  if (code_bytes == 4) return family_cluster_occupancy<int32_t>(S, P, private_span, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wide route of the family entry: its contract for any S = q_cap*r_max
// with F * ceil(S / 16384) blocks below 2^31.
extern "C" int contingency_counts_family_wide_launch(const void* children, const void* parents,
                                                     const void* cards, const void* codes_cm,
                                                     int code_bytes, const void* w, void* out,
                                                     int64_t F, int P, int U, int ldc, int q_cap,
                                                     int r_max, void* stream) {
  if (P < 1 || P > kWarp) return static_cast<int>(cudaErrorInvalidValue);
  const FamilyRows rows = family_rows(children, parents, cards, P);
  const Layout g{U, ldc, q_cap, r_max};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1) {
    return launch_rows_wide<FamilyRows, uint8_t>(rows, codes_cm, w, out, F, g, s);
  }
  if (code_bytes == 4) {
    return launch_rows_wide<FamilyRows, int32_t>(rows, codes_cm, w, out, F, g, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
