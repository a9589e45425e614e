// One query's attention over a sampling decode's key/value cache, CUDA C++
// for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for attention
// (dags_vae_search_tpu/models/transformer.py leaves it to XLA).  It exists
// because the port's cached decode (models/pace_vae.py::decode_step_cached)
// runs one query a (row, head) against at most a few hundred cached keys of
// 8 or 16 floats (the registry's heads), 8 times a position, and the library's route for that, a
// batched gemv for the logits, a softmax, a second batched gemv for the
// values and a materialised mask, moves the same bytes several times and
// runs far below the card's memory bandwidth.
//
// Function.  For every row b and head h, with L = the keys of the call and
// the query at position L - 1,
//
//     bias[l]  = (mask[b, l] - 1) * 1e30 for l < L - 1, 0 for l = L - 1
//     logit[l] = alpha * (q[b, h] . k[b, h, l]) + bias[l]
//     w        = round(softmax(logit))             (round: bfloat16, float16 or none)
//     out[b, h] = sum_l w[l] * v[b, h, l]
//
// as ops/decode_attention.py::decode_attention_plain computes it with
// torch.baddbmm, torch.softmax and a product: float32 throughout, the max,
// exp(logit - max), the sum, then the divide.
//
// Bound.  Bytes: the keys and values the call must read, q, the mask column
// and the output; no reuse, so the card's 3.35 TB/s bounds it.  A key whose
// mask is 0 is never read (below), so the bytes a call must read are those
// of the allowed keys: in the alarm island decode (32,768 rows x 8 heads,
// d_head 16, up to 39 keys) about an eighth of the 128 bytes a key that the
// library reads for every key.
//
// Design.  One (row, head) to a group of G lanes of one warp (G = 4 .. 32,
// chosen from L so that a lane holds at most P logits in registers; at G = 4
// a warp holds the 8 heads of one row, which read the same mask entries);
// lane i takes keys i, i + G, i + 2G, ... whole: a key costs one lane its
// loads and d_head multiply-adds, and no shuffle.  Each key and value is
// read once.
// - Pass 1: each lane reads its keys' mask entries, then the keys it may
//   attend (and asks L2 for their values), and keeps its logits in
//   registers; the group's max by shuffles.
// - exp(logit - max) in registers, the group's sum by shuffles; each weight
//   is divided by the sum and rounded.
// - Pass 2: the values of the weights that are not 0, read and added in;
//   the group's outputs are summed by shuffles and lane 0 writes them.
// The head size decides the kernel, from what the launch observes:
// - d_head 4, 8 or 16 with every row on a 16-byte boundary (the registry's
//   heads): decode_attention_kernel<D>, the query and a lane's sums in
//   registers, a key or a value in d_head / 4 16-byte loads issued together;
// - any other d_head: decode_attention_any_kernel, which walks a key's dot
//   product and a value's sum in chunks of 4 floats (16-byte loads: d_head a
//   multiple of 4 and the rows aligned) or 1 (any d_head, any alignment),
//   the query read from L1 with each key, so its registers do not grow with
//   d_head; pass 2 runs once a chunk of the output.
// Skipping a blocked key (mask 0, l < L - 1) gives the plain path's result
// exactly: its logit there is -1e30 + alpha * q.k, which rounds to -1e30
// while |alpha * q.k| < 2^75, and exp(-1e30 - max) is 0, since max is at
// least the query's own logit; a weight of exactly 0 adds nothing to the
// sum or, times a finite value, to the output.  A weight that is 0 after the
// exp or the rounding skips its value's read for the same reason.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr float kBlocked = 1e30f;
constexpr int kMaxLength = 1024;

struct Args {
  const float* q;     // [B, H * D], contiguous
  const float* k;     // key (b, h, l): k + b * k_b + h * k_h + l * k_l, D floats
  const float* v;     // value (b, h, l): v + b * v_b + h * v_h + l * v_l, D floats
  const float* mask;  // mask (b, l): mask + b * m_b + l * m_l, l < L - 1
  float* out;         // [B, H * D], contiguous
  int64_t k_b, k_h, k_l, v_b, v_h, v_l, m_b, m_l;
  int64_t pairs;  // B * H
  int H, L, D;
  float alpha;
  int round;  // 0 none, 1 bfloat16, 2 float16
};

// D floats from p: 16-byte loads for D a multiple of 4, else one at a time
template <int D>
__device__ __forceinline__ void load_row(const float* p, float (&x)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int e = 0; e < D; e += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + e));
      x[e] = t.x;
      x[e + 1] = t.y;
      x[e + 2] = t.z;
      x[e + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < D; ++e) x[e] = __ldg(p + e);
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* p, const float (&x)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int e = 0; e < D; e += 4) {
      reinterpret_cast<float4*>(p)[e / 4] = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < D; ++e) p[e] = x[e];
  }
}

// Where a (row, head) reads, and which lanes share it.
struct Pair {
  int64_t index;  // b * H + h
  int lane;
  unsigned group;  // the shuffle mask of the pair's lanes
  const float* k;
  const float* v;
  const float* mask;
};

template <int G>
__device__ __forceinline__ bool locate(const Args& a, Pair& p) {
  p.index = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  if (p.index >= a.pairs) return false;  // a group's lanes share their pair: they leave together
  p.lane = threadIdx.x % G;
  p.group = (0xffffffffu >> (32 - G)) << ((threadIdx.x % 32) / G * G);
  const int64_t b = p.index / a.H;
  const int64_t h = p.index - b * a.H;
  p.k = a.k + b * a.k_b + h * a.k_h;
  p.v = a.v + b * a.v_b + h * a.v_h;
  p.mask = a.mask + b * a.m_b;
  return true;
}

// The mask entries of a lane's keys, loaded together before any key: r = 1
// at the query's own key, 0 past the last.
template <int G, int P>
__device__ __forceinline__ void mask_entries(const Args& a, const Pair& p, float (&r)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int l = p.lane + i * G;
    r[i] = l < a.L - 1 ? __ldg(p.mask + l * a.m_l) : (l == a.L - 1 ? 1.f : 0.f);
  }
}

__device__ __forceinline__ float logit_of(const Args& a, float dot, float r) {
  return __fadd_rn(__fmul_rn(a.alpha, dot), (r - 1.f) * kBlocked);
}

// The logits (-inf for the keys not attended) become the rounded weights:
// the group's max, exp(logit - max), the group's sum, the divide.
template <int G, int P>
__device__ __forceinline__ void softmax_weights(const Args& a, unsigned group, float (&x)[P]) {
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < P; ++i) mx = fmaxf(mx, x[i]);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(group, mx, o, G));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    x[i] = expf(x[i] - mx);  // 0 for the keys not attended
    sum += x[i];
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(group, sum, o, G);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float w = x[i] / sum;
    if (a.round == 1) {
      w = __bfloat162float(__float2bfloat16_rn(w));
    } else if (a.round == 2) {
      w = __half2float(__float2half_rn(w));
    }
    x[i] = w;
  }
}

template <int G, int N>
__device__ __forceinline__ void group_sum(unsigned group, float (&acc)[N]) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] += __shfl_xor_sync(group, acc[e], o, G);
  }
}

// d_head D (4, 8 or 16), rows on 16-byte boundaries
template <int D, int G, int P>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Args a) {
  Pair p;
  if (!locate<G>(a, p)) return;
  float q[D];
  load_row<D>(a.q + p.index * D, q);
  float x[P];
  mask_entries<G, P>(a, p, x);
  // pass 1: the logits of the keys this lane attends
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float r = x[i];
    x[i] = -CUDART_INF_F;
    if (r != 0.f) {
      const int l = p.lane + i * G;
      float kr[D];
      load_row<D>(p.k + l * a.k_l, kr);
      // its value is read after the softmax: ask L2 for it now
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p.v + l * a.v_l));
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) dot = fmaf(q[e], kr[e], dot);
      x[i] = logit_of(a, dot, r);
    }
  }
  softmax_weights<G, P>(a, p.group, x);
  // pass 2: the values of the weights that are not 0
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (x[i] != 0.f) {
      float vr[D];
      load_row<D>(p.v + (p.lane + i * G) * a.v_l, vr);
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] = fmaf(x[i], vr[e], acc[e]);
    }
  }
  group_sum<G, D>(p.group, acc);
  if (p.lane == 0) store_row<D>(a.out + p.index * D, acc);
}

// any d_head a.D, in chunks of C floats (C = 4: a.D a multiple of 4 and
// rows on 16-byte boundaries; C = 1: any)
template <int C, int G, int P>
__global__ void __launch_bounds__(kThreads) decode_attention_any_kernel(const Args a) {
  Pair p;
  if (!locate<G>(a, p)) return;
  const float* q = a.q + p.index * a.D;
  float x[P];
  mask_entries<G, P>(a, p, x);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float r = x[i];
    x[i] = -CUDART_INF_F;
    if (r != 0.f) {
      const int l = p.lane + i * G;
      const float* kp = p.k + l * a.k_l;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p.v + l * a.v_l));
      float dot = 0.f;
      for (int e = 0; e < a.D; e += C) {
        float qc[C], kc[C];
        load_row<C>(q + e, qc);
        load_row<C>(kp + e, kc);
#pragma unroll
        for (int c = 0; c < C; ++c) dot = fmaf(qc[c], kc[c], dot);
      }
      x[i] = logit_of(a, dot, r);
    }
  }
  softmax_weights<G, P>(a, p.group, x);
  for (int e = 0; e < a.D; e += C) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (x[i] != 0.f) {
        float vc[C];
        load_row<C>(p.v + (p.lane + i * G) * a.v_l + e, vc);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(x[i], vc[c], acc[c]);
      }
    }
    group_sum<G, C>(p.group, acc);
    if (p.lane == 0) store_row<C>(a.out + p.index * a.D + e, acc);
  }
}

template <int G, int P>
int launch(const Args& a, bool aligned, cudaStream_t stream) {
  void (*kernel)(const Args) = decode_attention_any_kernel<1, G, P>;
  if (aligned && a.D % 4 == 0) kernel = decode_attention_any_kernel<4, G, P>;
  if (aligned && a.D == 4) kernel = decode_attention_kernel<4, G, P>;
  if (aligned && a.D == 8) kernel = decode_attention_kernel<8, G, P>;
  if (aligned && a.D == 16) kernel = decode_attention_kernel<16, G, P>;
  const int64_t per_block = kThreads / G;
  const int64_t blocks = (a.pairs + per_block - 1) / per_block;
  if (blocks < 1 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// G lanes a (row, head) and at most P keys a lane, from the number of keys:
// 4 lanes up to 32 keys (a warp holds 8 heads), then wider groups, at most 8
// keys a lane up to 256 keys and 32 up to kMaxLength.
int launch_for_length(const Args& a, bool aligned, cudaStream_t stream) {
  if (a.L <= 8) return launch<4, 2>(a, aligned, stream);
  if (a.L <= 16) return launch<4, 4>(a, aligned, stream);
  if (a.L <= 32) return launch<4, 8>(a, aligned, stream);
  if (a.L <= 64) return launch<8, 8>(a, aligned, stream);
  if (a.L <= 128) return launch<16, 8>(a, aligned, stream);
  if (a.L <= 256) return launch<32, 8>(a, aligned, stream);
  if (a.L <= kMaxLength) return launch<32, 32>(a, aligned, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q and out [B, H * d] contiguous; keys, values and the mask by their
// strides in floats (the keys' and values' last stride 1); any d >= 1;
// 1 <= L <= 1024.  Returns a cudaError_t, 0 when the launch was taken.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int64_t k_b, int64_t k_h,
                                       int64_t k_l, int64_t v_b, int64_t v_h, int64_t v_l,
                                       int64_t m_b, int64_t m_l, int64_t B, int H, int L, int d,
                                       float alpha, int round, void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(mask),
         static_cast<float*>(out), k_b, k_h, k_l, v_b, v_h, v_l, m_b, m_l, B * H, H, L, d, alpha,
         round};
  if (B < 1 || H < 1 || L < 1 || d < 1 || round < 0 || round > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // every row of q, k, v and out starts on a 16-byte boundary
  const bool aligned = on16(q) && on16(k) && on16(v) && on16(out) && d % 4 == 0 &&
                       (k_b | k_h | k_l | v_b | v_h | v_l) % 4 == 0;
  return launch_for_length(a, aligned, static_cast<cudaStream_t>(stream));
}
