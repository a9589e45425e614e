// Contingency-count kernel for batched BIC scoring, CUDA C++ for sm_90a.
//
// Replaces: dags_vae_search_tpu/ops/bic_pallas.py::_counts_kernel, the TPU
// kernel launched by contingency_counts_pallas.  For every row r = (candidate
// b, node i) it computes the weighted histogram
//
//     out[r, s] = sum_u w[u] * [seg[r, u] == s],   s in [0, S)
//
// over the U unique dataset rows, where seg = clip(cfg, 0, q_cap-1) * r_max
// + child_code is the flat contingency cell and w[u] the row's multiplicity.
// Cells outside [0, S) (padding sentinels) are skipped.
//
// Bound: memory.  Each launch reads seg once (R*U int32) and writes R*S
// float32; the arithmetic is one add per element.  At the alarm search
// shape (R = 2048*37, U = 4973, S = 512) that is ~1.66 GB, ~0.5 ms at
// 3.35 TB/s.
//
// Design: the TPU kernel turns counting into a dense [U, S] compare-select
// because its vector unit has no scatter.  Hopper has fast shared-memory
// atomics, so here one block owns one row: it zeroes S bins in shared
// memory, its threads stride over u with coalesced seg loads and atomicAdd
// w[u] into the bin, and after a barrier the block writes its S bins out.
// Weights are integers and every bin stays below 2^24, so float atomics are
// exact in any order: the result equals the plain scatter-add bit for bit.
// Later work: fuse the configuration product in so seg is never written,
// and aggregate equal cells within a warp before the shared atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
contingency_counts_kernel(const float* __restrict__ w,
                          const int32_t* __restrict__ seg,
                          float* __restrict__ out,
                          int U, int S) {
  extern __shared__ float bins[];
  const int64_t row = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += kThreads) bins[s] = 0.0f;
  __syncthreads();

  const int32_t* seg_row = seg + row * static_cast<int64_t>(U);
  for (int u = threadIdx.x; u < U; u += kThreads) {
    const int s = seg_row[u];
    if (static_cast<unsigned>(s) < static_cast<unsigned>(S)) {
      atomicAdd(&bins[s], w[u]);
    }
  }
  __syncthreads();

  float* out_row = out + row * static_cast<int64_t>(S);
  for (int s = threadIdx.x; s < S; s += kThreads) out_row[s] = bins[s];
}

}  // namespace

// C interface for ctypes.  w: float32[U], seg: int32[R, U], out: float32[R, S],
// all contiguous on the current device; stream is a cudaStream_t.  Returns
// the cudaError_t of the launch (0 on success).  The caller checks
// 0 < R < 2^31 and S * 4 <= 232448 bytes of shared memory.
extern "C" int contingency_counts_launch(const void* w, const void* seg,
                                         void* out, int64_t R, int U, int S,
                                         void* stream) {
  const size_t smem = static_cast<size_t>(S) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        contingency_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  contingency_counts_kernel<<<static_cast<unsigned>(R), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int32_t*>(seg),
      static_cast<float*>(out), U, S);
  return static_cast<int>(cudaGetLastError());
}
