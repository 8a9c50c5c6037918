// vsmm: vector-sparse matmul, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/vsmm.py::vsmm_pallas (body
// `_kernel`, MAC `_mac_dot`) of the JAX package:
//
//   out (M, NB*vn) = x (M, K) @ W, W a balanced block-CSR matrix with
//   stored tiles vals (NB, S, vk, vn) and K-tile ids idx (NB, S),
//   then x scale, + bias, + residual, ReLU.
//
// One block per (row tile of kRows rows, output strip j); the TPU grid's
// sequential sparse-step axis becomes the loop over s inside the block.
// Step s reads idx[j, s] itself, stages the stored tile in shared memory
// and gathers the (kRows x vk) activation tile at columns idx[j, s]*vk.
// A block-wide vote (__syncthreads_or) skips the FMAs of an all-zero
// activation tile; the load is not skipped.  Shapes: vk and vn are runtime
// values (vn <= 128), M may be ragged (the tail rows are masked).
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores (no tensor cores:
// TF32 would break the 1e-5 agreement with the f32 reference) and the
// bytes of x, the stored tiles, the output and the residual.  This first
// version re-reads each activation tile once per strip through L2 and
// keeps every operand in shared memory for one step only; wgmma, TMA and
// multi-stage pipelining are for later work.
#include "vs_tile.cuh"

namespace {

__global__ void __launch_bounds__(vs::kThreads)
    vsmm_kernel(const float* __restrict__ x, const float* __restrict__ vals,
                const int* __restrict__ idx, const float* __restrict__ scale,
                const float* __restrict__ bias,
                const float* __restrict__ residual, float* __restrict__ out,
                int m, int k, int nb, int s_steps, int vk, int vn, int relu) {
  extern __shared__ float smem[];
  float* ws = smem;            // vk * vn
  float* xs = smem + vk * vn;  // kRows * vk
  const int j = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * vs::kRows;
  const int rows_valid =
      static_cast<int>(min(static_cast<long long>(vs::kRows), m - row0));

  float acc[vs::kRowsPerThread][vs::kColsPerThread] = {};
  for (int s = 0; s < s_steps; ++s) {
    const long long tile = static_cast<long long>(j) * s_steps + s;
    const long long col_base = static_cast<long long>(idx[tile]) * vk;
    __syncthreads();  // the previous step's MAC is done with ws and xs
    vs::load_weight_tile(ws, vals, tile, vk, vn);
    int nonzero = 0;
    for (int e = threadIdx.x; e < vs::kRows * vk; e += vs::kThreads) {
      const int r = e / vk;
      const int c = e - r * vk;
      const float v = r < rows_valid ? x[(row0 + r) * k + col_base + c] : 0.f;
      xs[e] = v;
      nonzero |= v != 0.f;
    }
    if (__syncthreads_or(nonzero)) vs::mac_tile(acc, xs, ws, vk, vn);
  }
  vs::epilogue(acc, out, row0, rows_valid, nb * vn, j * vn, vn, scale, bias,
               residual, relu);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Any of
// scale, bias and residual may be null.  The caller has checked shapes,
// dtypes, contiguity and vn <= 128.
extern "C" int vsmm_launch(const float* x, const float* vals, const int* idx,
                           const float* scale, const float* bias,
                           const float* residual, float* out, int m, int k,
                           int nb, int s_steps, int vk, int vn, int relu,
                           void* stream) {
  const size_t smem = vs::tile_smem_bytes(vk, vn);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(vsmm_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid((m + vs::kRows - 1) / vs::kRows, nb);
  vsmm_kernel<<<grid, vs::kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      x, vals, idx, scale, bias, residual, out, m, k, nb, s_steps, vk, vn,
      relu);
  return static_cast<int>(cudaGetLastError());
}
