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
// activation tile (the load is not skipped) unless `skip` is 0: the
// reference's skip_zero_inputs=False, the paper's dense-input mode, which
// runs every stored step's MAC (a skipped step adds exact zeros, so the
// output is the same bits either way).  Shapes: vk and vn are runtime
// values (vn <= 128), M may be ragged (the tail rows are masked).
//
// Two branches, as the reference's `_mac_dot` has: f32 (vsmm_kernel) and
// int8 (vsmm_int8_kernel: int8 x and tiles, a per-column power-of-two
// dequant scale).  The int8 branch stages a quarter of the bytes and
// computes each step's partial exactly in int32 with __dp4a, then adds it
// into the f32 accumulator in stored order (vs_tile.cuh, Step<int8_t>):
// bit-equal to the reference and to the plain version.
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores (no tensor cores:
// TF32 would break the 1e-5 agreement with the f32 reference) and the
// bytes of x, the stored tiles, the output and the residual.  This first
// version re-reads each activation tile once per strip through L2 and
// keeps every operand in shared memory for one step only; wgmma, TMA and
// multi-stage pipelining are for later work.  The int8 branch is bound the
// same way (dp4a on the CUDA cores, not the int8 tensor cores' mma; the
// bytes are a quarter of f32's for x and the tiles).
#include "vs_tile.cuh"

namespace {

// The whole block for element type T (float, or int8_t: the int8 branch,
// see vs_tile.cuh's Step<int8_t>).  `words`: int8 activation rows load as
// 32-bit words (vs::word_rows).
template <class T>
__device__ __forceinline__ void vsmm_body(
    const T* __restrict__ x, const T* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int m, int k, int nb, int s_steps, int vk,
    int vn, int relu, int skip, bool words) {
  using Step = vs::Step<T>;
  using Word = typename Step::Word;
  extern __shared__ __align__(16) unsigned char vsmm_smem[];
  Word* ws = reinterpret_cast<Word*>(vsmm_smem);
  Word* xs = ws + Step::weight_words(vk, vn);
  const int j = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * vs::kRows;
  const int rows_valid =
      static_cast<int>(min(static_cast<long long>(vs::kRows), m - row0));

  float acc[vs::kRowsPerThread][vs::kColsPerThread] = {};
  for (int s = 0; s < s_steps; ++s) {
    const long long tile = static_cast<long long>(j) * s_steps + s;
    const long long col_base = static_cast<long long>(idx[tile]) * vk;
    __syncthreads();  // the previous step's MAC is done with ws and xs
    Step::load_weights(ws, vals, tile, vk, vn);
    const int nonzero =
        Step::load_acts(xs, vk, rows_valid, words, [&](int r) {
          return x + (row0 + r) * k + col_base;
        });
    if (__syncthreads_or(nonzero || !skip)) Step::mac(acc, xs, ws, vk, vn);
  }
  vs::epilogue(acc, out, row0, rows_valid, nb * vn, j * vn, vn, scale, bias,
               residual, relu);
}

#define VSMM_PARAMS(T)                                                      \
  const T *__restrict__ x, const T *__restrict__ vals,                      \
      const int *__restrict__ idx, const float *__restrict__ scale,         \
      const float *__restrict__ bias, const float *__restrict__ residual,   \
      float *__restrict__ out, int m, int k, int nb, int s_steps, int vk,   \
      int vn, int relu, int skip
#define VSMM_ARGS                                                        \
  x, vals, idx, scale, bias, residual, out, m, k, nb, s_steps, vk, vn, relu, \
      skip

__global__ void __launch_bounds__(vs::kThreads)
    vsmm_kernel(VSMM_PARAMS(float)) {
  vsmm_body<float>(VSMM_ARGS, false);
}

__global__ void __launch_bounds__(vs::kThreads)
    vsmm_int8_kernel(VSMM_PARAMS(int8_t), int words) {
  vsmm_body<int8_t>(VSMM_ARGS, words != 0);
}

template <class T, class Kernel, class... Extra>
int launch_vsmm(Kernel kernel, void* stream, VSMM_PARAMS(T), Extra... extra) {
  const size_t smem = vs::Step<T>::smem_bytes(vk, vn);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid((m + vs::kRows - 1) / vs::kRows, nb);
  kernel<<<grid, vs::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      VSMM_ARGS, extra...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Any of
// scale, bias and residual may be null; `skip` 0 turns the input-side skip
// off.  The caller has checked shapes,
// dtypes, contiguity and vn <= 128.
extern "C" int vsmm_launch(VSMM_PARAMS(float), void* stream) {
  return launch_vsmm<float>(vsmm_kernel, stream, VSMM_ARGS);
}

// The int8 branch: x and vals int8, scale (the combined dequant scale,
// a power of two per column) given by the caller.
extern "C" int vsmm_int8_launch(VSMM_PARAMS(int8_t), void* stream) {
  return launch_vsmm<int8_t>(vsmm_int8_kernel, stream, VSMM_ARGS,
                             static_cast<int>(vs::word_rows(x, vk)));
}
