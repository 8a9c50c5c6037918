// Tile machinery shared by the vector-sparse kernels (vsmm.cu, vsconv.cu).
//
// Both kernels compute one (kRows x vn) output tile per block: kRows rows
// (matrix rows for vsmm, flattened output pixels for the conv) of one
// output strip j.  The block loops over the strip's S stored tiles in
// stored order.  Step s stages the stored (vk x vn) weight tile and the
// (kRows x vk) activation tile that idx[j, s] selects in shared memory,
// votes block-wide whether the activation tile has a nonzero (the paper's
// input-side skip: an all-zero tile issues no FMAs), and accumulates in
// f32 registers.  The epilogue is the reference's: x scale, + bias,
// + residual, ReLU, masked at the ragged row tail.
//
// Thread layout: 256 threads = 8 warps.  Thread (ty = warp, tx = lane)
// owns rows ty + 8*i (i < 4) and columns tx + 32*c (c < 4) of the tile, so
// vn is at most 128.  A warp reads one activation row (broadcast) and 32
// consecutive weight columns (no bank conflicts) per k.
#pragma once

#include <cuda_runtime.h>

namespace vs {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 4;
constexpr int kMaxVn = 32 * kColsPerThread;

// Dynamic shared memory of one block: the weight tile and the activation
// tile, both f32.
inline size_t tile_smem_bytes(int vk, int vn) {
  return sizeof(float) * (static_cast<size_t>(vk) * vn +
                          static_cast<size_t>(kRows) * vk);
}

// Stage the stored tile number `tile` (vk x vn, contiguous) into ws.
__device__ __forceinline__ void load_weight_tile(float* ws,
                                                 const float* __restrict__ vals,
                                                 long long tile, int vk,
                                                 int vn) {
  const float* src = vals + tile * vk * vn;
  for (int e = threadIdx.x; e < vk * vn; e += kThreads) ws[e] = src[e];
}

// acc += xs (kRows x vk) @ ws (vk x vn) for this thread's 4x4 outputs.
__device__ __forceinline__ void mac_tile(
    float (&acc)[kRowsPerThread][kColsPerThread], const float* xs,
    const float* ws, int vk, int vn) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int k = 0; k < vk; ++k) {
    float a[kRowsPerThread];
    float b[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) a[i] = xs[(ty + 8 * i) * vk + k];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = tx + 32 * c;
      b[c] = col < vn ? ws[k * vn + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
    }
  }
}

// out[row0 + r, col0 + c] = relu?(acc * scale + bias + residual) for the
// rows r < rows_valid and columns c < vn this thread owns.  out and
// residual are row-major with n_total columns; scale/bias are indexed by
// the global column; any of the three may be null.
__device__ __forceinline__ void epilogue(
    const float (&acc)[kRowsPerThread][kColsPerThread],
    float* __restrict__ out, long long row0, int rows_valid, int n_total,
    int col0, int vn, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    int relu) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows_valid) continue;
    const long long row = row0 + r;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int cl = tx + 32 * c;
      if (cl >= vn) continue;
      const int col = col0 + cl;
      float v = acc[i][c];
      if (scale) v = v * scale[col];
      if (bias) v = v + bias[col];
      if (residual) v = v + residual[row * n_total + col];
      if (relu && v < 0.f) v = 0.f;  // NaN passes through, as in max(v, 0)
      out[row * n_total + col] = v;
    }
  }
}

}  // namespace vs
