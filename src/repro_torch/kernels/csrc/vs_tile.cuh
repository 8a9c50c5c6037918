// Tile machinery of the conv kernels' generic body (vsconv.cu); vsmm.cu
// has its own since it was rebuilt for split stored steps.
//
// The body computes one (kRows x vn) output tile per block: kRows
// flattened output pixels of one output strip j.  The block loops over the strip's S stored tiles in
// stored order.  Step s stages the stored (vk x vn) weight tile and the
// (kRows x vk) activation tile that idx[j, s] selects in shared memory,
// votes block-wide whether the activation tile has a nonzero (the paper's
// input-side skip: an all-zero tile issues no FMAs; the kernels' `skip`
// argument 0 turns it off), and accumulates in f32 registers.  The
// epilogue is the reference's: x scale, + bias, + residual, ReLU, masked
// at the ragged row tail.
//
// Thread layout: 256 threads = 8 warps.  Thread (ty = warp, tx = lane)
// owns rows ty + 8*i (i < 4) and columns tx + 32*c (c < 4) of the tile, so
// vn is at most 128.  A warp reads one activation row (broadcast) and 32
// consecutive weight columns (no bank conflicts) per k.
//
// `Step<T>` is one stored step for an element type: Step<float> stages
// f32 tiles and FMAs them into the accumulator; Step<int8_t> (the int8
// branch of the reference's `_mac_dot`) stages int8 tiles packed four k a
// 32-bit word (a quarter of the f32 bytes), computes the step's partial
// in int32 registers with __dp4a (exact: at most 127^2 * vk), converts it
// to f32 (exact below 2^24, vk <= 1040) and adds it into the f32
// accumulator: one add a step, in stored order, as the reference does, so
// the sum is bit-equal to it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vs {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 4;
constexpr int kMaxVn = 32 * kColsPerThread;

template <class T>
struct Step;

template <>
struct Step<float> {
  using Word = float;  // a shared-memory word

  // Dynamic shared memory of one block: the weight tile and the
  // activation tile.
  static size_t smem_bytes(int vk, int vn) {
    return sizeof(float) * (static_cast<size_t>(vk) * vn +
                            static_cast<size_t>(kRows) * vk);
  }
  // Words of the weight tile (the activation tile follows it).
  __host__ __device__ static int weight_words(int vk, int vn) {
    return vk * vn;
  }

  // Stage the stored tile number `tile` (vk x vn, contiguous) into ws.
  __device__ __forceinline__ static void load_weights(
      float* ws, const float* __restrict__ vals, long long tile, int vk,
      int vn) {
    const float* src = vals + tile * vk * vn;
    for (int e = threadIdx.x; e < vk * vn; e += kThreads) ws[e] = src[e];
  }

  // Stage the (kRows x vk) activation tile whose row r starts at
  // row(r) (rows r >= rows_valid read zeros) into xs; returns this
  // thread's share of the nonzero vote.  `words` is unused (f32 loads).
  template <class Row>
  __device__ __forceinline__ static int load_acts(float* xs, int vk,
                                                  int rows_valid, bool words,
                                                  Row row) {
    (void)words;
    int nonzero = 0;
    for (int e = threadIdx.x; e < kRows * vk; e += kThreads) {
      const int r = e / vk;
      const int c = e - r * vk;
      const float v = r < rows_valid ? row(r)[c] : 0.f;
      xs[e] = v;
      nonzero |= v != 0.f;
    }
    return nonzero;
  }

  // acc += xs (kRows x vk) @ ws (vk x vn) for this thread's 4x4 outputs.
  __device__ __forceinline__ static void mac(
      float (&acc)[kRowsPerThread][kColsPerThread], const float* xs,
      const float* ws, int vk, int vn) {
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    for (int k = 0; k < vk; ++k) {
      float a[kRowsPerThread];
      float b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        a[i] = xs[(ty + 8 * i) * vk + k];
      }
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
};

template <>
struct Step<int8_t> {
  using Word = int;  // four int8 along k, k = 4q + byte (little-endian)

  __host__ __device__ static int k_words(int vk) { return (vk + 3) / 4; }

  // Dynamic shared memory of one block: the packed weight tile
  // (k_words x vn words) and the packed activation tile (kRows x k_words).
  static size_t smem_bytes(int vk, int vn) {
    return sizeof(int) * static_cast<size_t>(k_words(vk)) *
           (static_cast<size_t>(vn) + kRows);
  }
  __host__ __device__ static int weight_words(int vk, int vn) {
    return k_words(vk) * vn;
  }

  // Byte b of a word is k = 4q + b; bytes past vk are zero.
  __device__ __forceinline__ static int pack(const int8_t* p, int stride,
                                             int n) {
    int v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < n) {
        v |= static_cast<int>(static_cast<uint8_t>(p[b * stride])) << (8 * b);
      }
    }
    return v;
  }

  // Stage the stored tile `tile` (vk x vn int8, row-major) as words
  // ws[q * vn + col] = w[4q .. 4q+3][col]: a warp reads 32 consecutive
  // words of one q (no bank conflicts).
  __device__ __forceinline__ static void load_weights(
      int* ws, const int8_t* __restrict__ vals, long long tile, int vk,
      int vn) {
    const int8_t* src = vals + tile * vk * vn;
    const int n = k_words(vk) * vn;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int q = e / vn;
      const int col = e - q * vn;
      ws[e] = pack(src + 4 * q * vn + col, vn, vk - 4 * q);
    }
  }

  // Stage the activation tile as words xs[r * k_words + q] = row(r)[4q ..
  // 4q+3].  `words` (vk % 4 == 0 and every row start 4-byte aligned):
  // one 32-bit load a word, which never reads past a row's vk bytes;
  // otherwise byte loads, zero past vk.  The vote is on whole words.
  template <class Row>
  __device__ __forceinline__ static int load_acts(int* xs, int vk,
                                                  int rows_valid, bool words,
                                                  Row row) {
    const int kq = k_words(vk);
    int nonzero = 0;
    for (int e = threadIdx.x; e < kRows * kq; e += kThreads) {
      const int r = e / kq;
      const int q = e - r * kq;
      int v = 0;
      if (r < rows_valid) {
        const int8_t* p = row(r) + 4 * q;
        v = words ? *reinterpret_cast<const int*>(p) : pack(p, 1, vk - 4 * q);
      }
      xs[e] = v;
      nonzero |= v != 0;
    }
    return nonzero;
  }

  // The step's partial xs @ ws in int32 (__dp4a: four int8 products a
  // lane and instruction), then one exact f32 add into acc.
  __device__ __forceinline__ static void mac(
      float (&acc)[kRowsPerThread][kColsPerThread], const int* xs,
      const int* ws, int vk, int vn) {
    const int tx = threadIdx.x & 31;
    const int ty = threadIdx.x >> 5;
    const int kq = k_words(vk);
    int part[kRowsPerThread][kColsPerThread] = {};
    for (int q = 0; q < kq; ++q) {
      int a[kRowsPerThread];
      int b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = xs[(ty + 8 * i) * kq + q];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tx + 32 * c;
        b[c] = col < vn ? ws[q * vn + col] : 0;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          part[i][c] = __dp4a(a[i], b[c], part[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        acc[i][c] += static_cast<float>(part[i][c]);
      }
    }
  }
};

// True when every activation row of an int8 tile starts 4-byte aligned and
// holds whole words: vk % 4 == 0 and x itself aligned (every row offset
// is a multiple of vk).
inline bool word_rows(const void* x, int vk) {
  return vk % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
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
