// vsmm: vector-sparse matmul, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/vsmm.py::vsmm_pallas (body
// `_kernel`, MAC `_mac_dot`) of the JAX package:
//
//   out (M, NB*vn) = x (M, K) @ W, W a balanced block-CSR matrix with
//   stored tiles vals (NB, S, vk, vn) and K-tile ids idx (NB, S),
//   then x scale, + bias, + residual, ReLU.
//
// The TPU grid walks a strip's S stored tiles in order on one core.  Here
// the work is cut three ways, by a plan the wrapper computes from the
// shapes alone (kernels/vsmm.py::vsmm_plan, the same shapes always give
// the same plan and the same bits):
//   - a row tile of `rows` = 8, 32, 64 or 128 matrix rows;
//   - an output strip j (vn <= 128 columns);
//   - a chunk c of `splits` contiguous chunks of the strip's stored steps:
//     chunk c takes steps [S*c/splits, S*(c+1)/splits), in stored order.
// At M = 8 a head has only NB (row tile, strip) pairs (VGG-16's fc1: 32,
// each of 184 steps, for 132 SMs); the split gives every SM work.
// `splits` is 1 where the row tiles x NB already fill the card.
//
// Phase 1 (vsmm_kernel<RT>, vsmm_int8_kernel<RT, SPLIT>): blocks per
// (strip, chunk) up to the strip's share of the blocks the card holds at
// once; block b walks row tiles b, b + gridDim.x, ... (one tile each
// unless M is large: MobileNetV1's pw1 has 784).  A block streams each
// tile's stored steps and the (rows x vk) activation tiles that idx
// selects through a ring of kStages stages with cp.async, one sequence
// across its tiles, so a tile's first copies fly while the one before is
// multiplied and stored.  A stage holds `group` steps (as many as fit
// kStageBytes, at least 2 for 64- and 128-row tiles, at most kMaxGroup);
// its copies are issued kStages - 1 stages ahead of its MAC, and it costs
// one barrier, not one per stored tile.  Thread layout: a thread owns RT
// rows (rg + rgn*i) x 4 consecutive columns (4*cg .. 4*cg+3) of the tile,
// so an 8-row tile keeps 2 x 4 outputs a thread busy (RT 2, 4 warps at vn
// 128) and a 64- or 128-row tile 8 x 4 (RT 8).
// The zero-skip vote is one block-uniform vote a step, taken for a whole
// stage at once and carried by the stage's barrier: each thread votes on
// the activation bytes it copied itself (complete after its own cp.async
// wait), the votes are OR-ed into a shared word, and the barrier that
// publishes the stage publishes the word.  A stored step whose activation
// tile is all zero adds exact zeros, so it is skipped; `skip` 0 (the
// reference's skip_zero_inputs=False, the paper's dense-input mode) takes
// no vote.  With splits == 1 the block applies the epilogue itself;
// otherwise it writes its chunk's partial to a workspace.
//
// Phase 2 (vsmm_reduce_kernel, vsmm_int8_reduce_kernel), only when
// splits > 1: one thread an output element combines the chunks in chunk
// order (so the output is the same bits from run to run), then applies
// the epilogue.  Both phases run on the caller's stream; the workspace is
// the caller's (PyTorch's allocator), so a CUDA graph captures both.
//
// Three branches, as the reference's `_mac_dot` takes f32, bf16 and int8:
//   - f32: FMAs into f32 accumulators.  Phase 2 sums the chunks' partial
//     tiles in chunk order: another summation order than the reference's,
//     within the 1e-5 bound.
//   - bf16 (bf16 x and tiles; the LM's vector-sparse FFN): its own body on
//     the tensor cores (Bf16Body, vsmm_bf16_kernel<ROWS>; see below).
//   - int8 (int8 x and tiles, a per-column power-of-two dequant scale):
//     each stored step's partial is an exact int32 (__dp4a; a weight row
//     word is transposed to a column word with __byte_perm).  The
//     reference adds each step's partial into an f32 accumulator in stored
//     order, and past 2^24 only that order gives its bits.  With splits ==
//     1 the block does exactly that.  With splits > 1 (8- and 32-row
//     tiles only: at more rows the 8-byte partials cost more than the
//     split gains) a chunk keeps its exact integer sum T_c and the largest
//     |prefix sum| A_c of its steps (int32: |T_c| <= 128^2 * vk * S <
//     2^31, which the plan ensures); phase 2 walks the chunks with an
//     exact int64 base B: while every |B| + A_c <= 2^24, every f32 add of
//     the reference was exact and the result is float(B_total), bit for
//     bit; otherwise it recomputes that element serially in stored order
//     from x and the tiles.
//
// What bounds the f32 and int8 branches on an H100: at 8 rows the bytes
// of the stored tiles (VGG-16's fc1: 96.6 MB f32); at large M fp32 FMAs on
// the CUDA cores (no tensor cores: TF32 would break the 1e-5 agreement
// with the f32 reference; the int8 branch uses dp4a) and the activation
// and output bytes.  The design keeps several stages of tiles in flight
// on every SM and reuses each staged weight word for RT rows and each
// activation word for 4 columns.
//
// The bf16 branch (replacing the widened CUDA-core body of the first port)
// multiplies on the tensor cores: mma.sync.m16n8k16.row.col.f32.bf16 with
// its operands from shared memory by ldmatrix.  Bounds: at a decode step
// (M = the batch, 8) the bytes of the stored tiles (Nemotron-4's wi: 637
// MB, 0.19 ms at 3.35 TB/s); at a prefill (M 1024 to 4096) the bf16
// tensor-core rate (Nemotron-4's wi at M 1024: 0.66 ms).  Two tilings, by
// kernels/vsmm.py::vsmm_bf16_plan:
//   - decode, M <= 32 (rows 8, 16, 32): the swapped product D (vn x rows) =
//     W^T (vn x vk) . x^T, so the strip's columns ride the mma's 16-row
//     side and the few rows its 8-wide side (a 16-row tile would be half
//     empty at M 8); A = W^T through ldmatrix.trans from the (vk, vn) tile,
//     B = the x rows through ldmatrix.  4 warps, 2 m16 column tiles each;
//     5 blocks an SM at 8 rows, each with a ring of 4-5 stages at the
//     FFN's tiles, keep some 150 KB of tiles in flight on every SM.  Where the strips alone
//     do not fill the card (Qwen1.5-4B's wi: 64) the plan splits each
//     strip's steps into chunks, combined by phase 2.
//   - prefill, M > 32 (rows 64): x the A operand (ldmatrix), the tile the
//     B operand (ldmatrix.trans); 8 warps as 2 x 4 own a 64 x 128 output
//     tile, 32 x 32 each, accumulators in registers; 2 blocks an SM, a
//     ring of up to 8 stages.  (128-row tiles need more than the 128
//     registers a thread that two blocks an SM leave, and were slower.)
// A block walks items (row tile, strip, chunk) blockIdx.x, + gridDim.x,
// ... (grid: the blocks the card holds at once) as one sequence of stored
// steps: step q + ring - 1's copies (cp.async) are issued before step q's
// MAC, and each step costs one barrier.  Its idx is copied into a shared
// ring a ring of steps ahead, so no load of idx stands between two steps.
// Numerics: each bf16 x bf16 product is exact in f32; a fresh mma chain
// per 32 k (two k16 slices) is added to f32 accumulators, so the tensor
// cores' own rounding (toward zero, inside an instruction) spans at most
// 32 products and the sum over the steps is f32 in stored order, as the
// reference's acc += dot(x, w).  (Accumulating in the mma over all of
// Nemotron-4's 17,408 products of a wo output missed 1e-5 on the card.)
// Padding: vk rounds up to kp (a multiple of 16), vn to np; a staged W
// tile's rows past vk and columns past vn, and an x tile's columns past
// vk, are zeroed once and never written, so the padding multiplies zeros
// by zeros (a stale word could be a NaN).  Shared rows are an odd
// multiple of 16 bytes apart (vn 128: 272; 108 and 112: 240; kp 32: 80),
// so the 8 rows an ldmatrix reads sit in 8 distinct bank groups.  Rows
// of x that are not 16-, 8- or 4-byte aligned (Qwen1.5-4B's merged wo has
// vk 27: tiles 54 bytes apart) are copied as the 16-byte units that span
// them into raw rows, then shifted into the x tile after the barrier (one
// more barrier a step).  This keeps the copies asynchronous: 2-byte loads
// held in registers over a step stall every step on their latency.
// Against padding x in the wrapper (chip_smoke.py's vk27_staging times
// both; PERF.md): at M 8 the shift costs less than the pad's extra
// launch; at M 4096 the padded product runs faster, but its tiles must
// be padded too (the kernel gathers x by the tiles' vk), a copy of the
// weight on every call, so the kernel shifts.  The zero-skip vote: one
// block-uniform vote a step, the words each thread copied (or shifted)
// OR-ed by the step's barrier itself (__syncthreads_or), a bf16 -0
// counting as zero; skip off gives skip on's bits.  The epilogue is the
// f32 body's (store4), f32 or rounded to bf16.
// Every branch writes f32 or, with `out_bf16` (the reference's out_dtype),
// rounds the epilogue's f32 result to bf16 (round to nearest even).
#include "vs_async.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxThreads = 256;         // threads a block, at most
constexpr int kSms = 132;                // an H100's SMs (vsmm_plan's SMS)
constexpr int kStages = 3;               // stages in the cp.async ring
constexpr int kMaxGroup = 4;             // stored steps a stage
constexpr int kStageBytes = 32 * 1024;   // a stage's tiles (see group)
constexpr long long kExact = 1LL << 24;  // f32 holds every integer up to it

__host__ __device__ inline int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// rows a thread, by row tile: 8 -> 2, 32 -> 4, 64 and 128 -> 8.
__host__ __device__ inline int rows_per_thread(int rows) {
  return rows == 8 ? 2 : rows == 32 ? 4 : 8;
}

// The launch geometry: a pure function of (rows, vk, vn, element size,
// the longest chunk, the row tiles a block walks) and of the operands'
// alignment (the copy modes).
struct Geo {
  int rows;       // row tile
  int rgn, cgn;   // row groups (rows / RT), column groups (ceil(vn / 4))
  int threads;    // rgn * cgn rounded up to a warp
  int k4;         // vk rounded up to 4: the rows of a staged weight tile
  int xs_stride;  // bytes between staged activation rows
  int ws_stride;  // bytes between staged weight rows
  int w_bytes;    // a staged weight tile, 16-byte aligned
  int step_bytes; // a staged step: weight tile, then activation tile
  int group;      // stored steps a stage
  int ring;       // stage buffers: kStages, or fewer if no block needs them
  int mode_x, mode_w;  // copy units: 16 or 4 bytes (cp.async), 2 or 1
                       // (loads of that many bytes)
  int vec_out;    // 1: the epilogue reads and writes 4 columns at once
  int out_bf16;   // 1: the output is bf16
};

inline Geo make_geo(int rows, int vk, int vn, int esize, int max_chunk,
                    int tiles_per_block, int mode_x, int mode_w,
                    int vec_out, int out_bf16) {
  Geo g;
  g.rows = rows;
  g.rgn = rows / rows_per_thread(rows);
  g.cgn = (vn + 3) / 4;
  g.threads = round_up(g.rgn * g.cgn, 32);
  g.k4 = round_up(vk, 4);
  // f32: rows 4 floats apart mod 32 banks (float4 reads of 8 rows hit 8
  // distinct bank quads); int8 and bf16: 16 bytes past the data, rows
  // 16-aligned.
  g.xs_stride = esize == 4 ? (g.k4 + 4) * 4
                           : round_up(g.k4 * esize, 16) + 16;
  g.ws_stride = round_up(vn, 4) * esize;
  g.w_bytes = round_up(g.k4 * g.ws_stride, 16);
  g.step_bytes = g.w_bytes + round_up(rows * g.xs_stride, 16);
  // Tiles of 64 and 128 rows (RT 8, 2 blocks an SM at most anyway) take
  // at least 2 steps a stage: fewer barriers and votes per step gained
  // more than the blocks an SM that their shared memory then costs.
  int group = kStageBytes / g.step_bytes;
  const int least = rows >= 64 ? 2 : 1;
  group = group < least ? least : group > kMaxGroup ? kMaxGroup : group;
  g.group = group < max_chunk ? group : (max_chunk < 1 ? 1 : max_chunk);
  const int stages = tiles_per_block * ((max_chunk + g.group - 1) / g.group);
  g.ring = stages < kStages ? (stages < 1 ? 1 : stages) : kStages;
  g.mode_x = mode_x;
  g.mode_w = mode_w;
  g.vec_out = vec_out;
  g.out_bf16 = out_bf16;
  return g;
}

inline size_t smem_bytes(const Geo& g) {
  return static_cast<size_t>(g.ring) * g.group * g.step_bytes;
}

// Stage `rows` rows into shared memory at dst (rows `stride` bytes apart):
// row r < valid takes `nbytes` bytes from src(r), then zeros up to
// `pbytes`; rows >= valid are zeros.  mode 16 / 4: cp.async units of that
// many bytes (nbytes a multiple of it, every src row aligned to it);
// mode 2 / 1: loads of 2 bytes (nbytes even, rows 2-aligned) or single
// bytes (any alignment) packed into words, stored at once.
// Walks a (rows x units) grid with the block's threads: thread t takes
// units u0 + k*ustep of rows r0 + k*rstep (one division, at the start).
struct Grid2 {
  int r0, rstep, u0, ustep;
  __device__ __forceinline__ Grid2(int units) {
    ustep = min(units, static_cast<int>(blockDim.x));
    r0 = threadIdx.x / ustep;
    u0 = threadIdx.x - r0 * ustep;
    rstep = blockDim.x / ustep;
  }
};

template <class Src>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int stride,
                                           int rows, int valid, int nbytes,
                                           int pbytes, int mode, Src src,
                                           const void* base) {
  if (mode <= 2) {
    const int words = pbytes / 4;
    const Grid2 g(words);
    if (g.r0 >= g.rstep) return;  // the threads past rstep * ustep
    for (int r = g.r0; r < rows; r += g.rstep) {
      for (int q = g.u0; q < words; q += g.ustep) {
        unsigned v = 0;
        if (r < valid) {
          const unsigned char* p = src(r) + 4 * q;
          const int n = min(4, nbytes - 4 * q);
          if (mode == 2) {
            for (int b = 0; b < n; b += 2) {
              v |= static_cast<unsigned>(
                       *reinterpret_cast<const unsigned short*>(p + b))
                   << (8 * b);
            }
          } else {
            for (int b = 0; b < n; ++b) {
              v |= static_cast<unsigned>(p[b]) << (8 * b);
            }
          }
        }
        *reinterpret_cast<unsigned*>(dst + r * stride + 4 * q) = v;
      }
    }
    return;
  }
  const int units = nbytes / mode;
  const Grid2 g(units);
  if (g.r0 >= g.rstep) return;
  const int tail = (pbytes - nbytes) / 4;  // f32: vk or vn not a multiple of 4
  for (int r = g.r0; r < rows; r += g.rstep) {
    const bool ok = r < valid;
    unsigned char* d = dst + r * stride;
    const unsigned char* s = ok ? src(r) : nullptr;
    for (int u = g.u0; u < units; u += g.ustep) {
      const void* from = ok ? static_cast<const void*>(s + u * mode) : base;
      if (mode == 16) {
        vs::cp_async16(d + u * mode, from, ok);
      } else {
        vs::cp_async4(d + u * mode, from, ok);
      }
    }
    for (int w = g.u0; w < tail; w += g.ustep) {
      *reinterpret_cast<int*>(d + nbytes + 4 * w) = 0;
    }
  }
}

// This thread's share of the vote on a stage of n steps: bit s when an
// activation word that this thread copied for step s (the units
// `stage_rows` gives it) holds a nonzero value or a NaN.  A thread reads
// only what its own copies wrote, which its cp.async wait has completed, so the
// stage's one barrier publishes the data and the vote together.
template <class T>
__device__ __forceinline__ unsigned own_votes(const unsigned char* stage,
                                              int n, const Geo& g,
                                              int rows_valid, int vk) {
  const int nbytes = vk * static_cast<int>(sizeof(T));
  const int unit = g.mode_x <= 2 ? 4 : g.mode_x;
  const int units = g.mode_x <= 2 ? g.k4 * static_cast<int>(sizeof(T)) / 4
                                  : nbytes / g.mode_x;
  const Grid2 w(units);
  unsigned bits = 0;
  if (w.r0 >= w.rstep) return 0;
  for (int s = 0; s < n; ++s) {
    const unsigned char* x = stage + s * g.step_bytes + g.w_bytes;
    bool nz = false;
    for (int r = w.r0; r < rows_valid; r += w.rstep) {
      for (int u = w.u0; u < units; u += w.ustep) {
        const unsigned char* p = x + r * g.xs_stride + u * unit;
        for (int b = 0; b < unit; b += 4) {
          const unsigned w = *reinterpret_cast<const unsigned*>(p + b);
          nz |= sizeof(T) == 4 ? __uint_as_float(w) != 0.f : w != 0u;
        }
      }
    }
    if (nz) bits |= 1u << s;
  }
  return bits;
}

// acc[i][c] += x[row i] . w[:, col c] over one staged f32 step.
template <int RT>
__device__ __forceinline__ void mac_f32(float (&acc)[RT][4],
                                        const unsigned char* step,
                                        const Geo& g, int rg, int cg) {
  const float* ws = reinterpret_cast<const float*>(step);
  const float* xs = reinterpret_cast<const float*>(step + g.w_bytes);
  const int wst = g.ws_stride / 4;
  const int xst = g.xs_stride / 4;
  for (int kq = 0; kq < g.k4; kq += 4) {
    float4 a[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      a[i] = *reinterpret_cast<const float4*>(xs + (rg + g.rgn * i) * xst +
                                              kq);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b =
          *reinterpret_cast<const float4*>(ws + (kq + kk) * wst + 4 * cg);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float v = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                        : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(v, b.x, acc[i][0]);
        acc[i][1] = fmaf(v, b.y, acc[i][1]);
        acc[i][2] = fmaf(v, b.z, acc[i][2]);
        acc[i][3] = fmaf(v, b.w, acc[i][3]);
      }
    }
  }
}

// part[i][c] += x[row i] . w[:, col c] over one staged int8 step, exact
// in int32.  A weight word holds 4 columns of one k; four of them (k =
// 4q .. 4q+3) are transposed into 4 words of one column each.
template <int RT>
__device__ __forceinline__ void mac_int8(int (&part)[RT][4],
                                         const unsigned char* step,
                                         const Geo& g, int rg, int cg) {
  const unsigned char* ws = step + 4 * cg;
  const int* xs = reinterpret_cast<const int*>(step + g.w_bytes);
  const int wst = g.ws_stride;
  const int xst = g.xs_stride / 4;
  for (int q = 0; q < g.k4 / 4; ++q) {
    const unsigned char* wr = ws + 4 * q * wst;
    const unsigned w0 = *reinterpret_cast<const unsigned*>(wr);
    const unsigned w1 = *reinterpret_cast<const unsigned*>(wr + wst);
    const unsigned w2 = *reinterpret_cast<const unsigned*>(wr + 2 * wst);
    const unsigned w3 = *reinterpret_cast<const unsigned*>(wr + 3 * wst);
    const unsigned lo01 = __byte_perm(w0, w1, 0x5140);
    const unsigned hi01 = __byte_perm(w0, w1, 0x7362);
    const unsigned lo23 = __byte_perm(w2, w3, 0x5140);
    const unsigned hi23 = __byte_perm(w2, w3, 0x7362);
    const int b[4] = {static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                      static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                      static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                      static_cast<int>(__byte_perm(hi01, hi23, 0x7632))};
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int a = xs[(rg + g.rgn * i) * xst + q];
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][c] = __dp4a(a, b[c], part[i][c]);
    }
  }
}

// out[row, col] = relu?(v * scale + bias + residual) for 4 columns, in
// f32 or (out_bf16) rounded to bf16.
__device__ __forceinline__ void store4(const float (&v)[4], void* out,
                                       long long row, int n, int col,
                                       int ncols, const float* scale,
                                       const float* bias,
                                       const float* residual, int relu,
                                       int vec, int out_bf16) {
  const long long o = row * n + col;
  if (vec) {
    float4 r = make_float4(v[0], v[1], v[2], v[3]);
    if (scale) {
      const float4 s = *reinterpret_cast<const float4*>(scale + col);
      r.x *= s.x; r.y *= s.y; r.z *= s.z; r.w *= s.w;
    }
    if (bias) {
      const float4 b = *reinterpret_cast<const float4*>(bias + col);
      r.x += b.x; r.y += b.y; r.z += b.z; r.w += b.w;
    }
    if (residual) {
      const float4 d = *reinterpret_cast<const float4*>(residual + o);
      r.x += d.x; r.y += d.y; r.z += d.z; r.w += d.w;
    }
    if (relu) {  // NaN passes through, as in max(v, 0)
      if (r.x < 0.f) r.x = 0.f;
      if (r.y < 0.f) r.y = 0.f;
      if (r.z < 0.f) r.z = 0.f;
      if (r.w < 0.f) r.w = 0.f;
    }
    if (out_bf16) {
      __nv_bfloat162* ob = static_cast<__nv_bfloat162*>(out) + o / 2;
      ob[0] = __floats2bfloat162_rn(r.x, r.y);
      ob[1] = __floats2bfloat162_rn(r.z, r.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = r;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= ncols) break;
    float r = v[c];
    if (scale) r = r * scale[col + c];
    if (bias) r = r + bias[col + c];
    if (residual) r = r + residual[o + c];
    if (relu && r < 0.f) r = 0.f;
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[o + c] = __float2bfloat16_rn(r);
    } else {
      static_cast<float*>(out)[o + c] = r;
    }
  }
}

// Phase 1 for element type T: float (SPLIT unused: the epilogue or the
// workspace is picked at run time) or int8_t (SPLIT: exact T_c and A_c
// instead of the f32 accumulator).
template <class T, int RT, bool SPLIT>
__device__ __forceinline__ void vsmm_body(
    const T* __restrict__ x, const T* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    void* __restrict__ out, void* __restrict__ work, int m, int k, int nb,
    int s_steps, int vk, int vn, int relu, int skip, int splits,
    const Geo& g) {
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char vsmm_smem[];
  __shared__ unsigned vote[3];
  const int j = blockIdx.y;
  const int chunk = blockIdx.z;
  const int s0 = static_cast<int>(static_cast<long long>(s_steps) * chunk /
                                  splits);
  const int s1 = static_cast<int>(static_cast<long long>(s_steps) *
                                  (chunk + 1) / splits);
  const int n_stages = (s1 - s0 + g.group - 1) / g.group;  // a row tile's
  // This block's row tiles: blockIdx.x, + gridDim.x, ...  Their stages form
  // one sequence q = tile * n_stages + stage through the ring, so a tile's
  // first copies fly while the tile before it is multiplied and stored.
  const int row_tiles = (m + g.rows - 1) / g.rows;
  const int n_tiles =
      (row_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = n_tiles * n_stages;
  auto row0_of = [&](int t) {
    return (static_cast<long long>(blockIdx.x) + static_cast<long long>(t) *
            gridDim.x) * g.rows;
  };
  auto valid_of = [&](long long row0) {
    return static_cast<int>(min(static_cast<long long>(g.rows), m - row0));
  };
  const int cg = threadIdx.x % g.cgn;
  const int rg = threadIdx.x / g.cgn;
  const bool active = rg < g.rgn;

  auto stage_of = [&](int q) {
    return vsmm_smem + (q % g.ring) * g.group * g.step_bytes;
  };
  auto issue = [&](int q) {  // the copies of stage q, one commit group
    if (q < total) {
      const int t = q / n_stages;
      const long long row0 = row0_of(t);
      const int rows_valid = valid_of(row0);
      unsigned char* buf = stage_of(q);
      const int a = s0 + (q - t * n_stages) * g.group;
      const int b = min(s1, a + g.group);
      for (int s = a; s < b; ++s) {
        unsigned char* slot = buf + (s - a) * g.step_bytes;
        const long long tile = static_cast<long long>(j) * s_steps + s;
        const T* w = vals + tile * vk * vn;
        stage_rows(slot, g.ws_stride, g.k4, vk, vn * static_cast<int>(
                   sizeof(T)), g.ws_stride, g.mode_w, [&](int r) {
                     return reinterpret_cast<const unsigned char*>(
                         w + static_cast<long long>(r) * vn);
                   }, vals);
        const T* xc = x + row0 * k + static_cast<long long>(idx[tile]) * vk;
        stage_rows(slot + g.w_bytes, g.xs_stride, g.rows, rows_valid,
                   vk * static_cast<int>(sizeof(T)),
                   g.k4 * static_cast<int>(sizeof(T)), g.mode_x, [&](int r) {
                     return reinterpret_cast<const unsigned char*>(
                         xc + static_cast<long long>(r) * k);
                   }, x);
      }
    }
    vs::cp_async_commit();
  };

  float acc[RT][4] = {};
  int tsum[RT][4] = {};  // int8 SPLIT: T_c; int8 !SPLIT: a step's partial
  int amax[RT][4] = {};  // int8 SPLIT: A_c
  const int n_total = nb * vn;
  const long long mn = static_cast<long long>(m) * n_total;
  // The row tile's result: the epilogue, or (splits > 1) the chunk's
  // partial for phase 2; then the accumulators start again.
  auto finish = [&](long long row0, int rows_valid) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + g.rgn * i;
      if (r < rows_valid) {
        const long long row = row0 + r;
        const int cl = 4 * cg;
        const int ncols = min(4, vn - cl);
        const int col = j * vn + cl;
        const long long o = row * n_total + col;
        if (splits > 1) {
          if constexpr (kInt8 && SPLIT) {
            int2* w2 = static_cast<int2*>(work) + chunk * mn + o;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c < ncols) w2[c] = make_int2(tsum[i][c], amax[i][c]);
            }
          } else {
            float* wf = static_cast<float*>(work) + chunk * mn + o;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c < ncols) wf[c] = acc[i][c];
            }
          }
        } else {
          store4(acc[i], out, row, n_total, col, ncols, scale, bias,
                 residual, relu, g.vec_out, g.out_bf16);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][c] = 0.f;
        tsum[i][c] = 0;
        amax[i][c] = 0;
      }
    }
  };

  if (threadIdx.x < 3) vote[threadIdx.x] = 0;
  __syncthreads();  // the vote words are zero
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < total; ++q) {
    const int t = q / n_stages;
    const int st = q - t * n_stages;
    const long long row0 = row0_of(t);
    const int rows_valid = valid_of(row0);
    vs::cp_async_wait<kStages - 2>();  // this thread's copies of stage q
    const unsigned char* stage = stage_of(q);
    const int a = s0 + st * g.group;
    const int n = min(s1, a + g.group) - a;
    if (skip) {  // vote[q % 3]: read after this barrier, zeroed after the
                 // next one, written again two stages later
      unsigned bits = own_votes<T>(stage, n, g, rows_valid, vk);
      bits = __reduce_or_sync(0xffffffffu, bits);
      if ((threadIdx.x & 31) == 0 && bits) atomicOr(&vote[q % 3], bits);
    }
    __syncthreads();  // stage q and its vote landed; stage q-1's MAC done
    const unsigned live = skip ? vote[q % 3] : ~0u;
    if (threadIdx.x == 0) vote[(q + 2) % 3] = 0;  // stage q-1's
    issue(q + kStages - 1);  // into stage q-1's buffer (a no-op where the
                             // ring holds every stage of the block)
    if (!active) continue;
    for (int s = 0; s < n; ++s) {
      if (!((live >> s) & 1)) continue;  // block-uniform
      const unsigned char* step = stage + s * g.step_bytes;
      if constexpr (!kInt8) {
        mac_f32<RT>(acc, step, g, rg, cg);
      } else if constexpr (SPLIT) {
        mac_int8<RT>(tsum, step, g, rg, cg);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            amax[i][c] = max(amax[i][c], abs(tsum[i][c]));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) tsum[i][c] = 0;
        }
        mac_int8<RT>(tsum, step, g, rg, cg);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][c] += static_cast<float>(tsum[i][c]);  // stored order
          }
        }
      }
    }
    if (st == n_stages - 1) finish(row0, rows_valid);
  }
  vs::cp_async_wait<0>();  // only empty groups are left
  if (n_stages == 0 && active) {  // no stored step: the epilogue of zeros
    for (int t = 0; t < n_tiles; ++t) finish(row0_of(t), valid_of(row0_of(t)));
  }
}

#define VSMM_PARAMS(T)                                                      \
  const T *__restrict__ x, const T *__restrict__ vals,                      \
      const int *__restrict__ idx, const float *__restrict__ scale,         \
      const float *__restrict__ bias, const float *__restrict__ residual,   \
      void *__restrict__ out, void *__restrict__ work, int m, int k,        \
      int nb, int s_steps, int vk, int vn, int relu, int skip, int splits
#define VSMM_ARGS                                                         \
  x, vals, idx, scale, bias, residual, out, work, m, k, nb, s_steps, vk,  \
      vn, relu, skip, splits

// The phase-1 kernels ask ptxas for 2 blocks of kMaxThreads an SM at RT 8
// (up to 128 registers a thread) and 3 below (up to 85): without a bound
// it picked 64 registers for the int8 RT-4 split kernel and spilled; with
// 1 it gave RT 2 and 4 more registers than they need, and fewer blocks an
// SM.
template <int RT>
__global__ void __launch_bounds__(kMaxThreads, RT == 8 ? 2 : 3)
    vsmm_kernel(VSMM_PARAMS(float), Geo g) {
  vsmm_body<float, RT, false>(VSMM_ARGS, g);
}

template <int RT, bool SPLIT>
__global__ void __launch_bounds__(kMaxThreads, RT == 8 ? 2 : 3)
    vsmm_int8_kernel(VSMM_PARAMS(int8_t), Geo g) {
  vsmm_body<int8_t, RT, SPLIT>(VSMM_ARGS, g);
}

// Phase 2, f32 and bf16: the chunks' f32 partials summed in chunk order,
// epilogue.
__global__ void __launch_bounds__(256)
    vsmm_reduce_kernel(const float* __restrict__ work,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ residual,
                       void* __restrict__ out, long long mn, int n,
                       int splits, int relu, int out_bf16) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= mn) return;
  float v = work[e];
  for (int c = 1; c < splits; ++c) v += work[c * mn + e];
  const float r[4] = {v, 0.f, 0.f, 0.f};
  store4(r, out, e / n, n, static_cast<int>(e % n), 1, scale, bias,
         residual, relu, 0, out_bf16);
}

// Phase 2, int8: the chunks' exact sums walked in chunk order with an
// exact base; where a chunk's prefix sums may pass 2^24 on top of it, the
// element is recomputed serially in stored order (the reference's adds).
__global__ void __launch_bounds__(256)
    vsmm_int8_reduce_kernel(const int2* __restrict__ work,
                            const int8_t* __restrict__ x,
                            const int8_t* __restrict__ vals,
                            const int* __restrict__ idx,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            const float* __restrict__ residual,
                            void* __restrict__ out, long long mn, int k,
                            int nb, int s_steps, int vk, int vn, int splits,
                            int relu, int out_bf16) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= mn) return;
  const int n = nb * vn;
  const long long row = e / n;
  const int col = static_cast<int>(e - row * n);
  long long base = 0;
  bool exact = true;
  for (int c = 0; c < splits; ++c) {
    const int2 t = work[c * mn + e];
    exact = exact && (base < 0 ? -base : base) + t.y <= kExact;
    base += t.x;
  }
  float v = static_cast<float>(base);
  if (!exact) {
    const int j = col / vn;
    const int cl = col - j * vn;
    v = 0.f;
    for (int s = 0; s < s_steps; ++s) {
      const long long tile = static_cast<long long>(j) * s_steps + s;
      const int8_t* xr = x + row * k + static_cast<long long>(idx[tile]) * vk;
      const int8_t* w = vals + tile * vk * vn + cl;
      int p = 0;
      for (int q = 0; q < vk; ++q) p += xr[q] * w[static_cast<long long>(q) * vn];
      v += static_cast<float>(p);
    }
  }
  const float r[4] = {v, 0.f, 0.f, 0.f};
  store4(r, out, row, n, col, 1, scale, bias, residual, relu, 0, out_bf16);
}

inline bool aligned(const void* p, int to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// Copy unit for `rows` rows of `nbytes` bytes, `pitch` bytes apart, from
// base p: 16 or 4 bytes by cp.async where everything is aligned to it, 2
// (2-byte loads) where that is, 1 (byte loads) otherwise.
inline int copy_mode(const void* p, long long nbytes, long long pitch) {
  for (int unit : {16, 4, 2}) {
    if (nbytes % unit == 0 && pitch % unit == 0 && aligned(p, unit)) {
      return unit;
    }
  }
  return 1;
}

template <class T, class Kernel>
int launch_phase1(Kernel kernel, const Geo& g, int grid_x,
                  cudaStream_t stream, VSMM_PARAMS(T)) {
  const size_t smem = smem_bytes(g);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(grid_x, nb, splits);
  kernel<<<grid, g.threads, smem, stream>>>(VSMM_ARGS, g);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_vsmm(void* stream_ptr, VSMM_PARAMS(T), int rows, int out_bf16) {
  constexpr bool kInt8 = sizeof(T) == 1;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((rows != 8 && rows != 32 && rows != 64 && rows != 128) ||
      (rows == 128 && vn > 64) || vn < 1 || vn > 128 || vk < 1 ||
      splits < 1 || splits > (s_steps > 1 ? s_steps : 1) ||
      (splits > 1 && work == nullptr) ||
      (kInt8 && splits > 1 &&
       (rows > 32 || 128LL * 128 * vk * s_steps >= (1LL << 31)))) {
    return bad;
  }
  const int esize = static_cast<int>(sizeof(T));
  const int n = nb * vn;
  const int vec_out = n % 4 == 0 && vn % 4 == 0 && aligned(out, 16) &&
                      (!scale || aligned(scale, 16)) &&
                      (!bias || aligned(bias, 16)) &&
                      (!residual || aligned(residual, 16));
  // A strip's blocks: its share of the blocks the card holds at once (the
  // launch bound: 2 an SM at RT 8, 3 below); each walks the row tiles
  // blockIdx.x, + gridDim.x, ...
  const int rt = rows_per_thread(rows);
  const int row_tiles = (m + rows - 1) / rows;
  const int share = kSms * (rt == 8 ? 2 : 3) / (nb * splits);
  const int grid_x = share < 1 ? 1 : share < row_tiles ? share : row_tiles;
  const Geo g = make_geo(rows, vk, vn, esize, (s_steps + splits - 1) / splits,
                         (row_tiles + grid_x - 1) / grid_x,
                         copy_mode(x, 1LL * vk * esize, 1LL * k * esize),
                         copy_mode(vals, 1LL * vn * esize, 1LL * vn * esize),
                         vec_out, out_bf16 != 0);
  if (smem_bytes(g) > 227 * 1024) return bad;
  int err;
  if constexpr (kInt8) {
    if (splits > 1) {  // 8- or 32-row tiles (checked above)
      err = rt == 2 ? launch_phase1<T>(vsmm_int8_kernel<2, true>, g, grid_x, stream,
                                       VSMM_ARGS)
                    : launch_phase1<T>(vsmm_int8_kernel<4, true>, g, grid_x, stream,
                                       VSMM_ARGS);
    } else {
      err = rt == 2 ? launch_phase1<T>(vsmm_int8_kernel<2, false>, g, grid_x, stream,
                                       VSMM_ARGS)
          : rt == 4 ? launch_phase1<T>(vsmm_int8_kernel<4, false>, g, grid_x, stream,
                                       VSMM_ARGS)
                    : launch_phase1<T>(vsmm_int8_kernel<8, false>, g, grid_x, stream,
                                       VSMM_ARGS);
    }
  } else {
    err = rt == 2 ? launch_phase1<T>(vsmm_kernel<2>, g, grid_x, stream,
                                    VSMM_ARGS)
        : rt == 4 ? launch_phase1<T>(vsmm_kernel<4>, g, grid_x, stream,
                                    VSMM_ARGS)
                  : launch_phase1<T>(vsmm_kernel<8>, g, grid_x, stream,
                                    VSMM_ARGS);
  }
  if (err || splits == 1) return err;
  const long long mn = static_cast<long long>(m) * n;
  const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
  if constexpr (kInt8) {
    vsmm_int8_reduce_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const int2*>(work), x, vals, idx, scale, bias, residual,
        out, mn, k, nb, s_steps, vk, vn, splits, relu, out_bf16 != 0);
  } else {
    vsmm_reduce_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(work), scale, bias, residual, out, mn, n,
        splits, relu, out_bf16 != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 branch: mma.sync on the tensor cores (see the header).  What a
// step costs is instructions: 16 to 20 warps share an SM's 4 schedulers,
// so the loop computes no division, walks its copy grids incrementally,
// and dispatches a copy unit once a stage, not once a copy.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMaxRing = 8;                      // bf16 ring stages, at most
constexpr int kIdRing = 16;                      // idx slots: 2 kMaxRing
constexpr int kSmemSm = 228 * 1024;              // an SM's shared memory
constexpr int kSmemBlock = 227 * 1024 - 256;     // a block's, at most (and
                                                 // the votes)
constexpr int kSmemReserved = 1024;              // the system's, a block

// Threads and blocks an SM of the two tilings, as many blocks as the
// registers allow without spilling: decode (rows <= 32) 4 warps, 5 blocks
// an SM at 8 rows (the served batch), 4 at 16, 3 at 32; prefill 8 warps,
// 2 blocks an SM.
__host__ __device__ constexpr int bf16_threads(int rows) {
  return rows <= 32 ? 128 : 256;
}
__host__ __device__ constexpr int bf16_blocks_sm(int rows) {
  return rows == 8 ? 5 : rows == 16 ? 4 : rows == 32 ? 3 : 2;
}

// The bf16 launch geometry: a pure function of the shapes, the plan and
// the operands' alignment (the copy modes).
struct BGeo {
  int rows;         // row tile: 8, 16, 32 (decode) or 64 (prefill)
  int row_tiles;    // ceil(m / rows)
  int items;        // row_tiles * nb * splits: (row tile, strip, chunk)s
  int kp, np;       // vk and vn rounded up to 16 (the mma's sides)
  int ws, xs;       // bytes between staged W rows, activation rows
  int w_bytes;      // a staged W tile: kp rows of ws
  int x_bytes;      // a staged x tile: rows of xs
  int rs;           // mode_x 2: bytes a raw x row (16-byte units over vk)
  int step_bytes;   // a stage: W tile, x tile (mode_x 2: and its raw rows)
  int ring;         // stages
  int mode_w;       // W copy units: 16, 8 or 4 bytes (cp.async); 2: loads
  int mode_x;       // x copy units: 16, 8 or 4 (cp.async) into the x tile;
                    // 2 (rows 2-byte aligned): the 16-byte units spanning
                    // each row into raw rows, shifted into the x tile
  int out_bf16;     // 1: the output is bf16
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: vs::cp_async_wait<0>(); break;
    case 1: vs::cp_async_wait<1>(); break;
    case 2: vs::cp_async_wait<2>(); break;
    case 3: vs::cp_async_wait<3>(); break;
    case 4: vs::cp_async_wait<4>(); break;
    case 5: vs::cp_async_wait<5>(); break;
    default: vs::cp_async_wait<6>(); break;  // kMaxRing - 2
  }
}

// 16 bytes from src into shared memory at dst, of which the first n (0 to
// 16) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// A block's place in its sequence of stored steps: item (row tile rt,
// strip j, chunk) and step s of [.., s1).
struct Cur {
  int item, rt, j, chunk, s, s1;
};

// (s_steps * splits < 2^32, which the launch checks: the chunk bounds in
// 32 bits, a 64-bit division being a call to a long routine)
__device__ __forceinline__ void enter(Cur& c, int item, const BGeo& g,
                                      int s_steps, int splits) {
  c.item = item;
  if (item >= g.items) return;
  c.rt = item % g.row_tiles;
  const int js = item / g.row_tiles;
  c.chunk = js % splits;
  c.j = js / splits;
  const unsigned s = static_cast<unsigned>(s_steps);
  c.s = static_cast<int>(s * c.chunk / splits);
  c.s1 = static_cast<int>(s * (c.chunk + 1) / splits);
}

// A thread's share of a (rows x units) copy grid: units e = tid, tid +
// threads, ..., unit e being (row e / units, e % units), walked without a
// division (the loop's instructions are the step's cost: 16 to 20 warps
// share an SM's 4 schedulers).
struct Walk {
  int n, r, u, dr, du;
  __device__ __forceinline__ Walk(int rows, int units, int threads, int t)
      : n(rows * units), r(t / units), u(t - (t / units) * units),
        dr(threads / units), du(threads - (threads / units) * units) {}
};

// Phase 1 of the bf16 branch, one block: its items (row tile, strip,
// chunk) blockIdx.x, + gridDim.x, ... as one sequence of stored steps.
// Every method is forced inline, so that the accumulators, the cursors
// and the copy grids stay in registers.
template <int ROWS>
struct Bf16Body {
  static constexpr bool kDec = ROWS <= 32;
  static constexpr int kThreads = bf16_threads(ROWS);
  static constexpr int kWarps = kThreads / 32;
  // Prefill: warps along rows (32 each) and columns; n16 chunks a warp.
  static constexpr int kWm = kDec ? 1 : ROWS / 32;
  static constexpr int kWn = kWarps / kWm;
  static constexpr int kNc = 8 / kWn;
  // Accumulator tiles a thread, acc[i][a]: decode, m16 tile warp + 4i of
  // the columns x n8 tile a of the rows; prefill, m16 tile i of the warp's
  // rows x n8 tile a of its columns.
  static constexpr int kAn = kDec ? ROWS / 8 : 2 * kNc;

  const bf16* __restrict__ x;
  const bf16* __restrict__ vals;
  const int* __restrict__ idx;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* __restrict__ residual;
  void* __restrict__ out;
  void* __restrict__ work;
  const int m, k, nb, s_steps, vk, vn, relu, skip, splits;
  const BGeo g;
  unsigned char* const smem;
  // idx of the block's step q (stage q's x tile) in id_ring[q % kIdRing],
  // copied there by cp.async with the copies of step q - ring
  int* const id_ring;
  const int tid, warp, lane, ring;
  const int uw, ux;  // copy units a W row, an x row (or a raw x row)
  const Walk gw, gx;  // the W and x copy grids
  const long long mn;
  Cur ic;  // the step whose idx the next issue copies: ring steps ahead
  float acc[2][kAn][4];

  __device__ __forceinline__ Bf16Body(VSMM_PARAMS(bf16), BGeo geo,
                                      unsigned char* sm, int* ids)
      : x(x), vals(vals), idx(idx), scale(scale), bias(bias),
        residual(residual), out(out), work(work), m(m), k(k), nb(nb),
        s_steps(s_steps), vk(vk), vn(vn), relu(relu), skip(skip),
        splits(splits), g(geo), smem(sm), id_ring(ids),
        tid(threadIdx.x), warp(threadIdx.x >> 5), lane(threadIdx.x & 31),
        ring(geo.ring),
        uw(geo.mode_w == 2 ? 1 : vn * 2 / geo.mode_w),
        ux(geo.mode_x == 2 ? geo.rs / 16 : vk * 2 / geo.mode_x),
        gw(vk, uw, bf16_threads(ROWS), threadIdx.x),
        gx(ROWS, ux, bf16_threads(ROWS), threadIdx.x),
        mn(static_cast<long long>(m) * nb * vn) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int a = 0; a < kAn; ++a) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][a][e] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void next(Cur& c) const {
    if (++c.s >= c.s1) enter(c, c.item + gridDim.x, g, s_steps, splits);
  }

  // out[r, col of strip j] (or the chunk's partial) for columns col ..
  // col + n - 1 (n 1 or 2), those past vn and rows past m left out
  __device__ __forceinline__ void put(const Cur& c, float v0, float v1,
                                      long long r, int col, int n) const {
    if (r >= m || col >= vn) return;
    const int gc = c.j * vn + col;
    const int nc = min(n, vn - col);
    if (splits > 1) {
      float* w = static_cast<float*>(work) + c.chunk * mn + r * nb * vn + gc;
      w[0] = v0;
      if (nc > 1) w[1] = v1;
      return;
    }
    const float v[4] = {v0, v1, 0.f, 0.f};
    store4(v, out, r, nb * vn, gc, nc, scale, bias, residual, relu, 0,
           g.out_bf16);
  }

  // The item's result from the accumulators (fragment rows lane / 4 and
  // + 8, columns 2 * (lane % 4) and + 1), then the accumulators restart.
  __device__ __forceinline__ void finish(const Cur& c) {
    const long long row0 = static_cast<long long>(c.rt) * ROWS;
    const int g4 = lane >> 2;
    const int t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int a = 0; a < kAn; ++a) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = acc[i][a][2 * h];
          const float v1 = acc[i][a][2 * h + 1];
          if constexpr (kDec) {  // D = W^T x^T: its rows are columns
            const int col = (warp + 4 * i) * 16 + g4 + 8 * h;
            const long long r = row0 + a * 8 + 2 * t4;
            put(c, v0, 0.f, r, col, 1);
            put(c, v1, 0.f, r + 1, col, 1);
          } else {
            const long long r =
                row0 + (warp / kWn) * 32 + i * 16 + g4 + 8 * h;
            const int col =
                ((warp % kWn) * kNc + a / 2) * 16 + (a & 1) * 8 + 2 * t4;
            put(c, v0, v1, r, col, 2);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][a][e] = 0.f;
      }
    }
  }

  template <int U>
  __device__ __forceinline__ static void cp_async_u(void* d, const void* src,
                                                    bool ok) {
    if constexpr (U == 16) {
      vs::cp_async16(d, src, ok);
    } else if constexpr (U == 8) {
      vs::cp_async8(d, src, ok);
    } else {
      vs::cp_async4(d, src, ok);
    }
  }

  // The W tile's vk rows of vn values into rows ws bytes apart, U bytes a
  // copy.
  template <int U>
  __device__ __forceinline__ void stage_w_u(unsigned char* st,
                                            const unsigned char* w) const {
    int r = gw.r, u = gw.u;
    for (int e = tid; e < gw.n; e += kThreads) {
      cp_async_u<U>(st + r * g.ws + u * U, w + r * (vn * 2) + u * U, true);
      r += gw.dr;
      u += gw.du;
      if (u >= uw) {
        u -= uw;
        ++r;
      }
    }
  }

  __device__ __forceinline__ void stage_w(unsigned char* st,
                                          long long tile) const {
    const unsigned char* w =
        reinterpret_cast<const unsigned char*>(vals + tile * vk * vn);
    if (g.mode_w == 16) {
      stage_w_u<16>(st, w);
    } else if (g.mode_w == 8) {
      stage_w_u<8>(st, w);
    } else if (g.mode_w == 4) {
      stage_w_u<4>(st, w);
    } else {  // an odd vn: 2-byte loads (off the model paths)
      const unsigned short* w2 = reinterpret_cast<const unsigned short*>(w);
      for (int e = tid; e < vk * vn; e += kThreads) {
        const int r = e / vn;
        *reinterpret_cast<unsigned short*>(st + r * g.ws + (e - r * vn) * 2) =
            w2[e];
      }
    }
  }

  // The x tile's ROWS rows of vk values (zeros past m) into rows xs bytes
  // apart, U bytes a copy.
  template <int U>
  __device__ __forceinline__ void stage_x_u(unsigned char* st,
                                            const unsigned char* xt,
                                            int valid) const {
    int r = gx.r, u = gx.u;
    for (int e = tid; e < gx.n; e += kThreads) {
      const bool ok = r < valid;
      cp_async_u<U>(st + g.w_bytes + r * g.xs + u * U,
                    ok ? static_cast<const void*>(
                             xt + static_cast<long long>(r) * k * 2 + u * U)
                       : static_cast<const void*>(x),
                    ok);
      r += gx.dr;
      u += gx.du;
      if (u >= ux) {
        u -= ux;
        ++r;
      }
    }
  }

  // mode_x 2: the 16-byte units spanning each row, read up to x's end,
  // zeros past it and for rows past m.
  __device__ __forceinline__ void stage_x_span(unsigned char* st,
                                               const unsigned char* xt,
                                               int valid) const {
    const unsigned char* xend = reinterpret_cast<const unsigned char*>(
        x + static_cast<long long>(m) * k);
    int r = gx.r, u = gx.u;
    for (int e = tid; e < gx.n; e += kThreads) {
      const unsigned char* row = xt + static_cast<long long>(r) * k * 2;
      const unsigned char* src =
          row - (reinterpret_cast<uintptr_t>(row) & 15) + 16 * u;
      const long long left = r < valid ? xend - src : 0;
      const int n = left >= 16 ? 16 : left > 0 ? static_cast<int>(left) : 0;
      cp_async16_n(st + g.w_bytes + g.x_bytes + r * g.rs + 16 * u,
                   n ? static_cast<const void*>(src)
                     : static_cast<const void*>(x), n);
      r += gx.dr;
      u += gx.du;
      if (u >= ux) {
        u -= ux;
        ++r;
      }
    }
  }

  __device__ __forceinline__ void stage_x(unsigned char* st, const bf16* xt,
                                          int valid) const {
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(xt);
    if (g.mode_x == 16) {
      stage_x_u<16>(st, xb, valid);
    } else if (g.mode_x == 8) {
      stage_x_u<8>(st, xb, valid);
    } else if (g.mode_x == 4) {
      stage_x_u<4>(st, xb, valid);
    } else {
      stage_x_span(st, xb, valid);
    }
  }

  // cp.async modes: whether an x word this thread copied (complete after
  // its own wait) is nonzero; a bf16 -0 is zero, as in the reference's
  // x != 0, and a NaN is not.
  template <int U>
  __device__ __forceinline__ bool own_vote_u(const unsigned char* st) const {
    unsigned nz = 0;
    int r = gx.r, u = gx.u;
    for (int e = tid; e < gx.n; e += kThreads) {
      const unsigned* p = reinterpret_cast<const unsigned*>(
          st + g.w_bytes + r * g.xs + u * U);
#pragma unroll
      for (int b = 0; b < U / 4; ++b) nz |= p[b];
      r += gx.dr;
      u += gx.du;
      if (u >= ux) {
        u -= ux;
        ++r;
      }
    }
    return (nz & 0x7FFF7FFFu) != 0u;
  }

  __device__ __forceinline__ bool own_vote(const unsigned char* st) const {
    return g.mode_x == 16 ? own_vote_u<16>(st)
         : g.mode_x == 8 ? own_vote_u<8>(st) : own_vote_u<4>(st);
  }

  // mode_x 2, once the barrier has published a stage's raw rows: each x
  // row's vk values shifted from its raw row (its start's offset in its
  // first 16-byte unit, in elements) into the x tile, zeros past vk; and
  // whether a value this thread moved is nonzero.
  __device__ __forceinline__ bool realign(unsigned char* st, const Cur& c,
                                          int id) const {
    const unsigned* raw =
        reinterpret_cast<const unsigned*>(st + g.w_bytes + g.x_bytes);
    unsigned* xa = reinterpret_cast<unsigned*>(st + g.w_bytes);
    const int kw = g.kp / 2;
    const long long e0 =
        static_cast<long long>(reinterpret_cast<uintptr_t>(x) / 2) +
        static_cast<long long>(c.rt) * ROWS * k +
        static_cast<long long>(id) * vk;
    const Walk gr(ROWS, kw, kThreads, tid);
    unsigned nz = 0;
    int r = gr.r, w = gr.u;
    for (int e = tid; e < gr.n; e += kThreads) {
      const int c2 = 2 * w;
      unsigned v = 0;
      if (c2 < vk) {
        const int sh =
            static_cast<int>((e0 + static_cast<long long>(r) * k) & 7) + c2;
        const unsigned* rw = raw + r * (g.rs / 4) + (sh >> 1);
        v = rw[0];
        if (sh & 1) v = (v >> 16) | (c2 + 1 < vk ? rw[1] << 16 : 0u);
        if (c2 + 1 >= vk) v &= 0xFFFFu;
      }
      xa[r * (g.xs / 4) + w] = v;
      nz |= v;
      r += gr.dr;
      w += gr.du;
      if (w >= kw) {
        w -= kw;
        ++r;
      }
    }
    return (nz & 0x7FFF7FFFu) != 0u;
  }

  // The copies of step q (at c) into `slot`, and of the idx of step q +
  // ring (at ic) into id_ring, one commit group.
  __device__ __forceinline__ void issue(const Cur& c, int q, int slot) {
    if (c.item < g.items) {
      unsigned char* st = smem + slot * g.step_bytes;
      stage_w(st, static_cast<long long>(c.j) * s_steps + c.s);
      const long long row0 = static_cast<long long>(c.rt) * ROWS;
      const int valid = static_cast<int>(min(static_cast<long long>(ROWS),
                                             m - row0));
      stage_x(st, x + row0 * k +
                      static_cast<long long>(id_ring[q & (kIdRing - 1)]) * vk,
              valid);
    }
    if (tid == 0 && ic.item < g.items) {
      vs::cp_async4(&id_ring[(q + ring) & (kIdRing - 1)],
                    idx + static_cast<long long>(ic.j) * s_steps + ic.s,
                    true);
    }
    next(ic);
    vs::cp_async_commit();
  }

  // acc += x tile . W tile over the k16 slices kg .. kg + H - 1: a fresh
  // mma chain added to acc in f32, so that the tensor cores' own rounding
  // spans at most 32 products and the sum over the steps is f32, in
  // stored order, as the reference's acc += dot(x, w).
  template <int H>
  __device__ __forceinline__ void mac_k(const unsigned char* ws,
                                        const unsigned char* xs, int kg) {
    if constexpr (kDec) {
      // B = x^T (k x rows): the x rows as the col-major operand
      unsigned b[H][kAn][2];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int kc = (kg + h) * 16 + ((lane >> 3) & 1) * 8;
        if constexpr (kAn == 1) {
          unsigned r[2];
          ldsm_x2(r, xs + (lane & 7) * g.xs + kc * 2);
          b[h][0][0] = r[0];
          b[h][0][1] = r[1];
        } else {
#pragma unroll
          for (int p = 0; p < kAn / 2; ++p) {
            unsigned r[4];
            ldsm_x4(r, xs + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * g.xs +
                           kc * 2);
            b[h][2 * p][0] = r[0];
            b[h][2 * p][1] = r[1];
            b[h][2 * p + 1][0] = r[2];
            b[h][2 * p + 1][1] = r[3];
          }
        }
      }
      // A = W^T (columns x k): the (k, vn) tile through ldmatrix.trans
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mt = warp + 4 * i;
        if (mt * 16 >= g.np) continue;
        unsigned a[H][4];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          ldsm_x4_t(a[h], ws + ((kg + h) * 16 + (lane >> 4) * 8 +
                                (lane & 7)) * g.ws +
                              (mt * 16 + ((lane >> 3) & 1) * 8) * 2);
        }
#pragma unroll
        for (int nt = 0; nt < kAn; ++nt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < H; ++h) {
            mma_bf16(d, a[h], b[h][nt][0], b[h][nt][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] += d[e];
        }
      }
    } else {
      const int wm = warp / kWn;
      const int wn = warp - wm * kWn;
      // A = the x tile (rows x k), row-major
      unsigned a[2][H][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          ldsm_x4(a[i][h], xs + (wm * 32 + i * 16 + (lane & 15)) * g.xs +
                               ((kg + h) * 16 + (lane >> 4) * 8) * 2);
        }
      }
      // B = the W tile (k x vn), row-major: ldmatrix.trans
#pragma unroll
      for (int cc = 0; cc < kNc; ++cc) {
        const int n0 = (wn * kNc + cc) * 16;
        if (n0 >= g.np) continue;
        unsigned b[H][4];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          ldsm_x4_t(b[h], ws + ((kg + h) * 16 + ((lane >> 3) & 1) * 8 +
                                (lane & 7)) * g.ws +
                              (n0 + (lane >> 4) * 8) * 2);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float d0[4] = {0.f, 0.f, 0.f, 0.f};
          float d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < H; ++h) {
            mma_bf16(d0, a[i][h], b[h][0], b[h][1]);
            mma_bf16(d1, a[i][h], b[h][2], b[h][3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][2 * cc][e] += d0[e];
            acc[i][2 * cc + 1][e] += d1[e];
          }
        }
      }
    }
  }

  __device__ __forceinline__ void mac(const unsigned char* st) {
    const int ks = g.kp / 16;
    int kg = 0;
    for (; kg + 1 < ks; kg += 2) mac_k<2>(st, st + g.w_bytes, kg);
    if (kg < ks) mac_k<1>(st, st + g.w_bytes, kg);
  }

  __device__ __forceinline__ void run() {
    if (s_steps == 0) {  // no stored tile: the epilogue of zeros
      Cur c;
      for (enter(c, blockIdx.x, g, 0, 1); c.item < g.items;
           enter(c, c.item + gridDim.x, g, 0, 1)) {
        finish(c);
      }
      return;
    }
    // Zero the ring once: the copies never write a W tile's
    // rows past vk or columns past vn, nor an x tile's columns past vk,
    // so they stay zero (a stale word there could be a NaN, and 0 x NaN
    // is NaN).  The idx of the first `ring` steps: thread t loads step t's.
    // (The loads of idx are issued first: the zeroing hides their latency.)
    Cur is;
    enter(is, blockIdx.x, g, s_steps, splits);
    int id0 = 0;
    if (tid < ring) {
      Cur c = is;
      for (int t = 0; t < tid; ++t) next(c);
      if (c.item < g.items) {
        id0 = __ldg(idx + static_cast<long long>(c.j) * s_steps + c.s);
      }
    }
    for (int o = tid * 16; o < ring * g.step_bytes; o += kThreads * 16) {
      *reinterpret_cast<uint4*>(smem + o) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid < ring) id_ring[tid] = id0;
    __syncthreads();

    // The copies of step q + ring - 1 are issued before step q's MAC, so
    // an item's first tiles fly while the item before it is multiplied
    // and stored.
    Cur cs = is;
    ic = is;
    for (int t = 0; t < ring; ++t) next(ic);
    for (int p = 0; p + 1 < ring; ++p) {
      issue(is, p, p);
      next(is);
    }
    // slot: step q's buffer (q % ring); nslot: step q + ring - 1's
    for (int q = 0, slot = 0, nslot = ring - 1; cs.item < g.items; ++q) {
      unsigned char* st = smem + slot * g.step_bytes;
      if (ring == 1) {  // the one buffer, freed by the last barrier
        issue(is, q, 0);
        next(is);
      }
      cp_async_wait_upto(ring == 1 ? 0 : ring - 2);  // this thread's copies
      // The barrier that publishes step q (and ends step q-1's MAC) also
      // ORs the block's votes: live is block-uniform.
      int voted;
      if (g.mode_x != 2) {
        voted = __syncthreads_or(skip && own_vote(st));
      } else {
        __syncthreads();  // the raw rows landed
        const bool nz = realign(st, cs, id_ring[q & (kIdRing - 1)]);
        voted = __syncthreads_or(skip && nz);  // the x tile
      }
      const bool live = !skip || voted != 0;
      if (ring > 1) {  // into step q-1's buffer
        issue(is, q + ring - 1, nslot);
        next(is);
      }
      if (live) mac(st);
      if (cs.s + 1 >= cs.s1) finish(cs);
      next(cs);
      if (ring == 1) __syncthreads();  // the MAC is done with the buffer
      nslot = slot;
      if (++slot == ring) slot = 0;
    }
    vs::cp_async_wait<0>();  // only empty groups are left
  }
};

template <int ROWS>
__global__ void __launch_bounds__(bf16_threads(ROWS), bf16_blocks_sm(ROWS))
    vsmm_bf16_kernel(VSMM_PARAMS(bf16), BGeo g) {
  extern __shared__ __align__(16) unsigned char vsmm_smem[];
  __shared__ int id_ring[kIdRing];
  Bf16Body<ROWS> body(VSMM_ARGS, g, vsmm_smem, id_ring);
  body.run();
}

// bytes rounded up to an odd multiple of 16: 8 rows that far apart start
// in 8 distinct 16-byte bank groups, so ldmatrix reads them at once.
inline int odd16(int bytes) {
  const int b = round_up(bytes, 16);
  return (b / 16) % 2 ? b : b + 16;
}

// bf16 copy unit: 16, 8 or 4 bytes by cp.async where every row is aligned
// to it, else 2 (rows 2-byte aligned: see mode_x).
inline int bf16_copy_mode(const void* p, long long nbytes, long long pitch) {
  for (int unit : {16, 8, 4}) {
    if (nbytes % unit == 0 && pitch % unit == 0 && aligned(p, unit)) {
      return unit;
    }
  }
  return 2;
}

template <int ROWS>
int launch_bf16_rows(const BGeo& g, cudaStream_t stream, VSMM_PARAMS(bf16)) {
  const int smem = g.ring * g.step_bytes;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(vsmm_bf16_kernel<ROWS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  // as many blocks as the card holds at once, at most one an item
  const int per_sm = std::max(1, std::min(bf16_blocks_sm(ROWS),
                                          kSmemSm / (smem + kSmemReserved)));
  const int grid = std::min(g.items, kSms * per_sm);
  vsmm_bf16_kernel<ROWS><<<grid, bf16_threads(ROWS), smem, stream>>>(
      VSMM_ARGS, g);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(void* stream_ptr, VSMM_PARAMS(bf16), int rows,
                int out_bf16) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((rows != 8 && rows != 16 && rows != 32 && rows != 64) ||
      vn < 1 || vn > 128 || vk < 1 || m < 1 || splits < 1 ||
      splits > (s_steps > 1 ? s_steps : 1) ||
      (splits > 1 && work == nullptr)) {
    return bad;
  }
  BGeo g;
  g.rows = rows;
  g.row_tiles = (m + rows - 1) / rows;
  const long long items = 1LL * g.row_tiles * nb * splits;
  if (items < 1 || items >= (1LL << 31) ||
      1LL * s_steps * splits >= (1LL << 32)) {
    return bad;
  }
  g.items = static_cast<int>(items);
  g.kp = round_up(vk, 16);
  g.np = round_up(vn, 16);
  g.ws = odd16(g.np * 2);
  g.xs = odd16(g.kp * 2);
  g.w_bytes = g.kp * g.ws;
  g.x_bytes = rows * g.xs;
  g.mode_w = bf16_copy_mode(vals, 2LL * vn, 2LL * vn);
  g.mode_x = bf16_copy_mode(x, 2LL * vk, 2LL * k);
  // mode_x 2: a row starts up to 7 values into its first 16-byte unit
  g.rs = g.mode_x == 2 ? (vk + 7 + 7) / 8 * 16 : 0;
  g.step_bytes = g.w_bytes + g.x_bytes + rows * g.rs;
  // stages that fit the launch bound's blocks an SM; at least 2 (fewer
  // blocks an SM) where a block can hold them, else 1
  g.ring = std::min(kMaxRing,
                    (kSmemSm / bf16_blocks_sm(rows) - kSmemReserved) /
                        g.step_bytes);
  if (g.ring < 2) g.ring = std::min(2, kSmemBlock / g.step_bytes);
  if (g.ring < 1) return bad;
  const int n = nb * vn;
  g.out_bf16 = out_bf16 != 0;
  int err;
  switch (rows) {
    case 8: err = launch_bf16_rows<8>(g, stream, VSMM_ARGS); break;
    case 16: err = launch_bf16_rows<16>(g, stream, VSMM_ARGS); break;
    case 32: err = launch_bf16_rows<32>(g, stream, VSMM_ARGS); break;
    default: err = launch_bf16_rows<64>(g, stream, VSMM_ARGS); break;
  }
  if (err || splits == 1) return err;
  const long long mn = static_cast<long long>(m) * n;
  vsmm_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                       stream>>>(static_cast<const float*>(work), scale, bias,
                                 residual, out, mn, n, splits, relu,
                                 out_bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching for a plan the kernel does not
// take.  Any of scale, bias and residual may be null.  `rows` and
// `splits` are the plan (kernels/vsmm.py::vsmm_plan); `work` is the
// workspace for splits > 1 (splits * M * N floats), else may be null.
// `skip` 0 turns the input-side skip off; `out_bf16` 1 writes a bf16
// output, 0 an f32 one.  The caller has checked shapes, dtypes and
// contiguity.
extern "C" int vsmm_launch(VSMM_PARAMS(float), int rows, int out_bf16,
                           void* stream) {
  return launch_vsmm<float>(stream, VSMM_ARGS, rows, out_bf16);
}

// The bf16 branch: x and vals bf16, scale, bias and residual f32; `work`
// as the f32 branch's (splits * M * N floats).
extern "C" int vsmm_bf16_launch(VSMM_PARAMS(__nv_bfloat16), int rows,
                                int out_bf16, void* stream) {
  return launch_bf16(stream, VSMM_ARGS, rows, out_bf16);
}

// The int8 branch: x and vals int8, scale (the combined dequant scale, a
// power of two per column) given by the caller; `work` holds splits * M *
// N int32 pairs (T_c, A_c).
extern "C" int vsmm_int8_launch(VSMM_PARAMS(int8_t), int rows, int out_bf16,
                                void* stream) {
  return launch_vsmm<int8_t>(stream, VSMM_ARGS, rows, out_bf16);
}
