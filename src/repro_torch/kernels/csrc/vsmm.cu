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
// Two branches, as the reference's `_mac_dot` has:
//   - f32: FMAs into f32 accumulators.  Phase 2 sums the chunks' partial
//     tiles in chunk order: another summation order than the reference's,
//     within the 1e-5 bound.
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
// What bounds it on an H100: at 8 rows the bytes of the stored tiles
// (VGG-16's fc1: 96.6 MB f32); at large M fp32 FMAs on the CUDA cores (no
// tensor cores: TF32 would break the 1e-5 agreement with the f32
// reference; the int8 branch uses dp4a) and the activation and output
// bytes.  The design keeps several stages of tiles in flight on every SM
// and reuses each staged weight word for RT rows and each activation word
// for 4 columns.
#include "vs_async.cuh"

#include <stdint.h>

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
  int mode_x, mode_w;  // copy units: 16 or 4 bytes (cp.async), 1 (loads)
  int vec_out;    // 1: the epilogue reads and writes float4
};

inline Geo make_geo(int rows, int vk, int vn, int esize, int max_chunk,
                    int tiles_per_block, int mode_x, int mode_w,
                    int vec_out) {
  Geo g;
  g.rows = rows;
  g.rgn = rows / rows_per_thread(rows);
  g.cgn = (vn + 3) / 4;
  g.threads = round_up(g.rgn * g.cgn, 32);
  g.k4 = round_up(vk, 4);
  // f32: rows 4 floats apart mod 32 banks (float4 reads of 8 rows hit 8
  // distinct bank quads); int8: 16 bytes past the data, rows 16-aligned.
  g.xs_stride = esize == 4 ? (g.k4 + 4) * 4 : round_up(vk, 16) + 16;
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
  return g;
}

inline size_t smem_bytes(const Geo& g) {
  return static_cast<size_t>(g.ring) * g.group * g.step_bytes;
}

// Stage `rows` rows into shared memory at dst (rows `stride` bytes apart):
// row r < valid takes `nbytes` bytes from src(r), then zeros up to
// `pbytes`; rows >= valid are zeros.  mode 16 / 4: cp.async units of that
// many bytes (nbytes a multiple of it, every src row aligned to it);
// mode 1: byte loads packed into words (any alignment), stored at once.
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
  if (mode == 1) {
    const int words = pbytes / 4;
    const Grid2 g(words);
    if (g.r0 >= g.rstep) return;  // the threads past rstep * ustep
    for (int r = g.r0; r < rows; r += g.rstep) {
      for (int q = g.u0; q < words; q += g.ustep) {
        int v = 0;
        if (r < valid) {
          const unsigned char* p = src(r) + 4 * q;
          const int n = min(4, nbytes - 4 * q);
          for (int b = 0; b < n; ++b) v |= static_cast<int>(p[b]) << (8 * b);
        }
        *reinterpret_cast<int*>(dst + r * stride + 4 * q) = v;
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
// `stage_rows` gives it) is nonzero or a NaN.  A thread reads only what
// its own copies wrote, which its cp.async wait has completed, so the
// stage's one barrier publishes the data and the vote together.
template <class T>
__device__ __forceinline__ unsigned own_votes(const unsigned char* stage,
                                              int n, const Geo& g,
                                              int rows_valid, int vk) {
  const int nbytes = vk * static_cast<int>(sizeof(T));
  const int unit = g.mode_x == 1 ? 4 : g.mode_x;
  const int units = g.mode_x == 1 ? g.k4 * static_cast<int>(sizeof(T)) / 4
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
          nz |= sizeof(T) == 4
                    ? *reinterpret_cast<const float*>(p + b) != 0.f
                    : *reinterpret_cast<const int*>(p + b) != 0;
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

// out[row, col] = relu?(v * scale + bias + residual) for 4 columns.
__device__ __forceinline__ void store4(const float (&v)[4], float* out,
                                       long long row, int n, int col,
                                       int ncols, const float* scale,
                                       const float* bias,
                                       const float* residual, int relu,
                                       int vec) {
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
    *reinterpret_cast<float4*>(out + o) = r;
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
    out[o + c] = r;
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
    float* __restrict__ out, void* __restrict__ work, int m, int k, int nb,
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
                 residual, relu, g.vec_out);
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
      float *__restrict__ out, void *__restrict__ work, int m, int k,       \
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

// Phase 2, f32: the chunks' partials summed in chunk order, epilogue.
__global__ void __launch_bounds__(256)
    vsmm_reduce_kernel(const float* __restrict__ work,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ residual,
                       float* __restrict__ out, long long mn, int n,
                       int splits, int relu) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= mn) return;
  float v = work[e];
  for (int c = 1; c < splits; ++c) v += work[c * mn + e];
  const float r[4] = {v, 0.f, 0.f, 0.f};
  store4(r, out, e / n, n, static_cast<int>(e % n), 1, scale, bias,
         residual, relu, 0);
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
                            float* __restrict__ out, long long mn, int k,
                            int nb, int s_steps, int vk, int vn, int splits,
                            int relu) {
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
  store4(r, out, row, n, col, 1, scale, bias, residual, relu, 0);
}

inline bool aligned(const void* p, int to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// Copy unit for `rows` rows of `nbytes` bytes, `pitch` bytes apart, from
// base p: 16 or 4 bytes by cp.async where everything is aligned to it, 1
// (byte loads) otherwise.
inline int copy_mode(const void* p, long long nbytes, long long pitch) {
  for (int unit : {16, 4}) {
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
int launch_vsmm(void* stream_ptr, VSMM_PARAMS(T), int rows) {
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
                         vec_out);
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
        out, mn, k, nb, s_steps, vk, vn, splits, relu);
  } else {
    vsmm_reduce_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(work), scale, bias, residual, out, mn, n,
        splits, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching for a plan the kernel does not
// take.  Any of scale, bias and residual may be null.  `rows` and
// `splits` are the plan (kernels/vsmm.py::vsmm_plan); `work` is the
// workspace for splits > 1 (splits * M * N floats), else may be null.
// `skip` 0 turns the input-side skip off.  The caller has checked shapes,
// dtypes and contiguity.
extern "C" int vsmm_launch(VSMM_PARAMS(float), int rows, void* stream) {
  return launch_vsmm<float>(stream, VSMM_ARGS, rows);
}

// The int8 branch: x and vals int8, scale (the combined dequant scale, a
// power of two per column) given by the caller; `work` holds splits * M *
// N int32 pairs (T_c, A_c).
extern "C" int vsmm_int8_launch(VSMM_PARAMS(int8_t), int rows,
                                void* stream) {
  return launch_vsmm<int8_t>(stream, VSMM_ARGS, rows);
}
