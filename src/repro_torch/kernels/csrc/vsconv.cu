// vsconv: direct vector-sparse SAME convolution over two input layouts,
// hand-written for Hopper (sm_90a).
//
//   vsconv_halo_kernel  replaces kernels/vsconv.py::vsconv_halo_pallas of
//                       the JAX package, both of its bodies (`_halo_kernel`,
//                       streaming, and `_halo_resident_kernel`, picked by
//                       `use_resident_halo`): the resident body is a TPU DMA
//                       choice and needs no second kernel here.
//   vsconv_stack_kernel replaces kernels/vsconv.py::vsconv_pallas (body
//                       `_kernel`), the conv over the row-tap stack.
//   vsconv_halo_stem_kernel, vsconv_stack_stem_kernel: the stem body of
//                       the same two kernels (below), picked by the
//                       wrappers' `use_stem_body` for narrow inputs;
//                       vsconv_{halo,stack}_stem_int8_kernel its int8
//                       twin.
//
//   out (N, Hout, Wout, NB*vn) = conv of the input with a balanced
//   block-CSR weight (kh*kw*CBg*vk, Cout): stored tiles vals (NB, S, vk,
//   vn), K-tile ids idx (NB, S); then x scale, + bias, + residual, ReLU.
//
// Grouped convs: CBg = CB / groups cin tiles per group, spg = NB / groups
// strips per group (strips group-major).  A stored id t is relative to its
// strip's group: tap = t / CBg, cin tile = (j / spg) * CBg + t % CBg, as in
// the reference's `halo_in_index_map` / `stack_in_index_map`.  groups == 1
// gives CBg = CB, spg = NB and a group base of 0.
//
// Generic body (namespace gen).  The work is cut three ways by a plan that
// the wrapper computes from the shapes alone (kernels/vsconv.py::
// conv_plan): a tile of `rows` = 64 or 128 flattened output pixels over
// N*Hout*Wout, an output strip j, and a chunk c of `splits` contiguous
// chunks of the strip's S stored steps (chunk c takes [S*c/splits,
// S*(c+1)/splits), in stored order; splits is 1 wherever the row tiles x NB
// fill the card).  Step s decodes t = idx[j, s] into tap (ky, kx) and cin
// tile; the two layouts differ only in where that tap's activation sits:
//
//   halo  xh (N, rows, bW, CB, vk), `build_halo_input`'s SAME-padded NHWC
//         input: output pixel (i, jj) reads padded pixel
//         (ky*d + stride*i, kx*d + stride*jj) — the tap is resolved in the
//         kernel, no tap-shifted copy of the input exists;
//   stack xt (N, kh*stride, Hout, bW, C), `build_row_tap_stack`'s planes:
//         output pixel (i, jj) reads plane ky*stride + (kx*d) % stride,
//         row i, column jj + (kx*d) / stride.
//
// So a step's activation tile is `rows` pixel rows of vk contiguous
// elements at pix[r] + tap(t): each pixel's base is computed once a
// block, each step's id is loaded one stage ahead.  A block streams its
// chunk's steps through a ring of kStages = 3 stages, one stored step a
// stage: the (vk x vn) tile, contiguous in vals, and the gathered (rows x
// vk) activations, copied with 16-byte cp.async (4-byte where a row is not
// 16-byte aligned; int8 byte loads where not even 4).  Copies run two
// stages ahead of the MAC; each stage costs one barrier, which carries the
// input-side skip vote: each thread votes on the activation bytes it copied
// itself (its own cp.async wait has completed them) and __syncthreads_or
// publishes data and vote together.  A stored step whose activation tile is
// all zero adds exact zeros, so it is skipped; `skip` 0 (the reference's
// skip_zero_inputs=False, the paper's dense-input mode) takes no vote, so
// the output has the same bits with the skip on or off.
//
// Two branches, as the reference's `_mac_dot` has:
//   - f32 (body_f32<RT, CT, kFast>): a block of 256 threads owns 16*RT
//     rows x 16*CT columns; a thread owns RT rows (16 apart) x CT columns
//     (4 consecutive, and 4 more 64 columns on at CT 8), so at vn 64 (CT 4)
//     no lane carries a masked column.  The staged activation tile is
//     pixel-major with rows padded to 36 floats (the 4 rows a warp reads at
//     once sit in distinct banks), read as float4 along k; the stored tile
//     is read as float4 along n.  Per 4 k a thread loads RT activation
//     float4 and CT weight float4 for 4*RT*CT FMAs (at 8 x 8 it takes its
//     rows in two halves, rereading the weights, to stay within 128
//     registers: 16 loads for 256 FMAs).
//     f32 FMAs on the CUDA cores: TF32 or wgmma would break the 1e-5
//     agreement with the f32 reference.
//   - int8 (body_int8<MI, WC, ...>): int8 buffer and tiles, a per-column
//     dequant scale.  A stored tile of vk 32 is one k step of
//     mma.sync.m16n8k32.s8.s8.s32: the A fragment is 16 pixel rows of 32
//     contiguous bytes (staged rows 48 bytes apart: conflict-free), the B
//     fragment needs each column's 32 k contiguous, so the tile is loaded
//     into registers a stage before its buffer frees and stored there
//     transposed after the MAC (__byte_perm, four k a word, columns 48
//     bytes apart).  Each tile's accumulator
//     starts from 0x4B400000, the f32 bits of 1.5 * 2^23: |partial| <=
//     128^2 * 32 = 2^19 < 2^22, so D's bits read as a float minus 1.5 *
//     2^23 is the exact partial, added into the f32 accumulator once a
//     tile in stored order: the reference's arithmetic, bit for bit.  Tiles
//     of vk < 32 are padded with zero k (exact).  8 warps of (16*MI) x 32
//     outputs, WC warps across the strip.
// Each branch has fast instantiations for the main path's shapes (vk 32,
// vn 64 or 128; 64- and 128-row tiles) and one general instantiation (any
// vk <= 32, any vn <= 128, 64-row tiles; the staged tiles zero-padded to
// 32 x 128).
//
// The split: with splits > 1 phase 1 writes each chunk's partial to a
// workspace (PyTorch's allocator) and phase 2 (vsconv_*_reduce_kernel)
// sums the chunks in chunk order and applies the epilogue; no atomics, so
// two launches give the same bits.  f32 chunks sum in another order than
// the reference, within 1e-5.  int8 splits only under vsmm.cu's rule: a
// chunk keeps its exact int32 sum T_c and its largest |prefix| A_c (the
// mma accumulates across the chunk's tiles; |T_c| <= 128^2 * vk * S <
// 2^31, which the plan ensures), phase 2 walks the chunks with an exact
// int64 base B, and where some |B| + A_c passes 2^24 it recomputes that
// element serially in stored order, as the reference adds.
//
// Stem body (ungrouped, vk 8, C = CB*vk of 8 or 16 input channels, vn 32
// or 64, kh*kw > 1: the CNN stems after cin padding 3 -> 8).  One block of
// 4 warps owns a 2-D tile of kTH x kTW = 8 x 16 output pixels of one image
// and one output strip j.  It stages once, with cp.async,
//   - its input window: every padded-input pixel its taps reach, with all
//     C channels, columns split by phase (col % stride) so that neighbouring
//     output pixels read neighbouring window pixels.  halo: ((kTH-1)*s +
//     (kh-1)*d + 1) rows x s phases x PW columns; stack: the kh*s planes'
//     kTH rows x PW columns (PW = kTW + (kw-1)*d / s); each row padded by 4
//     floats.  7x7/s2, C 8: 26.2 KB (halo), 69.9 KB (stack);
//   - the strip's stored tiles in chunks of kChunk = 4 (vk x vn each),
//     double-buffered, so a chunk loads while the one before is used.
// A lane owns 8 output pixels x vn/8 output channels (32 or 64 f32
// accumulators): its window reads are shared with three other 8-lane
// groups that read three other pixels in the same wavefront (multicast),
// so one shared-memory wavefront feeds vn/8 FMAs a lane (a warp-wide
// broadcast float4 costs four wavefronts for four values).  No barrier
// between stored tiles (two per chunk).  The input-side skip is one vote
// per (block window, cin tile), taken after staging: a stored tile whose
// cin tile is zero over the whole window is skipped (it would add exact
// zeros); with `skip` 0 no vote is taken.  The ids are decoded as given, in
// stored order.  The epilogue is the generic body's arithmetic, masked at
// the tile's right and bottom edges.
//
// The int8 stem body (stem::body_int8; the same shape rule, tile and
// thread layout) stages an int8 window (C bytes a pixel, 8- or 16-byte
// cp.async copies: a quarter of the f32 window's shared memory, ResNet-18's
// 7x7/s2 stack stem 17.9 KB instead of 69.9) and packed int8 tiles (four
// k a word, transposed with __byte_perm from a chunk loaded into registers
// one chunk ahead: one barrier a chunk).  Per stored tile a lane computes
// each (pixel, channel) partial exactly with two __dp4a and adds it into
// its f32 accumulator, one add a tile in stored order, as the reference
// does: bit-equal to it.  Its epilogue is the f32 body's, dequant scale
// first.
//
// What bounds it on an H100: for the f32 generic body fp32 FMAs on the
// CUDA cores (67 TFLOP/s); the design reuses each staged weight float4
// for RT rows and each activation float4 for CT columns, keeps two stages
// of copies in flight behind the MAC and two blocks an SM.  For the int8
// body the bytes: the gathered input (re-read from L2 once per tap and
// strip), the stored tiles and the f32 output; the MAC is one mma a 16 x 8
// x 32 tile plus two f32 adds an output element and tile.  The stack
// layout adds kh*stride output-sized planes written before the kernel (the
// reference keeps it as the oracle and fallback).  The stem body reads its
// window once per block and is bound by FMAs and the shared-memory loads
// that feed them.
#include "vs_async.cuh"

#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The generic body (see the header).
namespace gen {

constexpr int kThreads = 256;            // threads a block
constexpr int kStages = 3;               // stages in the cp.async ring
constexpr int kMaxVk = 32;               // the K-tile length it takes, at most
constexpr int kMaxVn = 128;              // the strip width it takes, at most
constexpr int kAStride = 36;             // floats between staged f32 pixel rows
constexpr int kRow8 = 48;                // bytes between staged int8 rows
constexpr long long kExact = 1LL << 24;  // f32 holds every integer up to it
constexpr int kMagicBits = 0x4B400000;   // f32 bits of 1.5 * 2^23
constexpr float kMagic = 12582912.0f;    // 1.5 * 2^23
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ inline int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// Everything a launch needs, passed by value.
struct Conv {
  const void* x;
  const void* vals;
  const int* idx;
  const float* scale;
  const float* bias;
  const float* residual;
  float* out;
  void* work;        // splits > 1: the chunks' partials
  long long m;       // output pixels, N*Hout*Wout
  int d0;            // halo rows / stack planes
  int bw, cb, h_out, w_out, kw, stride, dilation;
  int nb, s_steps, vk, vn, cbg, spg, relu, skip, splits;
  int mode_x;        // activation row copies: 16 or 4 bytes (cp.async), 1
  int mode_w;        // stored tile copies: 16 or 4 (f32); int8: 4 or 1
  int vec;           // epilogue: float2/float4 stores
};

// Where a pixel's and a tap's activation sits, in elements.
template <bool kStack>
struct Gather {
  long long c;  // channels a pixel
  int d0, bw, h_out, w_out, kw, stride, dilation, cbg, vk;

  __device__ __forceinline__ long long pixel(long long p) const {
    const long long hw = static_cast<long long>(h_out) * w_out;
    const long long img = p / hw;
    const long long rem = p - img * hw;
    const long long i = rem / w_out;
    const long long jj = rem - i * w_out;
    if (kStack) return ((img * d0 * h_out + i) * bw + jj) * c;
    return ((img * d0 + stride * i) * bw + stride * jj) * c;
  }

  // The offset of stored id t's activation tile from a pixel's base;
  // `group_base` is the strip's first cin tile.
  __device__ __forceinline__ long long tap(int t, int group_base) const {
    const int tp = t / cbg;
    const int ct = group_base + (t - tp * cbg);
    const int ky = tp / kw;
    const int kx = tp - ky * kw;
    if (kStack) {
      const int plane = ky * stride + (kx * dilation) % stride;
      const int col = (kx * dilation) / stride;
      return (static_cast<long long>(plane) * h_out * bw + col) * c +
             static_cast<long long>(ct) * vk;
    }
    return (static_cast<long long>(ky) * dilation * bw +
            static_cast<long long>(kx) * dilation) * c +
           static_cast<long long>(ct) * vk;
  }
};

template <bool kStack>
__device__ __forceinline__ Gather<kStack> gather_of(const Conv& a) {
  return Gather<kStack>{static_cast<long long>(a.cb) * a.vk, a.d0, a.bw,
                        a.h_out, a.w_out, a.kw, a.stride, a.dilation, a.cbg,
                        a.vk};
}

// A thread's share of a (rows x units) copy grid: units u0, u0 + ustep,
// ... of rows r0, r0 + rstep, ... (one division, once a block).
struct Grid {
  int r0, rstep, u0, ustep;
  __device__ __forceinline__ explicit Grid(int units) {
    ustep = min(units, kThreads);
    r0 = threadIdx.x / ustep;
    u0 = threadIdx.x - r0 * ustep;
    rstep = kThreads / ustep;
    if (r0 >= rstep) r0 = 1 << 30;  // the threads past rstep * ustep
  }
};

// Copy rows r < rows into shared memory at dst (rows `stride` bytes
// apart): row r < valid takes `nbytes` bytes from src(r), rows >= valid
// are zeros.  mode 16 / 4: cp.async units of that many bytes (nbytes a
// multiple of it, every src row aligned to it); mode 1: byte loads packed
// into words (zeros past nbytes), stored at once.  `g` is the thread's
// share of the grid (units: nbytes / mode, or words for mode 1).
template <class Src>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int stride,
                                           int rows, int valid, int nbytes,
                                           int mode, const Grid& g, Src src,
                                           const void* base) {
  if (mode == 1) {
    const int words = (nbytes + 3) / 4;
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
  for (int r = g.r0; r < rows; r += g.rstep) {
    const bool ok = r < valid;
    const unsigned char* s = ok ? src(r) : nullptr;
    unsigned char* d = dst + r * stride;
    for (int u = g.u0; u < units; u += g.ustep) {
      const void* from = ok ? static_cast<const void*>(s + u * mode) : base;
      if (mode == 16) {
        vs::cp_async16(d + u * mode, from, ok);
      } else {
        vs::cp_async4(d + u * mode, from, ok);
      }
    }
  }
}

// This thread's vote on a staged activation tile: a word it copied (the
// units `stage_rows` gave it) has a bit set.  It reads only what its own
// copies wrote, which its cp.async wait has completed, one 16-byte load a
// unit.  A -0.0 or a NaN counts as nonzero: a tile that is not skipped
// adds exact zeros at most, so the vote may err that way.
__device__ __forceinline__ int own_vote(const unsigned char* xs, int stride,
                                        int rows_valid, int nbytes, int mode,
                                        const Grid& g) {
  const int units = mode == 1 ? (nbytes + 3) / 4 : nbytes / mode;
  unsigned bits = 0;
  for (int r = g.r0; r < rows_valid; r += g.rstep) {
    for (int u = g.u0; u < units; u += g.ustep) {
      if (mode == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(xs + r * stride +
                                                        16 * u);
        bits |= v.x | v.y | v.z | v.w;
      } else {
        bits |= *reinterpret_cast<const unsigned*>(xs + r * stride + 4 * u);
      }
    }
  }
  return bits != 0;
}

// out[row, col + c] = relu?(v[c] * scale + bias + residual) for c < ncols
// (N columns a row): one float4 (NV 4) or float2 (NV 2) store where
// `vec` and the NV columns are whole.
template <int NV>
__device__ __forceinline__ void store(const float (&v)[NV], float* out,
                                      long long row, int n, int col,
                                      int ncols, const Conv& a) {
  const long long o = row * n + col;
  float r[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    r[c] = v[c];
    if (c < ncols) {
      if (a.scale) r[c] = r[c] * a.scale[col + c];
      if (a.bias) r[c] = r[c] + a.bias[col + c];
      if (a.residual) r[c] = r[c] + a.residual[o + c];
      if (a.relu && r[c] < 0.f) r[c] = 0.f;  // NaN passes, as max(v, 0)
    }
  }
  if (NV > 1 && a.vec && ncols == NV) {
    if constexpr (NV == 4) {
      *reinterpret_cast<float4*>(out + o) = make_float4(r[0], r[1], r[2], r[3]);
    } else if constexpr (NV == 2) {
      *reinterpret_cast<float2*>(out + o) = make_float2(r[0], r[1]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (c < ncols) out[o + c] = r[c];
  }
}

// The block's place in the grid and its pixels: row tile blockIdx.x,
// strip blockIdx.y, chunk blockIdx.z.
struct Block {
  int j, chunk, s0, s1, rows_valid, group_base;
  long long p0;
};

template <bool kStack>
__device__ __forceinline__ Block block_of(const Conv& a, int rows,
                                          long long* pix) {
  Block b;
  b.j = blockIdx.y;
  b.chunk = blockIdx.z;
  b.s0 = static_cast<int>(static_cast<long long>(a.s_steps) * b.chunk /
                          a.splits);
  b.s1 = static_cast<int>(static_cast<long long>(a.s_steps) * (b.chunk + 1) /
                          a.splits);
  b.p0 = static_cast<long long>(blockIdx.x) * rows;
  b.rows_valid = static_cast<int>(min(static_cast<long long>(rows),
                                      a.m - b.p0));
  b.group_base = (b.j / a.spg) * a.cbg;
  const Gather<kStack> gth = gather_of<kStack>(a);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    pix[r] = r < b.rows_valid ? gth.pixel(b.p0 + r) : 0;
  }
  return b;
}

// ---- The f32 branch.
//
// RT rows a thread (16*RT rows a block), CT columns a thread (16*CT
// columns a block).  kFast: vk 32 and vn = 16*CT exactly; otherwise any vk
// <= 32 and vn <= 16*CT, the staged tiles zero-padded (k to a multiple of
// 4, columns to 16*CT).  Thread layout: warp w, lane l: column group cg =
// 8*(w & 1) + (l & 7) owns columns 4*cg .. 4*cg+3 (+ 64 at CT 8), row
// group rg = 4*(w >> 1) + (l >> 3) owns rows rg + 16*i: a warp reads 4
// activation rows (distinct banks: rows 36 floats apart) and 8 column
// quads (128 contiguous bytes) at once.
template <int RT, int CT>
struct F32Geo {
  static constexpr int kRows = 16 * RT;
  static constexpr int kVn = 16 * CT;                 // staged columns
  static constexpr int kWBytes = 4 * kMaxVk * kVn;    // stored tile
  static constexpr int kStageBytes = kWBytes + 4 * kRows * kAStride;
  static constexpr int kSmem = kStages * kStageBytes;
  // Activation rows a thread holds at once: all RT, or half of them at 8
  // x 8 (64 accumulators), which rereads the stored tile's float4 twice
  // a k but keeps the registers within two blocks an SM without a spill.
  static constexpr int kRA = RT * CT > 32 ? RT / 2 : RT;
};

template <int RT, int CT, bool kFast, bool kStack>
__device__ __forceinline__ void body_f32(const Conv& a) {
  using G = F32Geo<RT, CT>;
  extern __shared__ __align__(16) unsigned char gen_smem[];
  __shared__ long long pix[G::kRows];
  const int vk = kFast ? kMaxVk : a.vk;
  const int vn = kFast ? G::kVn : a.vn;
  if (!kFast) {  // zero padding: written once, never copied over
    float4* z = reinterpret_cast<float4*>(gen_smem);
    for (int e = threadIdx.x; e < G::kSmem / 16; e += kThreads) {
      z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const Block blk = block_of<kStack>(a, G::kRows, pix);
  const Gather<kStack> gth = gather_of<kStack>(a);
  __syncthreads();  // pix and the zero padding are in place

  const int n = blk.s1 - blk.s0;
  const long long tile0 = static_cast<long long>(blk.j) * a.s_steps + blk.s0;
  const Grid gx(vk * 4 / a.mode_x);
  const Grid gw(vn * 4 / a.mode_w);
  const unsigned char* x = static_cast<const unsigned char*>(a.x);
  const unsigned char* vals = static_cast<const unsigned char*>(a.vals);
  int next_id = n > 0 ? a.idx[tile0] : 0;  // the next step's id
  auto issue = [&](int q) {  // the copies of step s0 + q, one commit group
    if (q < n) {
      unsigned char* st = gen_smem + (q % kStages) * G::kStageBytes;
      const long long tile = tile0 + q;
      const long long off = gth.tap(next_id, blk.group_base);
      if (q + 1 < n) next_id = a.idx[tile + 1];  // used one stage on
      stage_rows(st, 4 * G::kVn, vk, vk, 4 * vn, a.mode_w, gw, [&](int r) {
        return vals + 4 * ((tile * vk + r) * vn);
      }, a.vals);
      stage_rows(st + G::kWBytes, 4 * kAStride, G::kRows, blk.rows_valid,
                 4 * vk, a.mode_x, gx, [&](int r) {
                   return x + 4 * (pix[r] + off);
                 }, a.x);
    }
    vs::cp_async_commit();
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cg = 8 * (warp & 1) + (lane & 7);
  const int rg = 4 * (warp >> 1) + (lane >> 3);
  float acc[RT][CT] = {};
  const int k4 = round_up(vk, 4);
  issue(0);
  issue(1);
  for (int q = 0; q < n; ++q) {
    vs::cp_async_wait<kStages - 2>();  // this thread's copies of step q
    const unsigned char* st = gen_smem + (q % kStages) * G::kStageBytes;
    int live = 1;
    if (a.skip) {
      live = __syncthreads_or(own_vote(st + G::kWBytes, 4 * kAStride,
                                       blk.rows_valid, 4 * vk, a.mode_x, gx));
    } else {
      __syncthreads();
    }
    // step q and its vote landed; step q-1's MAC is done with its buffer
    issue(q + kStages - 1);
    if (!live) continue;  // block-uniform
    const float* ws = reinterpret_cast<const float*>(st) + 4 * cg;
    const float* xs =
        reinterpret_cast<const float*>(st + G::kWBytes) + rg * kAStride;
    auto mac = [&](int kq) {
#pragma unroll
      for (int i0 = 0; i0 < RT; i0 += G::kRA) {
        float4 av[G::kRA];
#pragma unroll
        for (int i = 0; i < G::kRA; ++i) {
          av[i] = *reinterpret_cast<const float4*>(
              xs + 16 * (i0 + i) * kAStride + kq);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float b[CT];
#pragma unroll
          for (int h = 0; h < CT / 4; ++h) {
            const float4 w4 = *reinterpret_cast<const float4*>(
                ws + (kq + kk) * G::kVn + 64 * h);
            b[4 * h] = w4.x;
            b[4 * h + 1] = w4.y;
            b[4 * h + 2] = w4.z;
            b[4 * h + 3] = w4.w;
          }
#pragma unroll
          for (int i = 0; i < G::kRA; ++i) {
            const float v = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                            : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int c = 0; c < CT; ++c) {
              acc[i0 + i][c] = fmaf(v, b[c], acc[i0 + i][c]);
            }
          }
        }
      }
    };
    if constexpr (kFast) {
#pragma unroll
      for (int kq = 0; kq < kMaxVk; kq += 4) mac(kq);
    } else {
      for (int kq = 0; kq < k4; kq += 4) mac(kq);
    }
  }
  vs::cp_async_wait<0>();  // only empty groups are left

  // The tile's result: the epilogue, or (splits > 1) the chunk's partial.
  const int n_total = a.nb * a.vn;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg + 16 * i;
    if (r >= blk.rows_valid) continue;
    const long long row = blk.p0 + r;
#pragma unroll
    for (int h = 0; h < CT / 4; ++h) {
      const int cl = 4 * cg + 64 * h;
      if (cl >= vn) continue;
      const int ncols = min(4, vn - cl);
      const int col = blk.j * vn + cl;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      if (a.splits > 1) {
        float* w = static_cast<float*>(a.work) + blk.chunk * a.m * n_total +
                   row * n_total + col;
        for (int c = 0; c < ncols; ++c) w[c] = v[c];
      } else {
        store<4>(v, a.out, row, n_total, col, ncols, a);
      }
    }
  }
}

// ---- The int8 branch on mma.sync.m16n8k32.s8.s8.s32.
//
// 8 warps, WC across the strip (32 columns each: 4 n8 tiles) and 8 / WC
// down the rows (16*MI rows each: MI m16 tiles), so a block owns
// 8/WC*16*MI rows x 32*WC columns.  kFast: vk 32 and vn = 32*WC exactly;
// otherwise any vk <= 32 and vn <= 32*WC, zero-padded (exact).  kSplit:
// the chunk's exact int32 sum T_c and largest |prefix| A_c instead of the
// f32 accumulator.
template <int MI, int WC>
struct Int8Geo {
  static constexpr int kRows = 8 / WC * 16 * MI;
  static constexpr int kVn = 32 * WC;                // staged columns
  static constexpr int kWBytes = kRow8 * kVn;        // [col][k], k packed
  static constexpr int kStageBytes = kWBytes + kRow8 * kRows;
  static constexpr int kSmem = kStages * kStageBytes;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2],
                                       const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// 4 int8 of a row at p (bytes b < n, zeros past it): one word load where
// `word`, else byte loads.
__device__ __forceinline__ unsigned load4(const unsigned char* p, bool word,
                                          int n) {
  if (word && n >= 4) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0;
  for (int b = 0; b < min(n, 4); ++b) v |= static_cast<unsigned>(p[b]) << (8 * b);
  return v;
}

template <int MI, int WC, bool kFast, bool kSplit, bool kStack>
__device__ __forceinline__ void body_int8(const Conv& a) {
  using G = Int8Geo<MI, WC>;
  extern __shared__ __align__(16) unsigned char gen_smem[];
  __shared__ long long pix[G::kRows];
  const int vk = kFast ? kMaxVk : a.vk;
  const int vn = kFast ? G::kVn : a.vn;
  if (!kFast) {  // zero padding: written once, never copied over
    int4* z = reinterpret_cast<int4*>(gen_smem);
    for (int e = threadIdx.x; e < G::kSmem / 16; e += kThreads) {
      z[e] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();  // before any thread stores a transposed tile
  }
  const Block blk = block_of<kStack>(a, G::kRows, pix);
  const Gather<kStack> gth = gather_of<kStack>(a);

  const int n = blk.s1 - blk.s0;
  const long long tile0 = static_cast<long long>(blk.j) * a.s_steps + blk.s0;
  const Grid gx(a.mode_x == 1 ? (vk + 3) / 4 : vk / a.mode_x);
  const unsigned char* x = static_cast<const unsigned char*>(a.x);
  const unsigned char* vals = static_cast<const unsigned char*>(a.vals);
  // This thread's share of a stored tile's transpose: k quad uq, columns
  // 4*uc .. 4*uc+3 (loaded as 4 row words, stored as 4 column words).
  const int cq = kFast ? G::kVn / 4 : (vn + 3) / 4;
  const int uq = threadIdx.x / cq;
  const int uc = threadIdx.x - uq * cq;
  const bool has_unit = uq < (vk + 3) / 4;
  const bool word = a.mode_w == 4;
  unsigned raw[4];
  auto load_w = [&](int q) {  // step s0 + q's tile into raw
    if (has_unit && q < n) {
      const unsigned char* p =
          vals + ((tile0 + q) * vk + 4 * uq) * vn + 4 * uc;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        raw[kk] = 4 * uq + kk < vk ? load4(p + kk * vn, word, vn - 4 * uc)
                                   : 0u;
      }
    }
  };
  auto store_w = [&](int q) {  // raw into step s0 + q's buffer, transposed
    if (has_unit && q < n) {
      const unsigned lo01 = __byte_perm(raw[0], raw[1], 0x5140);
      const unsigned hi01 = __byte_perm(raw[0], raw[1], 0x7362);
      const unsigned lo23 = __byte_perm(raw[2], raw[3], 0x5140);
      const unsigned hi23 = __byte_perm(raw[2], raw[3], 0x7362);
      unsigned char* dst = gen_smem + (q % kStages) * G::kStageBytes +
                           (4 * uc) * kRow8 + 4 * uq;
      *reinterpret_cast<unsigned*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<unsigned*>(dst + kRow8) =
          __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<unsigned*>(dst + 2 * kRow8) =
          __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<unsigned*>(dst + 3 * kRow8) =
          __byte_perm(hi01, hi23, 0x7632);
    }
  };
  int next_id = n > 0 ? a.idx[tile0] : 0;  // the next step's id
  auto issue = [&](int q) {  // step s0 + q's activations, one commit group
    if (q < n) {
      const long long off = gth.tap(next_id, blk.group_base);
      if (q + 1 < n) next_id = a.idx[tile0 + q + 1];  // used one stage on
      stage_rows(gen_smem + (q % kStages) * G::kStageBytes + G::kWBytes,
                 kRow8, G::kRows, blk.rows_valid, vk, a.mode_x, gx,
                 [&](int r) { return x + pix[r] + off; }, a.x);
    }
    vs::cp_async_commit();
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // the fragments' groupID
  const int tg = lane & 3;   // threadID_in_group
  const int row_w = (warp / WC) * 16 * MI;  // the warp's first row
  const int col_w = (warp % WC) * 32;       // and column
  // kSplit: acc holds nothing; tsum and amax per output element.
  float acc[kSplit ? 1 : MI][kSplit ? 1 : 4][4] = {};
  int tsum[kSplit ? MI : 1][kSplit ? 4 : 1][4] = {};
  int amax[kSplit ? MI : 1][kSplit ? 4 : 1][4] = {};
  load_w(0);
  store_w(0);
  load_w(1);
  store_w(1);
  __syncthreads();  // pix and the zero padding are in place
  issue(0);
  issue(1);
  load_w(2);
  for (int q = 0; q < n; ++q) {
    vs::cp_async_wait<kStages - 2>();  // this thread's copies of step q
    const unsigned char* st = gen_smem + (q % kStages) * G::kStageBytes;
    int live = 1;
    if (a.skip) {
      live = __syncthreads_or(own_vote(st + G::kWBytes, kRow8,
                                       blk.rows_valid, vk, a.mode_x, gx));
    } else {
      __syncthreads();
    }
    // step q and its vote landed; step q-1's MAC is done with its buffer
    issue(q + kStages - 1);
    if (live) {  // block-uniform
      const unsigned char* xs = st + G::kWBytes;
      unsigned af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const unsigned char* r0 = xs + (row_w + 16 * mi + g) * kRow8 + 4 * tg;
        af[mi][0] = *reinterpret_cast<const unsigned*>(r0);
        af[mi][1] = *reinterpret_cast<const unsigned*>(r0 + 8 * kRow8);
        af[mi][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(r0 + 8 * kRow8 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const unsigned char* c0 = st + (col_w + 8 * ni + g) * kRow8 + 4 * tg;
        const unsigned bf[2] = {*reinterpret_cast<const unsigned*>(c0),
                                *reinterpret_cast<const unsigned*>(c0 + 16)};
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if constexpr (kSplit) {  // T_c += the tile; A_c = max |T_c|
            int d[4];
            mma_s8(d, af[mi], bf, tsum[mi][ni]);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              tsum[mi][ni][c] = d[c];
              amax[mi][ni][c] = max(amax[mi][ni][c], abs(d[c]));
            }
          } else {  // the tile's exact partial, one f32 add in stored order
            const int magic[4] = {kMagicBits, kMagicBits, kMagicBits,
                                  kMagicBits};
            int d[4];
            mma_s8(d, af[mi], bf, magic);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[mi][ni][c] += __int_as_float(d[c]) - kMagic;
            }
          }
        }
      }
    }
    store_w(q + kStages - 1);  // into step q-1's buffer (free since the
    load_w(q + kStages);       // barrier); the next tile in flight
  }
  vs::cp_async_wait<0>();  // only empty groups are left

  // The tile's result: the epilogue, or (splits > 1) the chunk's (T_c,
  // A_c) pairs.
  const int n_total = a.nb * a.vn;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_w + 16 * mi + g + 8 * half;
      if (r >= blk.rows_valid) continue;
      const long long row = blk.p0 + r;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cl = col_w + 8 * ni + 2 * tg;
        if (cl >= vn) continue;
        const int ncols = min(2, vn - cl);
        const int col = blk.j * vn + cl;
        if constexpr (kSplit) {
          int2* w = static_cast<int2*>(a.work) + blk.chunk * a.m * n_total +
                    row * n_total + col;
          for (int c = 0; c < ncols; ++c) {
            w[c] = make_int2(tsum[mi][ni][2 * half + c],
                             amax[mi][ni][2 * half + c]);
          }
        } else {
          const float v[2] = {acc[mi][ni][2 * half],
                              acc[mi][ni][2 * half + 1]};
          store<2>(v, a.out, row, n_total, col, ncols, a);
        }
      }
    }
  }
}

// Phase 2, f32: the chunks' partials summed in chunk order, epilogue.
__device__ __forceinline__ void reduce_f32(const Conv& a) {
  const long long n_total = static_cast<long long>(a.nb) * a.vn;
  const long long mn = a.m * n_total;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= mn) return;
  const float* work = static_cast<const float*>(a.work);
  float v = work[e];
  for (int c = 1; c < a.splits; ++c) v += work[c * mn + e];
  const float r[1] = {v};
  store<1>(r, a.out, e / n_total, static_cast<int>(n_total),
           static_cast<int>(e % n_total), 1, a);
}

// Phase 2, int8: the chunks' exact sums walked in chunk order with an
// exact base; where a chunk's prefix sums may pass 2^24 on top of it, the
// element is recomputed serially in stored order (the reference's adds).
template <bool kStack>
__device__ __forceinline__ void reduce_int8(const Conv& a) {
  const long long n_total = static_cast<long long>(a.nb) * a.vn;
  const long long mn = a.m * n_total;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= mn) return;
  const int2* work = static_cast<const int2*>(a.work);
  const long long row = e / n_total;
  const int col = static_cast<int>(e - row * n_total);
  long long base = 0;
  bool exact = true;
  for (int c = 0; c < a.splits; ++c) {
    const int2 t = work[c * mn + e];
    exact = exact && (base < 0 ? -base : base) + t.y <= kExact;
    base += t.x;
  }
  float v = static_cast<float>(base);
  if (!exact) {
    const Gather<kStack> gth = gather_of<kStack>(a);
    const int j = col / a.vn;
    const int cl = col - j * a.vn;
    const int group_base = (j / a.spg) * a.cbg;
    const int8_t* x = static_cast<const int8_t*>(a.x) + gth.pixel(row);
    v = 0.f;
    for (int s = 0; s < a.s_steps; ++s) {
      const long long tile = static_cast<long long>(j) * a.s_steps + s;
      const int8_t* xr = x + gth.tap(a.idx[tile], group_base);
      const int8_t* w = static_cast<const int8_t*>(a.vals) +
                        tile * a.vk * a.vn + cl;
      int p = 0;
      for (int k = 0; k < a.vk; ++k) {
        p += xr[k] * w[static_cast<long long>(k) * a.vn];
      }
      v += static_cast<float>(p);
    }
  }
  const float r[1] = {v};
  store<1>(r, a.out, row, static_cast<int>(n_total), col, 1, a);
}

}  // namespace gen

// The generic body's entry functions, by layout: f32 <RT, CT, kFast>,
// int8 <MI, WC, kFast, kSplit>, and their phase 2.  Two blocks an SM: up
// to 128 registers a thread.
template <int RT, int CT, bool kFast>
__global__ void __launch_bounds__(gen::kThreads, 2)
    vsconv_halo_kernel(gen::Conv a) {
  gen::body_f32<RT, CT, kFast, false>(a);
}

template <int RT, int CT, bool kFast>
__global__ void __launch_bounds__(gen::kThreads, 2)
    vsconv_stack_kernel(gen::Conv a) {
  gen::body_f32<RT, CT, kFast, true>(a);
}

template <int MI, int WC, bool kFast, bool kSplit>
__global__ void __launch_bounds__(gen::kThreads, 2)
    vsconv_halo_int8_kernel(gen::Conv a) {
  gen::body_int8<MI, WC, kFast, kSplit, false>(a);
}

template <int MI, int WC, bool kFast, bool kSplit>
__global__ void __launch_bounds__(gen::kThreads, 2)
    vsconv_stack_int8_kernel(gen::Conv a) {
  gen::body_int8<MI, WC, kFast, kSplit, true>(a);
}

__global__ void __launch_bounds__(256) vsconv_halo_reduce_kernel(gen::Conv a) {
  gen::reduce_f32(a);
}

__global__ void __launch_bounds__(256)
    vsconv_stack_reduce_kernel(gen::Conv a) {
  gen::reduce_f32(a);
}

__global__ void __launch_bounds__(256)
    vsconv_halo_int8_reduce_kernel(gen::Conv a) {
  gen::reduce_int8<false>(a);
}

__global__ void __launch_bounds__(256)
    vsconv_stack_int8_reduce_kernel(gen::Conv a) {
  gen::reduce_int8<true>(a);
}

namespace gen {

inline bool aligned(const void* p, int to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

template <class Kernel>
int launch_one(Kernel kernel, size_t smem, int rows, const Conv& a,
               cudaStream_t stream) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(static_cast<unsigned>((a.m + rows - 1) / rows), a.nb,
                  a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStack, int RT, int CT, bool kFast>
int launch_f32(const Conv& a, int rows, cudaStream_t stream) {
  return launch_one(kStack ? vsconv_stack_kernel<RT, CT, kFast>
                           : vsconv_halo_kernel<RT, CT, kFast>,
                    F32Geo<RT, CT>::kSmem, rows, a, stream);
}

template <bool kStack, int MI, int WC, bool kFast, bool kSplit>
int launch_int8(const Conv& a, int rows, cudaStream_t stream) {
  return launch_one(kStack ? vsconv_stack_int8_kernel<MI, WC, kFast, kSplit>
                           : vsconv_halo_int8_kernel<MI, WC, kFast, kSplit>,
                    Int8Geo<MI, WC>::kSmem, rows, a, stream);
}

// Phase 1 on the instantiation the plan and the shapes pick, then phase 2
// where the plan splits.  Returns cudaErrorInvalidValue without launching
// for a plan or shape the body does not take.
template <bool kStack>
int launch(Conv a, bool int8, int rows, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool fast = a.vk == kMaxVk && (a.vn == 64 || a.vn == 128);
  if ((rows != 64 && rows != 128) || (!fast && rows != 64) || a.vk < 1 ||
      a.vk > kMaxVk || a.vn < 1 || a.vn > kMaxVn || a.splits < 1 ||
      a.splits > (a.s_steps > 1 ? a.s_steps : 1) ||
      (a.splits > 1 && a.work == nullptr) ||
      (int8 && a.splits > 1 &&
       (rows != 64 || 128LL * 128 * a.vk * a.s_steps >= (1LL << 31)))) {
    return bad;
  }
  const int es = int8 ? 1 : 4;
  const int xb = a.vk * es;  // bytes of an activation row
  a.mode_x = xb % 16 == 0 && aligned(a.x, 16) ? 16
             : xb % 4 == 0 && aligned(a.x, 4) ? 4 : 1;
  if (int8) {
    a.mode_w = a.vn % 4 == 0 && aligned(a.vals, 4) ? 4 : 1;
  } else {
    a.mode_w = a.vn % 4 == 0 && aligned(a.vals, 16) ? 16 : 4;
  }
  const int nv = int8 ? 2 : 4;
  const long long n_total = static_cast<long long>(a.nb) * a.vn;
  a.vec = n_total % nv == 0 && a.vn % nv == 0 && aligned(a.out, 4 * nv) &&
          (!a.scale || aligned(a.scale, 4 * nv)) &&
          (!a.bias || aligned(a.bias, 4 * nv)) &&
          (!a.residual || aligned(a.residual, 4 * nv));
  const bool wide = !fast || a.vn == 128;  // 128 staged columns
  const bool tall = rows == 128;
  int err;
  if (!int8) {
    err = !fast ? launch_f32<kStack, 4, 8, false>(a, rows, stream)
        : wide  ? (tall ? launch_f32<kStack, 8, 8, true>(a, rows, stream)
                        : launch_f32<kStack, 4, 8, true>(a, rows, stream))
                : (tall ? launch_f32<kStack, 8, 4, true>(a, rows, stream)
                        : launch_f32<kStack, 4, 4, true>(a, rows, stream));
  } else if (a.splits > 1) {  // 64-row tiles (checked above)
    err = !fast ? launch_int8<kStack, 2, 4, false, true>(a, rows, stream)
        : wide  ? launch_int8<kStack, 2, 4, true, true>(a, rows, stream)
                : launch_int8<kStack, 1, 2, true, true>(a, rows, stream);
  } else {
    err = !fast ? launch_int8<kStack, 2, 4, false, false>(a, rows, stream)
        : wide  ? (tall ? launch_int8<kStack, 4, 4, true, false>(a, rows, stream)
                        : launch_int8<kStack, 2, 4, true, false>(a, rows, stream))
                : (tall ? launch_int8<kStack, 2, 2, true, false>(a, rows, stream)
                        : launch_int8<kStack, 1, 2, true, false>(a, rows, stream));
  }
  if (err || a.splits == 1) return err;
  const long long mn = a.m * static_cast<long long>(a.nb) * a.vn;
  const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
  void (*reduce)(Conv) =
      int8 ? (kStack ? vsconv_stack_int8_reduce_kernel
                     : vsconv_halo_int8_reduce_kernel)
           : (kStack ? vsconv_stack_reduce_kernel : vsconv_halo_reduce_kernel);
  reduce<<<blocks, 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gen

// ---------------------------------------------------------------------------
// The stem body (see the header).
namespace stem {

constexpr int kThreads = 128;  // 4 warps, two output rows each
constexpr int kTH = 8;         // output rows of a tile
constexpr int kTW = 16;        // output columns of a tile
constexpr int kVK = 8;         // the K-tile length the body takes
constexpr int kChunk = 4;      // stored tiles per staged weight chunk
constexpr int kRowPad = 4;     // floats after each window row (see below)
constexpr size_t kMaxSmem = 227 * 1024;

// Rows of the staged window: halo, (window row, column phase) pairs;
// stack, (plane, output row) pairs.  Each row holds row_pixels pixels of C
// floats, then kRowPad floats.
__host__ __device__ inline int window_rows(bool stack, int kh, int stride,
                                           int dilation) {
  return stack ? kh * stride * kTH
               : ((kTH - 1) * stride + (kh - 1) * dilation + 1) * stride;
}

__host__ __device__ inline int row_pixels(int kw, int stride, int dilation) {
  return kTW + ((kw - 1) * dilation) / stride;
}

// Dynamic shared memory of one block: window, two weight chunks, and the
// window offset and cin tile of each stored tile.
inline size_t smem_bytes(bool stack, int c, int vn, int kh, int kw,
                         int stride, int dilation, int s_steps) {
  const size_t row_floats =
      static_cast<size_t>(row_pixels(kw, stride, dilation)) * c + kRowPad;
  return sizeof(float) *
         (window_rows(stack, kh, stride, dilation) * row_floats +
          2 * kChunk * kVK * static_cast<size_t>(vn) + 2 * s_steps);
}

// Bit ct of the result: cin tile ct has a nonzero (or a NaN) anywhere in
// the staged window.  A barrier per cin tile.
template <int C>
__device__ __forceinline__ int window_votes(const float* win, int rows,
                                            int row_floats, int pw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int bits = 0;
  for (int row = warp; row < rows; row += kThreads / 32) {
    const float4* w4 = reinterpret_cast<const float4*>(win + row * row_floats);
    for (int e = lane; e < pw * (C / 4); e += 32) {
      const float4 v = w4[e];
      const bool nz = v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      bits |= static_cast<int>(nz) << ((e % (C / 4)) / (kVK / 4));
    }
  }
  int alive = 0;
#pragma unroll
  for (int ct = 0; ct < C / kVK; ++ct) {
    alive |= (__syncthreads_or((bits >> ct) & 1) ? 1 : 0) << ct;
  }
  return alive;
}

// The whole block: stage, accumulate, epilogue.  NC = vn / 32, C input
// channels a pixel; kStack picks the layout.
//
// Thread layout: a warp owns two output rows.  Its lanes form 4 groups of
// 8; group g takes row 2*warp + g / 2 and columns g % 2 + 2p (p < 8), lane
// l of a group the output channels l + 8m (m < 4*NC).  Per (stored tile,
// k) a lane reads its 4*NC weights (the 4 groups read the same 8
// consecutive words: one wavefront each) and, per column pair p, one
// window value: the 4 groups read 4 pixels at once, which the row padding
// keeps in 4 distinct banks (C 8: the two pixels of a row are 8 words
// apart, the two rows 4 or 16 words mod 32), so one wavefront feeds 4*NC
// FMAs a lane.
template <int NC, int C, bool kStack>
__device__ __forceinline__ void body(
    const float* __restrict__ x, const float* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int d0, int bw, int h_out, int w_out, int kh,
    int kw, int stride, int dilation, int nb, int s_steps, int cbg,
    int aligned, int relu, int skip) {
  constexpr int VN = 32 * NC;
  constexpr int CPL = VN / 8;  // output channels a lane
  constexpr int P = kTW / 2;   // output pixels a lane
  constexpr int kChunkFloats = kChunk * kVK * VN;
  extern __shared__ __align__(16) float stem_smem[];
  const int s = stride, d = dilation;
  const int tiles_w = (w_out + kTW - 1) / kTW;
  const int tiles_h = (h_out + kTH - 1) / kTH;
  const int tw_i = blockIdx.x % tiles_w;
  const int th_i = (blockIdx.x / tiles_w) % tiles_h;
  const long long img = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = th_i * kTH, w0 = tw_i * kTW;
  const int j = blockIdx.y;
  const int pw = row_pixels(kw, s, d);
  const int row_floats = pw * C + kRowPad;
  const int rows = window_rows(kStack, kh, s, d);
  float* win = stem_smem;
  float* wbuf = win + rows * row_floats;
  int* toff = reinterpret_cast<int*>(wbuf + 2 * kChunkFloats);
  int* tct = toff + s_steps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Stage the window: warp-strided rows, lane-strided 16- (or 4-) byte
  // units along a row; pixels outside the buffer read zeros.
  const int vec = aligned ? 4 : 1;
  const int units = pw * C / vec;
  for (int row = warp; row < rows; row += kThreads / 32) {
    int gr, gc0, gstep;
    long long rbase;
    bool row_ok;
    if (kStack) {  // row = plane*kTH + i
      const int plane = row / kTH;
      gr = h0 + row % kTH;
      row_ok = gr < h_out;
      rbase = ((img * d0 + plane) * h_out + gr) * bw;
      gc0 = w0;
      gstep = 1;
    } else {       // row = r*s + phase
      const int r = row / s;
      gr = h0 * s + r;
      row_ok = gr < d0;
      rbase = (img * d0 + gr) * bw;
      gc0 = w0 * s + row % s;
      gstep = s;
    }
    for (int u = lane; u < units; u += 32) {
      const int e = u * vec;
      const int q = e / C;  // pixel in the row
      const int ch = e - q * C;
      const int gc = gc0 + q * gstep;
      const bool ok = row_ok && gc < bw;
      const float* src = ok ? x + (rbase + gc) * C + ch : x;
      float* dst = win + row * row_floats + q * C + ch;
      if (aligned) {
        vs::cp_async16(dst, src, ok);
      } else {
        vs::cp_async4(dst, src, ok);
      }
    }
  }
  // Window offset (floats, from a lane's first pixel) and cin tile of each
  // stored id, decoded as given.
  const int ph_rows = kStack ? kTH : 1;
  const int ky_rows = kStack ? s * kTH : d * s;
  for (int t = threadIdx.x; t < s_steps; t += kThreads) {
    const int id = idx[static_cast<long long>(j) * s_steps + t];
    const int tap = id / cbg;
    const int ct = id - tap * cbg;
    const int ky = tap / kw;
    const int kx = tap - ky * kw;
    toff[t] = (ky * ky_rows + ((kx * d) % s) * ph_rows) * row_floats +
              ((kx * d) / s) * C + ct * kVK;
    tct[t] = ct;
  }
  const float* tiles = vals + static_cast<long long>(j) * s_steps * kVK * VN;
  auto stage_chunk = [&](int chunk) {
    const int t0 = chunk * kChunk;
    const int n = min(kChunk, s_steps - t0) * kVK * VN;
    const float* src = tiles + static_cast<long long>(t0) * kVK * VN;
    float* dst = wbuf + (chunk & 1) * kChunkFloats;
    for (int e = threadIdx.x * vec; e < n; e += kThreads * vec) {
      if (aligned) {
        vs::cp_async16(dst + e, src + e, true);
      } else {
        vs::cp_async4(dst + e, src + e, true);
      }
    }
  };

  const int grp = lane >> 3;
  const int li = lane & 7;
  const int i = 2 * warp + (grp >> 1);  // output row in the tile
  const int col0 = grp & 1;             // first output column; then + 2
  const int x_off = i * (kStack ? 1 : s * s) * row_floats + col0 * C;
  float acc[P][CPL] = {};
  const int n_chunks = (s_steps + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage_chunk(0);
  vs::cp_async_commit();  // the window and chunk 0
  int alive = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      stage_chunk(chunk + 1);  // into the buffer chunk - 1 used
      vs::cp_async_commit();
      vs::cp_async_wait<1>();
    } else {
      vs::cp_async_wait<0>();
    }
    __syncthreads();  // the window, this chunk and toff/tct are in place
    if (chunk == 0) {
      alive = skip ? window_votes<C>(win, rows, row_floats, pw) : ~0;
    }
    const float* wt = wbuf + (chunk & 1) * kChunkFloats + li;
    const int t_end = min(s_steps, (chunk + 1) * kChunk);
    for (int t = chunk * kChunk; t < t_end; ++t, wt += kVK * VN) {
      if (!((alive >> tct[t]) & 1)) continue;  // block-uniform
      const float* xp = win + x_off + toff[t];
#pragma unroll
      for (int k = 0; k < kVK; ++k) {
        float w[CPL];
#pragma unroll
        for (int m = 0; m < CPL; ++m) w[m] = wt[k * VN + 8 * m];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float a = xp[2 * p * C + k];
#pragma unroll
          for (int m = 0; m < CPL; ++m) acc[p][m] = fmaf(a, w[m], acc[p][m]);
        }
      }
    }
    __syncthreads();  // done with this chunk's buffer before it is refilled
  }
  if (n_chunks == 0) vs::cp_async_wait<0>();

  // Epilogue, as the generic body's: masked at the image's right and
  // bottom.
  const int h = h0 + i;
  if (h >= h_out) return;
  const int n_total = nb * VN;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int wc = w0 + col0 + 2 * p;
    if (wc >= w_out) continue;
    const long long o =
        ((img * h_out + h) * w_out + wc) * n_total + j * VN + li;
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int col = j * VN + li + 8 * m;
      float v = acc[p][m];
      if (scale) v = v * scale[col];
      if (bias) v = v + bias[col];
      if (residual) v = v + residual[o + 8 * m];
      if (relu && v < 0.f) v = 0.f;  // NaN passes through, as in max(v, 0)
      out[o + 8 * m] = v;
    }
  }
}

// ---- The int8 stem body: the f32 body's twin on int8 windows and tiles.

// Words of a staged int8 window row: pw pixels of C bytes, 16-byte
// aligned (C 16: 16-byte copies; C 8: 8-byte copies).  A lane reads a
// pixel's cin tile as one 8-byte word pair, and a half-warp's two pixels
// are C bytes apart, so no row padding is needed against bank conflicts.
__host__ __device__ inline int int8_row_words(int kw, int stride,
                                              int dilation, int c) {
  return (row_pixels(kw, stride, dilation) * c / 4 + 3) / 4 * 4;
}

// Dynamic shared memory of an int8 block: window, two packed weight
// chunks (four k a word), and the word offset and cin tile of each stored
// tile.
inline size_t smem_bytes_int8(bool stack, int c, int vn, int kh, int kw,
                              int stride, int dilation, int s_steps) {
  return sizeof(int) *
         (static_cast<size_t>(window_rows(stack, kh, stride, dilation)) *
              int8_row_words(kw, stride, dilation, c) +
          2 * kChunk * (kVK / 4) * static_cast<size_t>(vn) + 2 * s_steps);
}

// window_votes for an int8 window: bit ct when cin tile ct (8 bytes a
// pixel) is nonzero anywhere in it.
template <int C>
__device__ __forceinline__ int window_votes_int8(const int* win, int rows,
                                                 int row_words, int pw) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int bits = 0;
  for (int row = warp; row < rows; row += kThreads / 32) {
    const int2* w2 = reinterpret_cast<const int2*>(win + row * row_words);
    for (int e = lane; e < pw * (C / kVK); e += 32) {
      const int2 v = w2[e];
      bits |= static_cast<int>(v.x != 0 || v.y != 0) << (e % (C / kVK));
    }
  }
  int alive = 0;
#pragma unroll
  for (int ct = 0; ct < C / kVK; ++ct) {
    alive |= (__syncthreads_or((bits >> ct) & 1) ? 1 : 0) << ct;
  }
  return alive;
}

// A 32-bit word of 4 int8 at p: one load where `aligned`, else 4 bytes.
__device__ __forceinline__ unsigned load_word(const int8_t* p,
                                              bool aligned) {
  if (aligned) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    v |= static_cast<unsigned>(static_cast<uint8_t>(p[b])) << (8 * b);
  }
  return v;
}

// f32 bits of 1.5 * 2^23: an int32 p with |p| < 2^22 added to these bits
// is the float 1.5 * 2^23 + p, so subtracting 1.5 * 2^23 gives float(p)
// exactly, in two full-rate instructions (the add rides in dp4a's
// accumulator input).
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagic = 12582912.0f;

// The int8 block.  Layout, window and tiling as `body`; what differs:
//   - the window holds C int8 a pixel (a quarter of the f32 bytes),
//     staged with 8-byte (C 8) or 16-byte (C 16) cp.async copies where x
//     is 16-byte aligned, else by byte loads;
//   - a chunk of stored tiles is loaded into registers one chunk ahead and
//     stored packed four k a word (words [q][col], k = 4q + byte), a
//     4 x 4 byte transpose with __byte_perm, so one barrier a chunk;
//   - per stored tile a lane computes each (pixel, channel) partial
//     exactly, two __dp4a into int32 (|partial| <= 128^2 * 8 < 2^22), and
//     adds it into its f32 accumulator: one add a tile, in stored order,
//     as the reference does.  A skipped tile would add exact zeros.
template <int NC, int C, bool kStack>
__device__ __forceinline__ void body_int8(
    const int8_t* __restrict__ x, const int8_t* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int d0, int bw, int h_out, int w_out, int kh,
    int kw, int stride, int dilation, int nb, int s_steps, int cbg,
    int aligned, int relu, int skip) {
  constexpr int VN = 32 * NC;
  constexpr int CPL = VN / 8;       // output channels a lane
  constexpr int P = kTW / 2;        // output pixels a lane
  constexpr int CW = C / 4;         // words a pixel
  constexpr int kChunkWords = kChunk * (kVK / 4) * VN;
  constexpr int kUnits = kChunk * (kVK / 4) * (VN / 4);  // 4 x 4 transposes
  static_assert(kUnits <= kThreads, "one transpose a thread");
  extern __shared__ __align__(16) int stem_int8_smem[];
  const int s = stride, d = dilation;
  const int tiles_w = (w_out + kTW - 1) / kTW;
  const int tiles_h = (h_out + kTH - 1) / kTH;
  const int tw_i = blockIdx.x % tiles_w;
  const int th_i = (blockIdx.x / tiles_w) % tiles_h;
  const long long img = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = th_i * kTH, w0 = tw_i * kTW;
  const int j = blockIdx.y;
  const int pw = row_pixels(kw, s, d);
  const int row_words = int8_row_words(kw, s, d, C);
  const int rows = window_rows(kStack, kh, s, d);
  int* win = stem_int8_smem;
  int* wbuf = win + rows * row_words;
  int* toff = wbuf + 2 * kChunkWords;
  int* tct = toff + s_steps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Stage the window: warp-strided rows, lane-strided pixels.
  for (int row = warp; row < rows; row += kThreads / 32) {
    int gr, gc0, gstep;
    long long rbase;
    bool row_ok;
    if (kStack) {  // row = plane*kTH + i
      const int plane = row / kTH;
      gr = h0 + row % kTH;
      row_ok = gr < h_out;
      rbase = ((img * d0 + plane) * h_out + gr) * bw;
      gc0 = w0;
      gstep = 1;
    } else {       // row = r*s + phase
      const int r = row / s;
      gr = h0 * s + r;
      row_ok = gr < d0;
      rbase = (img * d0 + gr) * bw;
      gc0 = w0 * s + row % s;
      gstep = s;
    }
    int* dst_row = win + row * row_words;
    for (int q = lane; q < pw; q += 32) {
      const int gc = gc0 + q * gstep;
      const bool ok = row_ok && gc < bw;
      const int8_t* src = ok ? x + (rbase + gc) * C : x;
      int* dst = dst_row + q * CW;
      if (aligned) {
        if (C == 16) {
          vs::cp_async16(dst, src, ok);
        } else {
          vs::cp_async8(dst, src, ok);
        }
      } else {
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          dst[w] = ok ? static_cast<int>(load_word(src + 4 * w, false)) : 0;
        }
      }
    }
  }
  vs::cp_async_commit();
  // Window offset (words, from a lane's first pixel) and cin tile of each
  // stored id, decoded as given.
  const int ph_rows = kStack ? kTH : 1;
  const int ky_rows = kStack ? s * kTH : d * s;
  for (int t = threadIdx.x; t < s_steps; t += kThreads) {
    const int id = idx[static_cast<long long>(j) * s_steps + t];
    const int tap = id / cbg;
    const int ct = id - tap * cbg;
    const int ky = tap / kw;
    const int kx = tap - ky * kw;
    toff[t] = (ky * ky_rows + ((kx * d) % s) * ph_rows) * row_words +
              ((kx * d) / s) * CW + ct * (kVK / 4);
    tct[t] = ct;
  }
  // This thread's transpose of a chunk: tile u / (VN/2), k quad q, columns
  // 4*cw .. 4*cw+3.
  const int8_t* tiles = vals + static_cast<long long>(j) * s_steps * kVK * VN;
  const int u_tile = threadIdx.x / (VN / 2);
  const int u_q = (threadIdx.x / (VN / 4)) % (kVK / 4);
  const int u_cw = threadIdx.x % (VN / 4);
  unsigned raw[4];
  auto load_chunk = [&](int chunk) {  // rows 4q .. 4q+3 of 4 columns
    const int t = chunk * kChunk + u_tile;
    if (threadIdx.x < kUnits && t < s_steps) {
      const int8_t* p = tiles + (static_cast<long long>(t) * kVK + 4 * u_q) *
                                    VN + 4 * u_cw;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        raw[kk] = load_word(p + kk * VN, aligned);
      }
    }
  };
  auto store_chunk = [&](int chunk) {  // packed: word [q][col] = 4 k
    const int t = chunk * kChunk + u_tile;
    if (threadIdx.x < kUnits && t < s_steps) {
      const unsigned lo01 = __byte_perm(raw[0], raw[1], 0x5140);
      const unsigned hi01 = __byte_perm(raw[0], raw[1], 0x7362);
      const unsigned lo23 = __byte_perm(raw[2], raw[3], 0x5140);
      const unsigned hi23 = __byte_perm(raw[2], raw[3], 0x7362);
      int* dst = wbuf + (chunk & 1) * kChunkWords +
                 (u_tile * (kVK / 4) + u_q) * VN + 4 * u_cw;
      dst[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
      dst[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
      dst[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
      dst[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
    }
  };

  const int grp = lane >> 3;
  const int li = lane & 7;
  const int i = 2 * warp + (grp >> 1);  // output row in the tile
  const int col0 = grp & 1;             // first output column; then + 2
  const int x_off = i * (kStack ? 1 : s * s) * row_words + col0 * CW;
  float acc[P][CPL] = {};
  const int n_chunks = (s_steps + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    load_chunk(0);
    store_chunk(0);
  }
  int alive = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) load_chunk(chunk + 1);  // in flight meanwhile
    if (chunk == 0) vs::cp_async_wait<0>();
    __syncthreads();  // the window, this chunk and toff/tct are in place
    if (chunk == 0) {
      alive = skip ? window_votes_int8<C>(win, rows, row_words, pw) : ~0;
    }
    const int* wt = wbuf + (chunk & 1) * kChunkWords + li;
    const int t_end = min(s_steps, (chunk + 1) * kChunk);
    for (int t = chunk * kChunk; t < t_end; ++t, wt += (kVK / 4) * VN) {
      if (!((alive >> tct[t]) & 1)) continue;  // block-uniform
      int w_lo[CPL], w_hi[CPL];
#pragma unroll
      for (int m = 0; m < CPL; ++m) {
        w_lo[m] = wt[8 * m];
        w_hi[m] = wt[VN + 8 * m];
      }
      const int* xp = win + x_off + toff[t];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int2 a = *reinterpret_cast<const int2*>(xp + 2 * p * CW);
#pragma unroll
        for (int m = 0; m < CPL; ++m) {
          const int part =
              __dp4a(a.y, w_hi[m], __dp4a(a.x, w_lo[m], kMagicBits));
          acc[p][m] += __int_as_float(part) - kMagic;  // exact, in order
        }
      }
    }
    // the next chunk's buffer was last read before this chunk's barrier
    if (chunk + 1 < n_chunks) store_chunk(chunk + 1);
  }
  if (n_chunks == 0) vs::cp_async_wait<0>();

  // Epilogue, as `body`'s: masked at the image's right and bottom.
  const int h = h0 + i;
  if (h >= h_out) return;
  const int n_total = nb * VN;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int wc = w0 + col0 + 2 * p;
    if (wc >= w_out) continue;
    const long long o =
        ((img * h_out + h) * w_out + wc) * n_total + j * VN + li;
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int col = j * VN + li + 8 * m;
      float v = acc[p][m];
      if (scale) v = v * scale[col];
      if (bias) v = v + bias[col];
      if (residual) v = v + residual[o + 8 * m];
      if (relu && v < 0.f) v = 0.f;  // NaN passes through, as in max(v, 0)
      out[o + 8 * m] = v;
    }
  }
}

}  // namespace stem

#define VSCONV_STEM_PARAMS                                                  \
  const float *__restrict__ x, const float *__restrict__ vals,              \
      const int *__restrict__ idx, const float *__restrict__ scale,         \
      const float *__restrict__ bias, const float *__restrict__ residual,   \
      float *__restrict__ out, int d0, int bw, int h_out, int w_out, int kh, \
      int kw, int stride, int dilation, int nb, int s_steps, int cbg,       \
      int aligned, int relu, int skip
#define VSCONV_STEM_ARGS                                                    \
  x, vals, idx, scale, bias, residual, out, d0, bw, h_out, w_out, kh, kw,   \
      stride, dilation, nb, s_steps, cbg, aligned, relu, skip

template <int NC, int C>
__global__ void __launch_bounds__(stem::kThreads, 4)
    vsconv_halo_stem_kernel(VSCONV_STEM_PARAMS) {
  stem::body<NC, C, false>(VSCONV_STEM_ARGS);
}

template <int NC, int C>
__global__ void __launch_bounds__(stem::kThreads, 4)
    vsconv_stack_stem_kernel(VSCONV_STEM_PARAMS) {
  stem::body<NC, C, true>(VSCONV_STEM_ARGS);
}

#define VSCONV_STEM_INT8_PARAMS                                             \
  const int8_t *__restrict__ x, const int8_t *__restrict__ vals,            \
      const int *__restrict__ idx, const float *__restrict__ scale,         \
      const float *__restrict__ bias, const float *__restrict__ residual,   \
      float *__restrict__ out, int d0, int bw, int h_out, int w_out, int kh, \
      int kw, int stride, int dilation, int nb, int s_steps, int cbg,       \
      int aligned, int relu, int skip

template <int NC, int C>
__global__ void __launch_bounds__(stem::kThreads, 4)
    vsconv_halo_stem_int8_kernel(VSCONV_STEM_INT8_PARAMS) {
  stem::body_int8<NC, C, false>(VSCONV_STEM_ARGS);
}

template <int NC, int C>
__global__ void __launch_bounds__(stem::kThreads, 4)
    vsconv_stack_stem_int8_kernel(VSCONV_STEM_INT8_PARAMS) {
  stem::body_int8<NC, C, true>(VSCONV_STEM_ARGS);
}

template <int NC, int C, class T>
int stem_launch_one(bool stack, int n_img, void* stream,
                    const T* __restrict__ x, const T* __restrict__ vals,
                    const int* __restrict__ idx,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ residual,
                    float* __restrict__ out, int d0, int bw, int h_out,
                    int w_out, int kh, int kw, int stride, int dilation,
                    int nb, int s_steps, int cbg, int aligned, int relu,
                    int skip) {
  constexpr bool kInt8 = sizeof(T) == 1;
  void (*kernel)(const T*, const T*, const int*, const float*, const float*,
                 const float*, float*, int, int, int, int, int, int, int,
                 int, int, int, int, int, int, int);
  if constexpr (kInt8) {
    kernel = stack ? vsconv_stack_stem_int8_kernel<NC, C>
                   : vsconv_halo_stem_int8_kernel<NC, C>;
  } else {
    kernel = stack ? vsconv_stack_stem_kernel<NC, C>
                   : vsconv_halo_stem_kernel<NC, C>;
  }
  const size_t smem =
      kInt8 ? stem::smem_bytes_int8(stack, C, 32 * NC, kh, kw, stride,
                                    dilation, s_steps)
            : stem::smem_bytes(stack, C, 32 * NC, kh, kw, stride, dilation,
                               s_steps);
  if (smem > stem::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long tiles =
      static_cast<long long>(n_img) * ((h_out + stem::kTH - 1) / stem::kTH) *
      ((w_out + stem::kTW - 1) / stem::kTW);
  const dim3 grid(static_cast<unsigned>(tiles), nb);
  kernel<<<grid, stem::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      VSCONV_STEM_ARGS);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int stem_launch(bool stack, int n_img, int cb, int vk, int vn,
                void* stream, const T* x, const T* vals, const int* idx,
                const float* scale, const float* bias, const float* residual,
                float* out, int d0, int bw, int h_out, int w_out, int kh,
                int kw, int stride, int dilation, int nb, int s_steps,
                int cbg, int aligned, int relu, int skip) {
  const int c = cb * vk;
  if (vk != stem::kVK) return static_cast<int>(cudaErrorInvalidValue);
  if (vn == 32 && c == 8) {
    return stem_launch_one<1, 8>(stack, n_img, stream, VSCONV_STEM_ARGS);
  }
  if (vn == 32 && c == 16) {
    return stem_launch_one<1, 16>(stack, n_img, stream, VSCONV_STEM_ARGS);
  }
  if (vn == 64 && c == 8) {
    return stem_launch_one<2, 8>(stack, n_img, stream, VSCONV_STEM_ARGS);
  }
  if (vn == 64 && c == 16) {
    return stem_launch_one<2, 16>(stack, n_img, stream, VSCONV_STEM_ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#define VSCONV_PARAMS(T)                                                     \
  const T *x, const T *vals, const int *idx, const float *scale,             \
      const float *bias, const float *residual, float *out, void *work,      \
      int n_img, int d0, int bw, int cb, int h_out, int w_out, int kw,       \
      int stride, int dilation, int nb, int s_steps, int vk, int vn,         \
      int cbg, int spg, int relu, int skip, int rows, int splits

template <bool kStack, class T>
int generic_launch(VSCONV_PARAMS(T), void* stream) {
  gen::Conv a{x, vals, idx, scale, bias, residual, out, work,
              static_cast<long long>(n_img) * h_out * w_out, d0, bw, cb,
              h_out, w_out, kw, stride, dilation, nb, s_steps, vk, vn, cbg,
              spg, relu, skip, splits, 0, 0, 0};
  return gen::launch<kStack>(a, sizeof(T) == 1, rows,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching for a plan or shape the body
// does not take.  Any of scale, bias and residual may be null.  `rows`
// and `splits` are the plan (kernels/vsconv.py::conv_plan); `work` is the
// workspace for splits > 1 (splits * M * N floats; int8: int32 pairs),
// else may be null.  The caller has checked shapes, dtypes, contiguity,
// vk <= 32, vn <= 128, the group split and that every tap stays inside
// the input buffer.
extern "C" int vsconv_halo_launch(VSCONV_PARAMS(float), void* stream) {
  return generic_launch<false>(x, vals, idx, scale, bias, residual, out,
                               work, n_img, d0, bw, cb, h_out, w_out, kw,
                               stride, dilation, nb, s_steps, vk, vn, cbg,
                               spg, relu, skip, rows, splits, stream);
}

// The int8 branch of the halo kernel's generic body: xh and vals int8,
// scale (the combined dequant scale, a power of two per column) given.
extern "C" int vsconv_halo_int8_launch(VSCONV_PARAMS(int8_t), void* stream) {
  return generic_launch<false>(x, vals, idx, scale, bias, residual, out,
                               work, n_img, d0, bw, cb, h_out, w_out, kw,
                               stride, dilation, nb, s_steps, vk, vn, cbg,
                               spg, relu, skip, rows, splits, stream);
}

extern "C" int vsconv_stack_launch(VSCONV_PARAMS(float), void* stream) {
  return generic_launch<true>(x, vals, idx, scale, bias, residual, out,
                              work, n_img, d0, bw, cb, h_out, w_out, kw,
                              stride, dilation, nb, s_steps, vk, vn, cbg,
                              spg, relu, skip, rows, splits, stream);
}

// The int8 branch of the stack kernel: xt and vals int8, scale given, as
// the halo kernel's.
extern "C" int vsconv_stack_int8_launch(VSCONV_PARAMS(int8_t),
                                        void* stream) {
  return generic_launch<true>(x, vals, idx, scale, bias, residual, out,
                              work, n_img, d0, bw, cb, h_out, w_out, kw,
                              stride, dilation, nb, s_steps, vk, vn, cbg,
                              spg, relu, skip, rows, splits, stream);
}

// The stem body of the two kernels (see the header).  Same arguments as
// above, plus kh and `aligned` (1 when x and vals are 16-byte aligned:
// 16-byte copies, else 4-byte ones).  The caller has checked the stem rule
// (`use_stem_body`: groups == 1, vk 8, CB*vk of 8 or 16, vn 32 or 64); any
// other shape, or a window over the shared memory, returns
// cudaErrorInvalidValue without launching.
extern "C" int vsconv_halo_stem_launch(
    const float* xh, const float* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img, int rows,
    int bw, int cb, int h_out, int w_out, int kw, int stride, int dilation,
    int nb, int s_steps, int vk, int vn, int cbg, int spg, int relu,
    int skip, int kh, int aligned, void* stream) {
  (void)spg;  // one group: every strip reads cin tiles 0..cb-1
  return stem_launch(false, n_img, cb, vk, vn, stream, xh, vals, idx, scale,
                     bias, residual, out, rows, bw, h_out, w_out, kh, kw,
                     stride, dilation, nb, s_steps, cbg, aligned, relu,
                     skip);
}

extern "C" int vsconv_stack_stem_launch(
    const float* xt, const float* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img,
    int planes, int bw, int cb, int h_out, int w_out, int kw, int stride,
    int dilation, int nb, int s_steps, int vk, int vn, int cbg, int spg,
    int relu, int skip, int kh, int aligned, void* stream) {
  (void)spg;
  return stem_launch(true, n_img, cb, vk, vn, stream, xt, vals, idx, scale,
                     bias, residual, out, planes, bw, h_out, w_out, kh, kw,
                     stride, dilation, nb, s_steps, cbg, aligned, relu,
                     skip);
}

// The int8 stem body of the two kernels: xh / xt and vals int8, scale
// (the combined dequant scale, a power of two per column) given; the same
// arguments as the f32 stem entries, `aligned` 1 when x and vals are
// 16-byte aligned (cp.async and word loads; else byte loads).
extern "C" int vsconv_halo_stem_int8_launch(
    const int8_t* xh, const int8_t* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img,
    int rows, int bw, int cb, int h_out, int w_out, int kw, int stride,
    int dilation, int nb, int s_steps, int vk, int vn, int cbg, int spg,
    int relu, int skip, int kh, int aligned, void* stream) {
  (void)spg;
  return stem_launch(false, n_img, cb, vk, vn, stream, xh, vals, idx, scale,
                     bias, residual, out, rows, bw, h_out, w_out, kh, kw,
                     stride, dilation, nb, s_steps, cbg, aligned, relu,
                     skip);
}

extern "C" int vsconv_stack_stem_int8_launch(
    const int8_t* xt, const int8_t* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img,
    int planes, int bw, int cb, int h_out, int w_out, int kw, int stride,
    int dilation, int nb, int s_steps, int vk, int vn, int cbg, int spg,
    int relu, int skip, int kh, int aligned, void* stream) {
  (void)spg;
  return stem_launch(true, n_img, cb, vk, vn, stream, xt, vals, idx, scale,
                     bias, residual, out, planes, bw, h_out, w_out, kh, kw,
                     stride, dilation, nb, s_steps, cbg, aligned, relu,
                     skip);
}
