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
//                       wrappers' `use_stem_body` for narrow inputs.
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
// Generic body.  One block per (tile of kRows flattened output pixels over
// N*Hout*Wout, output strip j).  Step s decodes t = idx[j, s] into tap
// (ky, kx) and cin tile; the two layouts differ only in where that tap's
// activation sits:
//
//   halo  xh (N, rows, bW, CB, vk), `build_halo_input`'s SAME-padded NHWC
//         input: output pixel (i, jj) reads padded pixel
//         (ky*d + stride*i, kx*d + stride*jj) — the tap is resolved in the
//         kernel, no tap-shifted copy of the input exists;
//   stack xt (N, kh*stride, Hout, bW, C), `build_row_tap_stack`'s planes:
//         output pixel (i, jj) reads plane ky*stride + (kx*d) % stride,
//         row i, column jj + (kx*d) / stride.
//
// Each pixel's base offset is computed once per block, each step's tap
// offset once per step.  The ids are decoded as given, in stored
// (cin-major) order.  Zero-skip and epilogue are those of vsmm
// (vs_tile.cuh), the residual being the output-shaped ResNet shortcut.
// Both kernels' generic body has an int8 branch as vsmm's
// (vsconv_halo_int8_kernel, vsconv_stack_int8_kernel; vs_tile.cuh,
// Step<int8_t>): int8 buffer and tiles, each step's partial exact in
// int32, added into the f32 accumulator in stored order.  Pixel bases and
// tap offsets stay in elements (bytes, for int8); every row offset is a
// multiple of vk, so int8 rows load as 32-bit words where vk % 4 == 0 and
// the buffer is 4-byte aligned.  Int8 convs never take the stem body (it
// stages f32 windows; the wrapper's `use_stem_body` says so).
//
// Every entry takes `skip`: 0 is the reference's skip_zero_inputs=False
// (the paper's dense-input mode): no vote, every stored tile's MAC runs.
// A skipped tile would add exact zeros, so the output has the same bits
// with the skip on or off.
//
// Stem body (ungrouped, vk 8, C = CB*vk of 8 or 16 input channels, vn 32
// or 64, kh*kw > 1: the CNN stems after cin padding 3 -> 8).  The generic
// body spends a barrier, a weight restage and a 32 x vk gather on every
// stored tile and leaves 2-3 of a lane's 4 columns idle at vn <= 64.  Here
// one block of 4 warps owns a 2-D tile of kTH x kTW = 8 x 16 output pixels
// of one image and one output strip j.  It stages once, with cp.async,
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
// stored order.  The epilogue is vs::epilogue's, masked at the tile's
// right and bottom edges.
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores (no tensor cores:
// TF32 would break the 1e-5 agreement with the f32 reference) and the
// bytes of the input, the stored tiles, the output and the residual.  The
// stack layout adds kh*stride output-sized planes written before the
// kernel (the reference keeps it as the oracle and fallback).  The generic
// body reads each tap's activation tile from L2 per step; the stem body
// reads its window once per block and is bound by FMAs and the shared-
// memory loads that feed them.
#include "vs_async.cuh"
#include "vs_tile.cuh"

namespace {

// Decodes a stored id t into its tap (ky, kx) and cin tile ct.  `t` is
// group-relative; `group_base` is the strip's first cin tile.
struct TapDecode {
  int cbg, kw;
  __device__ __forceinline__ void operator()(int t, int group_base, int& ky,
                                             int& kx, int& ct) const {
    const int tap = t / cbg;
    ct = group_base + (t - tap * cbg);
    ky = tap / kw;
    kx = tap - ky * kw;
  }
};

// Writes pix[r] = base(img, i, jj) for the block's rows r < rows_valid.
template <class Base>
__device__ __forceinline__ void pixel_bases(long long* pix, long long p0,
                                            int rows_valid, int h_out,
                                            int w_out, Base base) {
  if (threadIdx.x < vs::kRows) {
    long long b = 0;
    if (static_cast<int>(threadIdx.x) < rows_valid) {
      const long long p = p0 + threadIdx.x;
      const long long hw = static_cast<long long>(h_out) * w_out;
      const long long img = p / hw;
      const long long rem = p - img * hw;
      const long long i = rem / w_out;
      b = base(img, i, rem - i * w_out);
    }
    pix[threadIdx.x] = b;
  }
}

// acc += the strip's S stored tiles against the activations they select:
// `step_offset(t)` is the offset of id t's activation tile from a pixel's
// base.  T is the element type (vs_tile.cuh's Step<T>); `words`: int8
// activation rows load as 32-bit words (vs::word_rows).
template <class T, class StepOffset>
__device__ __forceinline__ void conv_steps(
    float (&acc)[vs::kRowsPerThread][vs::kColsPerThread],
    const T* __restrict__ x, const T* __restrict__ vals,
    const int* __restrict__ idx, const long long* pix, int rows_valid, int j,
    int s_steps, int vk, int vn, typename vs::Step<T>::Word* ws,
    typename vs::Step<T>::Word* xs, int skip, bool words,
    StepOffset step_offset) {
  using Step = vs::Step<T>;
  for (int s = 0; s < s_steps; ++s) {
    const long long tile = static_cast<long long>(j) * s_steps + s;
    const long long off = step_offset(idx[tile]);
    __syncthreads();  // pix is written; the previous MAC is done with smem
    Step::load_weights(ws, vals, tile, vk, vn);
    const int nonzero = Step::load_acts(
        xs, vk, rows_valid, words, [&](int r) { return x + pix[r] + off; });
    if (__syncthreads_or(nonzero || !skip)) Step::mac(acc, xs, ws, vk, vn);
  }
}

// The halo kernel's generic body for element type T (float, or int8_t:
// the int8 branch).
template <class T>
__device__ __forceinline__ void halo_body(
    const T* __restrict__ xh, const T* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int n_img, int rows, int bw, int cb, int h_out,
    int w_out, int kw, int stride, int dilation, int nb, int s_steps, int vk,
    int vn, int cbg, int spg, int relu, int skip, bool words) {
  using Word = typename vs::Step<T>::Word;
  extern __shared__ __align__(16) unsigned char halo_smem[];
  __shared__ long long pix[vs::kRows];  // padded-input offset of each pixel
  Word* ws = reinterpret_cast<Word*>(halo_smem);
  Word* xs = ws + vs::Step<T>::weight_words(vk, vn);
  const int j = blockIdx.y;
  const long long c = static_cast<long long>(cb) * vk;  // channels
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const long long p0 = static_cast<long long>(blockIdx.x) * vs::kRows;
  const int rows_valid =
      static_cast<int>(min(static_cast<long long>(vs::kRows), p_total - p0));
  pixel_bases(pix, p0, rows_valid, h_out, w_out,
              [=](long long img, long long i, long long jj) {
                return ((img * rows + stride * i) * bw + stride * jj) * c;
              });
  const TapDecode dec{cbg, kw};
  const int group_base = (j / spg) * cbg;
  float acc[vs::kRowsPerThread][vs::kColsPerThread] = {};
  conv_steps<T>(acc, xh, vals, idx, pix, rows_valid, j, s_steps, vk, vn, ws,
                xs, skip, words, [=](int t) {
                  int ky, kx, ct;
                  dec(t, group_base, ky, kx, ct);
                  return (static_cast<long long>(ky) * dilation * bw +
                          static_cast<long long>(kx) * dilation) * c +
                         static_cast<long long>(ct) * vk;
                });
  vs::epilogue(acc, out, p0, rows_valid, nb * vn, j * vn, vn, scale, bias,
               residual, relu);
}

#define VSCONV_PARAMS(T)                                                     \
  const T *__restrict__ x, const T *__restrict__ vals,                       \
      const int *__restrict__ idx, const float *__restrict__ scale,          \
      const float *__restrict__ bias, const float *__restrict__ residual,    \
      float *__restrict__ out, int n_img, int d0, int bw, int cb, int h_out, \
      int w_out, int kw, int stride, int dilation, int nb, int s_steps,      \
      int vk, int vn, int cbg, int spg, int relu, int skip
#define VSCONV_ARGS                                                          \
  x, vals, idx, scale, bias, residual, out, n_img, d0, bw, cb, h_out, w_out, \
      kw, stride, dilation, nb, s_steps, vk, vn, cbg, spg, relu, skip

__global__ void __launch_bounds__(vs::kThreads)
    vsconv_halo_kernel(VSCONV_PARAMS(float)) {
  halo_body<float>(VSCONV_ARGS, false);
}

__global__ void __launch_bounds__(vs::kThreads)
    vsconv_halo_int8_kernel(VSCONV_PARAMS(int8_t), int words) {
  halo_body<int8_t>(VSCONV_ARGS, words != 0);
}

// The stack kernel's generic body for element type T (float, or int8_t:
// the int8 branch).
template <class T>
__device__ __forceinline__ void stack_body(
    const T* __restrict__ xt, const T* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int n_img, int planes, int bw, int cb,
    int h_out, int w_out, int kw, int stride, int dilation, int nb,
    int s_steps, int vk, int vn, int cbg, int spg, int relu, int skip,
    bool words) {
  using Word = typename vs::Step<T>::Word;
  extern __shared__ __align__(16) unsigned char stack_smem[];
  __shared__ long long pix[vs::kRows];  // stack offset of each pixel
  Word* ws = reinterpret_cast<Word*>(stack_smem);
  Word* xs = ws + vs::Step<T>::weight_words(vk, vn);
  const int j = blockIdx.y;
  const long long c = static_cast<long long>(cb) * vk;  // channels
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const long long p0 = static_cast<long long>(blockIdx.x) * vs::kRows;
  const int rows_valid =
      static_cast<int>(min(static_cast<long long>(vs::kRows), p_total - p0));
  pixel_bases(pix, p0, rows_valid, h_out, w_out,
              [=](long long img, long long i, long long jj) {
                return ((img * planes * h_out + i) * bw + jj) * c;
              });
  const TapDecode dec{cbg, kw};
  const int group_base = (j / spg) * cbg;
  float acc[vs::kRowsPerThread][vs::kColsPerThread] = {};
  conv_steps<T>(acc, xt, vals, idx, pix, rows_valid, j, s_steps, vk, vn, ws,
                xs, skip, words, [=](int t) {
                  int ky, kx, ct;
                  dec(t, group_base, ky, kx, ct);
                  const int plane = ky * stride + (kx * dilation) % stride;
                  const int col = (kx * dilation) / stride;
                  return (static_cast<long long>(plane) * h_out * bw + col) *
                             c +
                         static_cast<long long>(ct) * vk;
                });
  vs::epilogue(acc, out, p0, rows_valid, nb * vn, j * vn, vn, scale, bias,
               residual, relu);
}

__global__ void __launch_bounds__(vs::kThreads)
    vsconv_stack_kernel(VSCONV_PARAMS(float)) {
  stack_body<float>(VSCONV_ARGS, false);
}

__global__ void __launch_bounds__(vs::kThreads)
    vsconv_stack_int8_kernel(VSCONV_PARAMS(int8_t), int words) {
  stack_body<int8_t>(VSCONV_ARGS, words != 0);
}

template <class T, class Kernel, class... Extra>
int launch(Kernel kernel, void* stream, VSCONV_PARAMS(T), Extra... extra) {
  const size_t smem = vs::Step<T>::smem_bytes(vk, vn);
  if (smem > 48 * 1024 - vs::kRows * sizeof(long long)) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const dim3 grid(static_cast<unsigned>((p_total + vs::kRows - 1) / vs::kRows),
                  nb);
  kernel<<<grid, vs::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      VSCONV_ARGS, extra...);
  return static_cast<int>(cudaGetLastError());
}

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

  // Epilogue, as vs::epilogue: masked at the image's right and bottom.
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

template <int NC, int C>
int stem_launch_one(bool stack, int n_img, void* stream,
                    VSCONV_STEM_PARAMS) {
  auto kernel = stack ? vsconv_stack_stem_kernel<NC, C>
                      : vsconv_halo_stem_kernel<NC, C>;
  const size_t smem = stem::smem_bytes(stack, C, 32 * NC, kh, kw, stride,
                                       dilation, s_steps);
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

int stem_launch(bool stack, int n_img, int cb, int vk, int vn,
                void* stream, VSCONV_STEM_PARAMS) {
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

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success).  Any
// of scale, bias and residual may be null.  The caller has checked shapes,
// dtypes, contiguity, vn <= 128, the group split and that every tap stays
// inside the input buffer.
extern "C" int vsconv_halo_launch(VSCONV_PARAMS(float), void* stream) {
  return launch<float>(vsconv_halo_kernel, stream, VSCONV_ARGS);
}

// The int8 branch of the halo kernel's generic body: xh and vals int8,
// scale (the combined dequant scale, a power of two per column) given.
extern "C" int vsconv_halo_int8_launch(VSCONV_PARAMS(int8_t), void* stream) {
  return launch<int8_t>(vsconv_halo_int8_kernel, stream, VSCONV_ARGS,
                        static_cast<int>(vs::word_rows(x, vk)));
}

extern "C" int vsconv_stack_launch(VSCONV_PARAMS(float), void* stream) {
  return launch<float>(vsconv_stack_kernel, stream, VSCONV_ARGS);
}

// The int8 branch of the stack kernel: xt and vals int8, scale given, as
// the halo kernel's.
extern "C" int vsconv_stack_int8_launch(VSCONV_PARAMS(int8_t),
                                        void* stream) {
  return launch<int8_t>(vsconv_stack_int8_kernel, stream, VSCONV_ARGS,
                        static_cast<int>(vs::word_rows(x, vk)));
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
