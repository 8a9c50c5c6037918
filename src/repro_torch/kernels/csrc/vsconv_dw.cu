// vsconv_dw: depthwise (groups == C, multiplier 1) vector-sparse SAME
// convolution over two input layouts, hand-written for Hopper (sm_90a).
//
//   vsconv_dw_halo_kernel  replaces kernels/vsconv.py::vsconv_dw_halo_pallas
//                          of the JAX package (body `_dw_halo_kernel`);
//   vsconv_dw_stack_kernel replaces kernels/vsconv.py::vsconv_dw_stack_pallas
//                          (body `_dw_stack_kernel`).
//
//   out (N, Hout, Wout, C) = depthwise conv of the input with the
//   (kh*kw, C) tap matrix encoded vk = 1 over vc-channel strips: stored tap
//   vectors vals (NB, S, 1, vc), tap ids idx (NB, S) — idx[j, s] is the
//   BARE tap id t = ky*kw + kx of channel tile j, not tap*CB + tile as in
//   the full conv; then x scale, + bias, + residual, ReLU.
//
// One block per (2-D tile of th x tw output pixels of one image, channel
// tile j).  th, tw and the block's threads are runtime values the wrapper
// picks per layer (`vsconv_dw.py::dw_tile`: halo, square-ish tiles of
// about 4096 output elements and 256 threads; stack, one output row of
// about 1024 elements and 128 threads; a window of at most 64 KB, at least
// two blocks per SM, a whole image dimension where it is less than two
// tiles).  The block stages once, with cp.async (16-byte
// copies along the channels where vc % 4 == 0 and the input is aligned),
//   - its input window, every pixel its taps reach, vc channels each:
//     halo  ((th-1)*s + (kh-1)*d + 1) x ((tw-1)*s + (kw-1)*d + 1) pixels
//           of `build_halo_input(x, vk=vc)`'s SAME-padded buffer
//           xh (N, rows, bW, CB, vc) (dw1 at 8 x 16: 23 KB);
//     stack the kh*s planes' th rows x (tw + (kw-1)*d / s) columns of
//           `build_row_tap_stack`'s xt (N, kh*stride, Hout, bW, C);
//   - the strip's S stored tap vectors (S x vc floats) and each tap's
//     window offset, decoded from idx as given.
// The stack layout stages only the planes a stored tap reads, as the
// reference fetches an input block per stored step (at stride 2 a strip
// without a stored kx = 1 tap leaves the odd-phase planes unread).
// Then one barrier-free loop: a thread takes (pixel, group of VEC = 4 or 1
// channels) elements, channel groups fastest (a warp's loads are
// consecutive 16-byte words), and adds each stored tap in stored order
// with fmaf, as the previous kernel did, so the result is the same.  The
// input-side skip is one vote per (block window, channel tile), taken
// over the staged window: an all-zero window adds no FMAs (they would add
// exact zeros).  `skip` 0 (the reference's skip_zero_inputs=False, the
// paper's dense-input mode) takes no vote and runs every FMA: the same
// bits.  The epilogue stores VEC channels at once, masked at the
// image's right and bottom edges.  Window offsets are 32-bit (shared memory);
// global offsets are 64-bit once per staged row or output element.
//
// Instantiations: VC = 32, 64, 128 (MobileNetV1's channel tiles) with
// VEC 4, and any other runtime vc <= 128 (VC = 0) with VEC 4 or 1.
//
// Both kernels have an int8 branch (vsconv_dw_halo_int8_kernel,
// vsconv_dw_stack_int8_kernel, the same instantiations): int8 window and
// taps, a quarter of the bytes, four channels a 4-byte cp.async (one byte
// a plain load at VEC 1), converted to f32 for the fmaf MAC in stored tap
// order, exact for int8 values (every product and sum is an integer below
// 2^24), so bit-equal to the reference's `_dw_flush`.
//
// What bounds it on an H100: bytes.  Each output element costs S FMAs
// against one input element, so the least traffic (the input once, the
// taps, the output once) bounds it; each block reads its window's halo
// beside its own pixels, from L2 where neighbouring blocks share it.  The
// stack layout reads its planes: kh*stride output-sized copies of the
// input (three times its bytes at stride 1), which the halo layout does
// not move.
#include "vs_async.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

// Window pixels (x rows, y columns) of a th x tw tile.
__host__ __device__ inline int2 window_dims(bool stack, int th, int tw,
                                            int kh, int kw, int stride,
                                            int dilation) {
  if (stack) {  // row = plane * th + i
    return make_int2(kh * stride * th, tw + ((kw - 1) * dilation) / stride);
  }
  return make_int2((th - 1) * stride + (kh - 1) * dilation + 1,
                   (tw - 1) * stride + (kw - 1) * dilation + 1);
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// Shared memory of one block: the window and the stored taps (T each,
// every region 16-byte aligned), then each tap's window offset.
template <class T>
size_t smem_bytes(bool stack, int th, int tw, int kh, int kw, int stride,
                  int dilation, int s_steps, int vc) {
  const int2 win = window_dims(stack, th, tw, kh, kw, stride, dilation);
  return align16(sizeof(T) * static_cast<size_t>(win.x) * win.y * vc) +
         align16(sizeof(T) * static_cast<size_t>(s_steps) * vc) +
         sizeof(int) * static_cast<size_t>(s_steps);
}

// VEC channels of element type T: the staged vector V, its copy into
// shared memory, and its f32 value F (the accumulator's type).
template <class T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using V = float4;
  using F = float4;
  __device__ static void copy(float* dst, const float* src, bool ok) {
    vs::cp_async16(dst, src, ok);
  }
  __device__ static F to_f32(V v) { return v; }
};
template <>
struct Vec<float, 1> {
  using V = float;
  using F = float;
  __device__ static void copy(float* dst, const float* src, bool ok) {
    vs::cp_async4(dst, src, ok);
  }
  __device__ static F to_f32(V v) { return v; }
};
// int8: four channels a 4-byte cp.async, or one byte a plain load and
// store (cp.async copies 4, 8 or 16 bytes).  Converted to f32 for the MAC:
// every product (<= 127^2) and every sum (<= kh*kw*127^2) is an exact
// integer in f32, so the result is the reference's f32 MAC bit for bit.
template <>
struct Vec<int8_t, 4> {
  using V = char4;
  using F = float4;
  __device__ static void copy(int8_t* dst, const int8_t* src, bool ok) {
    vs::cp_async4(dst, src, ok);
  }
  __device__ static F to_f32(V v) {
    return make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                       static_cast<float>(v.z), static_cast<float>(v.w));
  }
};
template <>
struct Vec<int8_t, 1> {
  using V = int8_t;
  using F = float;
  __device__ static void copy(int8_t* dst, const int8_t* src, bool ok) {
    *dst = ok ? *src : static_cast<int8_t>(0);
  }
  __device__ static F to_f32(V v) { return static_cast<float>(v); }
};

__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}
__device__ __forceinline__ bool nonzero(float v) { return v != 0.f; }
__device__ __forceinline__ bool nonzero(char4 v) {
  return (v.x | v.y | v.z | v.w) != 0;
}
__device__ __forceinline__ bool nonzero(int8_t v) { return v != 0; }

__device__ __forceinline__ void fma_vec(float4& acc, float4 x, float4 w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.y = fmaf(x.y, w.y, acc.y);
  acc.z = fmaf(x.z, w.z, acc.z);
  acc.w = fmaf(x.w, w.w, acc.w);
}
__device__ __forceinline__ void fma_vec(float& acc, float x, float w) {
  acc = fmaf(x, w, acc);
}

// The epilogue of one channel: x scale, + bias, + residual, ReLU.
__device__ __forceinline__ float finish(
    float y, long long col, long long o, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    int relu) {
  if (scale) y = y * scale[col];
  if (bias) y = y + bias[col];
  if (residual) y = y + residual[o];
  if (relu && y < 0.f) y = 0.f;  // NaN passes through, as in max(v, 0)
  return y;
}

__device__ __forceinline__ void finish_vec(
    float4& a, long long col, long long o, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    int relu) {
  a.x = finish(a.x, col, o, scale, bias, residual, relu);
  a.y = finish(a.y, col + 1, o + 1, scale, bias, residual, relu);
  a.z = finish(a.z, col + 2, o + 2, scale, bias, residual, relu);
  a.w = finish(a.w, col + 3, o + 3, scale, bias, residual, relu);
}
__device__ __forceinline__ void finish_vec(
    float& a, long long col, long long o, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    int relu) {
  a = finish(a, col, o, scale, bias, residual, relu);
}

__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(float& a) { a = 0.f; }

// The whole block.  T is the element type of x and vals (float, or
// int8_t: the int8 branch); VC = vc when > 0 (else the runtime vc_rt), VEC
// channels a copy and a thread's element; kStack picks the layout.
template <class T, int VC, int VEC, bool kStack>
__device__ __forceinline__ void dw_body(
    const T* __restrict__ x, const T* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int n_img, int d0, int bw, int cb, int h_out,
    int w_out, int kh, int kw, int stride, int dilation, int s_steps,
    int vc_rt, int th, int tw, int relu, int skip) {
  using Vt = Vec<T, VEC>;
  using V = typename Vt::V;
  using F = typename Vt::F;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  const int vc = VC > 0 ? VC : vc_rt;
  const int groups = vc / VEC;  // channel groups of a pixel
  const int s = stride, d = dilation;
  const int tiles_w = (w_out + tw - 1) / tw;
  const int tiles_h = (h_out + th - 1) / th;
  const int tw_i = blockIdx.x % tiles_w;
  const int th_i = (blockIdx.x / tiles_w) % tiles_h;
  const long long img = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = th_i * th, w0 = tw_i * tw;
  const int j = blockIdx.y;
  const long long c_total = static_cast<long long>(cb) * vc;
  (void)n_img;  // the grid covers the images
  const int2 win_dims = window_dims(kStack, th, tw, kh, kw, s, d);
  const int rows = win_dims.x, cols = win_dims.y;
  T* win = reinterpret_cast<T*>(dw_smem);
  T* wsm = reinterpret_cast<T*>(
      dw_smem + align16(sizeof(T) * static_cast<size_t>(rows) * cols * vc));
  int* toff = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(wsm) +
      align16(sizeof(T) * static_cast<size_t>(s_steps) * vc));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int threads = blockDim.x;
  const long long ch0 = static_cast<long long>(j) * vc;

  const T* taps = vals + ch0 * s_steps;
  for (int e = threadIdx.x * VEC; e < s_steps * vc; e += threads * VEC) {
    Vt::copy(wsm + e, taps + e, true);
  }
  // Stack: the planes ky*s + (kx*d) % s the strip's stored taps read; only
  // those are staged and voted on (the weight-side skip carried to the
  // input, as the reference fetches an input block per stored step).  Each
  // warp reads the ids a lane each and ORs them.
  unsigned planes = ~0u;
  if (kStack) {
    planes = 0;
    for (int t0 = 0; t0 < s_steps; t0 += 32) {
      unsigned bit = 0;
      if (t0 + lane < s_steps) {
        const int tap = idx[static_cast<long long>(j) * s_steps + t0 + lane];
        const int ky = tap / kw;
        bit = 1u << (ky * s + ((tap - ky * kw) * d) % s);
      }
      planes |= __reduce_or_sync(0xffffffffu, bit);
    }
  }
  auto row_read = [&](int row) {
    return !kStack || ((planes >> (row / th)) & 1u);
  };

  // Stage the window: warp-strided rows, lane-strided VEC-wide units along
  // a row; pixels outside the buffer read zeros.
  for (int row = warp; row < rows; row += threads / 32) {
    if (!row_read(row)) continue;
    long long rbase;
    int gc0;
    bool row_ok;
    if (kStack) {  // row = plane * th + i
      const int gr = h0 + row % th;
      row_ok = gr < h_out;
      rbase = ((img * d0 + row / th) * h_out + gr) * bw;
      gc0 = w0;
    } else {
      const int gr = h0 * s + row;
      row_ok = gr < d0;
      rbase = (img * d0 + gr) * bw;
      gc0 = w0 * s;
    }
    for (int u = lane; u < cols * groups; u += 32) {
      const int q = u / groups;
      const int g = u - q * groups;
      const int gc = gc0 + q;
      const bool ok = row_ok && gc < bw;
      const T* src = ok ? x + (rbase + gc) * c_total + ch0 + g * VEC : x;
      Vt::copy(win + (row * cols + q) * vc + g * VEC, src, ok);
    }
  }
  vs::cp_async_commit();
  // Window offset (pixels) of each stored tap from an output pixel's base.
  for (int t = threadIdx.x; t < s_steps; t += threads) {
    const int tap = idx[static_cast<long long>(j) * s_steps + t];
    const int ky = tap / kw;
    const int kx = tap - ky * kw;
    toff[t] = kStack ? ((ky * s + (kx * d) % s) * th) * cols + (kx * d) / s
                     : ky * d * cols + kx * d;
  }

  vs::cp_async_wait<0>();
  __syncthreads();

  // The input-side skip: one vote per (block window, channel tile), over
  // what was staged (none with `skip` 0: every tap's FMA runs).
  bool alive = true;
  if (skip) {
    int nz = 0;
    for (int row = warp; row < rows; row += threads / 32) {
      if (!row_read(row)) continue;
      const V* wv = reinterpret_cast<const V*>(win + row * cols * vc);
      for (int u = lane; u < cols * groups; u += 32) nz |= nonzero(wv[u]);
    }
    alive = __syncthreads_or(nz);
  }

  const int elems = th * tw * groups;
  for (int e = threadIdx.x; e < elems; e += threads) {
    const int p = e / groups;
    const int g = e - p * groups;
    const int i = p / tw;
    const int jj = p - i * tw;
    if (h0 + i >= h_out || w0 + jj >= w_out) continue;
    const int base = kStack ? i * cols + jj : (i * s) * cols + jj * s;
    F acc;
    zero(acc);
    if (alive) {
      const T* xg = win + g * VEC;
      const T* wg = wsm + g * VEC;
      for (int t = 0; t < s_steps; ++t) {
        const V xv = *reinterpret_cast<const V*>(xg + (base + toff[t]) * vc);
        const V w = *reinterpret_cast<const V*>(wg + t * vc);
        fma_vec(acc, Vt::to_f32(xv), Vt::to_f32(w));
      }
    }
    const long long o =
        ((img * h_out + h0 + i) * w_out + w0 + jj) * c_total + ch0 + g * VEC;
    finish_vec(acc, ch0 + g * VEC, o, scale, bias, residual, relu);
    *reinterpret_cast<F*>(out + o) = acc;
  }
}

#define DW_PARAMS(T)                                                        \
  const T *__restrict__ x, const T *__restrict__ vals,                      \
      const int *__restrict__ idx, const float *__restrict__ scale,         \
      const float *__restrict__ bias, const float *__restrict__ residual,   \
      float *__restrict__ out, int n_img, int d0, int bw, int cb, int h_out, \
      int w_out, int kh, int kw, int stride, int dilation, int s_steps,     \
      int vc, int th, int tw, int relu, int skip
#define DW_ARGS                                                             \
  x, vals, idx, scale, bias, residual, out, n_img, d0, bw, cb, h_out,       \
      w_out, kh, kw, stride, dilation, s_steps, vc, th, tw, relu, skip

template <int VC, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    vsconv_dw_halo_kernel(DW_PARAMS(float)) {
  dw_body<float, VC, VEC, false>(DW_ARGS);
}

template <int VC, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    vsconv_dw_stack_kernel(DW_PARAMS(float)) {
  dw_body<float, VC, VEC, true>(DW_ARGS);
}

// The int8 branches of the two kernels.
template <int VC, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    vsconv_dw_halo_int8_kernel(DW_PARAMS(int8_t)) {
  dw_body<int8_t, VC, VEC, false>(DW_ARGS);
}

template <int VC, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    vsconv_dw_stack_int8_kernel(DW_PARAMS(int8_t)) {
  dw_body<int8_t, VC, VEC, true>(DW_ARGS);
}

// The kernel of element type T and layout.
template <class T, int VC, int VEC>
struct Entry;
template <int VC, int VEC>
struct Entry<float, VC, VEC> {
  static auto get(bool stack) {
    return stack ? vsconv_dw_stack_kernel<VC, VEC>
                 : vsconv_dw_halo_kernel<VC, VEC>;
  }
};
template <int VC, int VEC>
struct Entry<int8_t, VC, VEC> {
  static auto get(bool stack) {
    return stack ? vsconv_dw_stack_int8_kernel<VC, VEC>
                 : vsconv_dw_halo_int8_kernel<VC, VEC>;
  }
};

template <class T, int VC, int VEC>
int launch_one(bool stack, int threads, void* stream, DW_PARAMS(T)) {
  auto kernel = Entry<T, VC, VEC>::get(stack);
  const size_t smem =
      smem_bytes<T>(stack, th, tw, kh, kw, stride, dilation, s_steps, vc);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long tiles = static_cast<long long>(n_img) *
                          ((h_out + th - 1) / th) * ((w_out + tw - 1) / tw);
  const dim3 grid(static_cast<unsigned>(tiles), cb);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      DW_ARGS);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(bool stack, int vec, int threads, void* stream, DW_PARAMS(T)) {
  if (th < 1 || tw < 1 || vc < 1 || vc > 128 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || kh * stride > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4 && vc % 4 == 0) {
    switch (vc) {
      case 32:
        return launch_one<T, 32, 4>(stack, threads, stream, DW_ARGS);
      case 64:
        return launch_one<T, 64, 4>(stack, threads, stream, DW_ARGS);
      case 128:
        return launch_one<T, 128, 4>(stack, threads, stream, DW_ARGS);
      default:
        return launch_one<T, 0, 4>(stack, threads, stream, DW_ARGS);
    }
  }
  return launch_one<T, 0, 1>(stack, threads, stream, DW_ARGS);
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success, and
// cudaErrorInvalidValue without launching for a tile whose shared memory
// exceeds a block's, or kh*stride > 32).  Any of scale, bias and residual
// may be null; `skip` 0 turns the input-side skip off.  th x tw is the
// output tile a block takes, `threads` its threads (a multiple of 32 up to
// 256); vec is 4 for 16-byte copies (vc % 4 == 0, x and vals 16-byte
// aligned), else 1.  The caller has checked
// shapes, dtypes, contiguity, vc <= 128, that the strips are the cb
// channel tiles and that every tap stays inside the input buffer.
extern "C" int vsconv_dw_halo_launch(
    const float* xh, const float* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img, int rows,
    int bw, int cb, int h_out, int w_out, int kw, int stride, int dilation,
    int s_steps, int vc, int relu, int kh, int th, int tw, int vec,
    int threads, int skip, void* stream) {
  return launch<float>(false, vec, threads, stream, xh, vals, idx, scale,
                       bias, residual, out, n_img, rows, bw, cb, h_out, w_out,
                       kh, kw, stride, dilation, s_steps, vc, th, tw, relu,
                       skip);
}

extern "C" int vsconv_dw_stack_launch(
    const float* xt, const float* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img,
    int planes, int bw, int cb, int h_out, int w_out, int kw, int stride,
    int dilation, int s_steps, int vc, int relu, int kh, int th, int tw,
    int vec, int threads, int skip, void* stream) {
  return launch<float>(true, vec, threads, stream, xt, vals, idx, scale,
                       bias, residual, out, n_img, planes, bw, cb, h_out,
                       w_out, kh, kw, stride, dilation, s_steps, vc, th, tw,
                       relu, skip);
}

// The int8 branch of the halo kernel: xh and vals int8 (vec 4 needs x and
// vals 4-byte aligned), scale (the combined dequant scale, a power of two
// per channel) given by the caller.  Same arguments as the f32 entry.
extern "C" int vsconv_dw_halo_int8_launch(
    const int8_t* xh, const int8_t* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img, int rows,
    int bw, int cb, int h_out, int w_out, int kw, int stride, int dilation,
    int s_steps, int vc, int relu, int kh, int th, int tw, int vec,
    int threads, int skip, void* stream) {
  return launch<int8_t>(false, vec, threads, stream, xh, vals, idx, scale,
                        bias, residual, out, n_img, rows, bw, cb, h_out,
                        w_out, kh, kw, stride, dilation, s_steps, vc, th, tw,
                        relu, skip);
}

// The int8 branch of the stack kernel: xt and vals int8, as the halo
// kernel's int8 entry.
extern "C" int vsconv_dw_stack_int8_launch(
    const int8_t* xt, const int8_t* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img,
    int planes, int bw, int cb, int h_out, int w_out, int kw, int stride,
    int dilation, int s_steps, int vc, int relu, int kh, int th, int tw,
    int vec, int threads, int skip, void* stream) {
  return launch<int8_t>(true, vec, threads, stream, xt, vals, idx, scale,
                        bias, residual, out, n_img, planes, bw, cb, h_out,
                        w_out, kh, kw, stride, dilation, s_steps, vc, th, tw,
                        relu, skip);
}
