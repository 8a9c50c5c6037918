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
// One block per (tile of kPix flattened output pixels over N*Hout*Wout,
// channel tile j).  The block's kPix*vc elements are spread over its
// threads channel-fastest, so a warp reads 32 consecutive channels of one
// pixel (coalesced).  Each thread keeps its elements' input offsets and
// f32 accumulators in registers.  Step s reads t = idx[j, s], (ky, kx) =
// divmod(t, kw), loads each element's input at that tap and the tile's
// stored tap vector, votes block-wide (`__syncthreads_or`) whether any
// loaded input is nonzero — the input-side skip over a kPix-pixel tile,
// where the TPU skips a (bh*w_out, vc) block; a skipped tile adds exact
// zeros, so the result does not depend on the granularity — and does one
// FMA per element.  The layouts differ only in where a tap's input sits:
//
//   halo  xh (N, rows, bW, CB, vc), `build_halo_input(x, vk=vc)`: output
//         pixel (i, jj) reads padded pixel (ky*d + stride*i,
//         kx*d + stride*jj), channel j*vc + c;
//   stack xt (N, kh*stride, Hout, bW, C): plane ky*stride + (kx*d) % stride,
//         row i, column jj + (kx*d) / stride, channel j*vc + c.
//
// vc is a runtime value up to 128 (MobileNetV1 has 32, 64 and 128).
//
// What bounds it on an H100: bytes.  Each output element costs S FMAs
// against one input read per tap (S reads of L2 or HBM per element), so
// the arithmetic intensity is below one FLOP per byte; the least traffic is
// the input once, the taps, and the output once.  This first version reads
// every tap's input from L2 (neighbouring taps of a pixel hit the same
// lines); a shared-memory halo window holding a block's rows once is for
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 32;     // output pixels per block
constexpr int kMaxVc = 128;  // channel tile width the register layout covers
constexpr int kMaxPer = kPix * kMaxVc / kThreads;  // elements per thread

// Writes pix[r] = base(img, i, jj) for the block's pixels r < rows_valid.
template <class Base>
__device__ __forceinline__ void pixel_bases(long long* pix, long long p0,
                                            int rows_valid, int h_out,
                                            int w_out, Base base) {
  if (threadIdx.x < kPix) {
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
  __syncthreads();
}

// The whole depthwise tile: S steps of elementwise FMAs, then the
// epilogue.  `step_offset(t)` is the offset of tap t's input from a
// pixel's base.
template <class StepOffset>
__device__ __forceinline__ void dw_tile(
    const float* __restrict__ x, const float* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, const long long* pix, long long p0,
    int rows_valid, long long c_total, int j, int s_steps, int vc, int relu,
    StepOffset step_offset) {
  long long xo[kMaxPer];  // input offset of each element (pixel base + ch)
  int ch[kMaxPer];        // channel within the tile, -1 if not owned
  int row[kMaxPer];       // pixel within the tile
  float acc[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e / vc;
    const bool mine = r < rows_valid;  // also false past the tile's kPix*vc
    ch[k] = mine ? e - r * vc : -1;
    row[k] = r;
    xo[k] = mine ? pix[r] + static_cast<long long>(j) * vc + (e - r * vc) : 0;
    acc[k] = 0.f;
  }
  for (int s = 0; s < s_steps; ++s) {
    const long long tile = static_cast<long long>(j) * s_steps + s;
    const long long off = step_offset(idx[tile]);
    const float* w = vals + tile * vc;
    float xv[kMaxPer];
    int nonzero = 0;
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      xv[k] = ch[k] >= 0 ? x[xo[k] + off] : 0.f;
      nonzero |= xv[k] != 0.f;
    }
    if (__syncthreads_or(nonzero)) {
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (ch[k] >= 0) acc[k] = fmaf(xv[k], w[ch[k]], acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    if (ch[k] < 0) continue;
    const long long col = static_cast<long long>(j) * vc + ch[k];
    const long long o = (p0 + row[k]) * c_total + col;
    float v = acc[k];
    if (scale) v = v * scale[col];
    if (bias) v = v + bias[col];
    if (residual) v = v + residual[o];
    if (relu && v < 0.f) v = 0.f;  // NaN passes through, as in max(v, 0)
    out[o] = v;
  }
}

__global__ void __launch_bounds__(kThreads) vsconv_dw_halo_kernel(
    const float* __restrict__ xh, const float* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int n_img, int rows, int bw, int cb, int h_out,
    int w_out, int kw, int stride, int dilation, int s_steps, int vc,
    int relu) {
  __shared__ long long pix[kPix];  // padded-input offset of each pixel
  const int j = blockIdx.y;
  const long long c = static_cast<long long>(cb) * vc;  // channels
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const long long p0 = static_cast<long long>(blockIdx.x) * kPix;
  const int rows_valid =
      static_cast<int>(min(static_cast<long long>(kPix), p_total - p0));
  pixel_bases(pix, p0, rows_valid, h_out, w_out,
              [=](long long img, long long i, long long jj) {
                return ((img * rows + stride * i) * bw + stride * jj) * c;
              });
  dw_tile(xh, vals, idx, scale, bias, residual, out, pix, p0, rows_valid, c,
          j, s_steps, vc, relu, [=](int t) {
            const int ky = t / kw;
            const int kx = t - ky * kw;
            return (static_cast<long long>(ky) * dilation * bw +
                    static_cast<long long>(kx) * dilation) * c;
          });
}

__global__ void __launch_bounds__(kThreads) vsconv_dw_stack_kernel(
    const float* __restrict__ xt, const float* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int n_img, int planes, int bw, int cb,
    int h_out, int w_out, int kw, int stride, int dilation, int s_steps,
    int vc, int relu) {
  __shared__ long long pix[kPix];  // stack offset of each pixel
  const int j = blockIdx.y;
  const long long c = static_cast<long long>(cb) * vc;  // channels
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const long long p0 = static_cast<long long>(blockIdx.x) * kPix;
  const int rows_valid =
      static_cast<int>(min(static_cast<long long>(kPix), p_total - p0));
  pixel_bases(pix, p0, rows_valid, h_out, w_out,
              [=](long long img, long long i, long long jj) {
                return ((img * planes * h_out + i) * bw + jj) * c;
              });
  dw_tile(xt, vals, idx, scale, bias, residual, out, pix, p0, rows_valid, c,
          j, s_steps, vc, relu, [=](int t) {
            const int ky = t / kw;
            const int kx = t - ky * kw;
            const int plane = ky * stride + (kx * dilation) % stride;
            const int col = (kx * dilation) / stride;
            return (static_cast<long long>(plane) * h_out * bw + col) * c;
          });
}

template <class Kernel>
int launch(Kernel kernel, const float* x, const float* vals, const int* idx,
           const float* scale, const float* bias, const float* residual,
           float* out, int n_img, int d0, int bw, int cb, int h_out,
           int w_out, int kw, int stride, int dilation, int s_steps, int vc,
           int relu, void* stream) {
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const dim3 grid(static_cast<unsigned>((p_total + kPix - 1) / kPix), cb);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, vals, idx, scale, bias, residual, out, n_img, d0, bw, cb, h_out,
      w_out, kw, stride, dilation, s_steps, vc, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success).  Any
// of scale, bias and residual may be null.  The caller has checked shapes,
// dtypes, contiguity, vc <= 128, that the strips are the cb channel tiles
// and that every tap stays inside the input buffer.
extern "C" int vsconv_dw_halo_launch(
    const float* xh, const float* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img, int rows,
    int bw, int cb, int h_out, int w_out, int kw, int stride, int dilation,
    int s_steps, int vc, int relu, void* stream) {
  return launch(vsconv_dw_halo_kernel, xh, vals, idx, scale, bias, residual,
                out, n_img, rows, bw, cb, h_out, w_out, kw, stride, dilation,
                s_steps, vc, relu, stream);
}

extern "C" int vsconv_dw_stack_launch(
    const float* xt, const float* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img,
    int planes, int bw, int cb, int h_out, int w_out, int kw, int stride,
    int dilation, int s_steps, int vc, int relu, void* stream) {
  return launch(vsconv_dw_stack_kernel, xt, vals, idx, scale, bias, residual,
                out, n_img, planes, bw, cb, h_out, w_out, kw, stride,
                dilation, s_steps, vc, relu, stream);
}
