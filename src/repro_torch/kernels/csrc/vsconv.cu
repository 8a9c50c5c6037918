// vsconv_halo: direct vector-sparse SAME convolution, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/vsconv.py::vsconv_halo_pallas of
// the JAX package, both of its bodies (`_halo_kernel`, streaming, and
// `_halo_resident_kernel`, picked by `use_resident_halo`): the resident
// body is a TPU DMA choice and needs no second kernel here.
//
//   out (N, Hout, Wout, NB*vn) = conv of xh with a balanced block-CSR
//   weight (kh*kw*CB*vk, Cout): stored tiles vals (NB, S, vk, vn), K-tile
//   ids idx (NB, S); then x scale, + bias, + residual, ReLU.
//
// xh is `build_halo_input`'s buffer: the SAME-padded NHWC input, shape
// (N, rows, bW, CB, vk).  One block per (tile of kRows flattened output
// pixels over N*Hout*Wout, output strip j).  Step s decodes
// t = idx[j, s] into tap (ky, kx) = divmod(t / CB, kw) and cin tile
// t % CB, and output pixel (i, jj) reads padded pixel
// (ky*d + stride*i, kx*d + stride*jj): the tap is resolved in the kernel,
// no tap-shifted copy of the input exists.  Each pixel's base offset is
// computed once per block.  The ids are decoded as given, in stored
// (cin-major) order.  Zero-skip and epilogue are those of vsmm
// (vs_tile.cuh), the residual being the output-shaped ResNet shortcut.
//
// What bounds it on an H100: fp32 FMAs on the CUDA cores (no tensor cores:
// TF32 would break the 1e-5 agreement with the f32 reference) and the
// bytes of the padded input, the stored tiles, the output and the
// residual.  This first version reads each tap's activation tile from L2
// per step; a shared-memory halo window reused across the taps of a cin
// tile, TMA and wgmma are for later work.
#include "vs_tile.cuh"

namespace {

__global__ void __launch_bounds__(vs::kThreads) vsconv_halo_kernel(
    const float* __restrict__ xh, const float* __restrict__ vals,
    const int* __restrict__ idx, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int n_img, int rows, int bw, int cb, int h_out,
    int w_out, int kw, int stride, int dilation, int nb, int s_steps, int vk,
    int vn, int relu) {
  extern __shared__ float smem[];
  __shared__ long long pix[vs::kRows];  // padded-input offset of each pixel
  float* ws = smem;                     // vk * vn
  float* xs = smem + vk * vn;           // kRows * vk
  const int j = blockIdx.y;
  const long long c = static_cast<long long>(cb) * vk;  // channels
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const long long p0 = static_cast<long long>(blockIdx.x) * vs::kRows;
  const int rows_valid =
      static_cast<int>(min(static_cast<long long>(vs::kRows), p_total - p0));

  if (threadIdx.x < vs::kRows) {
    long long base = 0;
    if (static_cast<int>(threadIdx.x) < rows_valid) {
      const long long p = p0 + threadIdx.x;
      const long long hw = static_cast<long long>(h_out) * w_out;
      const long long img = p / hw;
      const long long rem = p - img * hw;
      const long long i = rem / w_out;
      const long long jj = rem - i * w_out;
      base = ((img * rows + stride * i) * bw + stride * jj) * c;
    }
    pix[threadIdx.x] = base;
  }

  float acc[vs::kRowsPerThread][vs::kColsPerThread] = {};
  for (int s = 0; s < s_steps; ++s) {
    const long long tile = static_cast<long long>(j) * s_steps + s;
    const int t = idx[tile];
    const int tap = t / cb;
    const int ct = t - tap * cb;
    const int ky = tap / kw;
    const int kx = tap - ky * kw;
    const long long off =
        (static_cast<long long>(ky) * dilation * bw +
         static_cast<long long>(kx) * dilation) * c +
        static_cast<long long>(ct) * vk;
    __syncthreads();  // pix is written; the previous MAC is done with smem
    vs::load_weight_tile(ws, vals, tile, vk, vn);
    int nonzero = 0;
    for (int e = threadIdx.x; e < vs::kRows * vk; e += vs::kThreads) {
      const int r = e / vk;
      const int ch = e - r * vk;
      const float v = r < rows_valid ? xh[pix[r] + off + ch] : 0.f;
      xs[e] = v;
      nonzero |= v != 0.f;
    }
    if (__syncthreads_or(nonzero)) vs::mac_tile(acc, xs, ws, vk, vn);
  }
  vs::epilogue(acc, out, p0, rows_valid, nb * vn, j * vn, vn, scale, bias,
               residual, relu);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Any of
// scale, bias and residual may be null.  The caller has checked shapes,
// dtypes, contiguity, vn <= 128 and that every tap stays inside xh.
extern "C" int vsconv_halo_launch(
    const float* xh, const float* vals, const int* idx, const float* scale,
    const float* bias, const float* residual, float* out, int n_img, int rows,
    int bw, int cb, int h_out, int w_out, int kw, int stride, int dilation,
    int nb, int s_steps, int vk, int vn, int relu, void* stream) {
  const size_t smem = vs::tile_smem_bytes(vk, vn);
  if (smem > 48 * 1024 - vs::kRows * sizeof(long long)) {
    cudaFuncSetAttribute(vsconv_halo_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const long long p_total = static_cast<long long>(n_img) * h_out * w_out;
  const dim3 grid(static_cast<unsigned>((p_total + vs::kRows - 1) / vs::kRows),
                  nb);
  vsconv_halo_kernel<<<grid, vs::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xh, vals, idx, scale, bias, residual, out, n_img, rows, bw, cb, h_out,
      w_out, kw, stride, dilation, nb, s_steps, vk, vn, relu);
  return static_cast<int>(cudaGetLastError());
}
