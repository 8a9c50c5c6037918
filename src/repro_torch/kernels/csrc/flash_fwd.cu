// flash_fwd: online-softmax attention forward (causal, sliding window,
// q_offset), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kernels/flash.py::flash_fwd_pallas (body
// `_kernel`) of the JAX package:
//
//   out (BH, Tq, hd) = softmax(mask(q k^T * hd^-0.5)) v,
//   q (BH, Tq, hd), k/v (BH, Tk, hd), f32 or bf16, out in q's type.
//
// Query row i sits at position q_offset + i, key j at j.  A masked score
// is -1e30 (not -inf) and the running max starts at -1e30, as in the TPU
// kernel: a row whose first live keys are all masked sums exp(0) = 1 junk
// that its first real key wipes exactly (corr = exp(-1e30 - m) = 0); keys
// past Tk do not exist and add nothing.  QK^T is taken in f32 on the
// inputs' values; p is rounded to v's type before the PV product (bf16 x
// bf16 products are exact in f32), the row sum takes p unrounded; the
// output is acc / max(l, 1e-30), rounded to q's type.  The online softmax
// steps over this kernel's 32-key tiles, so in bf16 p is rounded at the
// running max of its own tiles where the TPU kernel (and the plain
// version) round at that of their kv blocks of up to 512 keys: a bf16 ulp
// here and there, within 1e-2 of max|y|.  `scale` is hd^-0.5 computed once
// on the host in double and rounded to float, as the reference's Python
// float is.
//
// One block of 8 warps per (bh, tile of 64 query rows), the heaviest causal
// tiles launched first; each warp owns 8 rows.  The query tile is staged in
// shared memory as f32 once; the block walks the kv tiles of 32 keys that
// any of its rows can see (the TPU's `live` test for causal and window,
// as a loop range), staging K (rows padded to hd + 4: conflict-free float4
// reads) and V in shared memory.  For QK^T lane l owns key l of the tile
// and reads q rows as broadcast float4s; the tile max is a warp shuffle
// reduction, the running sum stays a per-lane partial until the end.  For
// PV lane l owns dims l, l + 32, ... (hd/32 accumulators a row) and reads p
// from shared memory as broadcast float4s.  hd is a runtime value up to 256
// (a multiple of 4); Tq and Tk are any lengths (ragged tails masked).
//
// What bounds it on an H100: f32 FMAs on the CUDA cores fed from shared
// memory; at hd 128 about one shared-memory wavefront per 2.7 FMAs a lane,
// so shared-memory bandwidth, not the FMA pipes, is the limit.  The bound
// of the function itself is the bytes of q, k, v and out (bf16 tensor-core
// rate for the FLOPs).  Left on the table: wgmma on bf16 tiles, TMA /
// cp.async double buffering of K and V, register tiling of S, and the
// online-softmax rescale done once per 64 keys instead of 32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;              // query rows per warp
constexpr int kBQ = kWarps * kRows;   // query rows per block
constexpr int kBK = 32;               // keys per kv tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_floats(int hd) {
  return static_cast<size_t>(kBQ) * hd + static_cast<size_t>(kBK) * (hd + 4) +
         static_cast<size_t>(kBK) * hd + static_cast<size_t>(kBQ) * kBK;
}

// NS = ceil(hd / 32): accumulator slots a lane holds per row.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int tq,
                     int tk, int hd, int causal, int window,
                     int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = hd + 4;
  float* qs = smem;               // kBQ x hd
  float* ks = qs + kBQ * hd;      // kBK x ldk
  float* vs = ks + kBK * ldk;     // kBK x hd
  float* ps = vs + kBK * hd;      // kBQ x kBK
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int nq = min(kBQ, tq - q0);
  const T* qg = q + (bh * tq + q0) * hd;
  const T* kg = k + bh * tk * hd;
  const T* vg = v + bh * tk * hd;

  for (int e = threadIdx.x; e < kBQ * hd; e += kThreads) {
    qs[e] = e / hd < nq ? to_f32(qg[e]) : 0.f;
  }

  // the kv range any row of this tile can see
  const int qlo = q_offset + q0;
  const int qhi = q_offset + q0 + nq - 1;
  const int kend = causal ? min(tk, qhi + 1) : tk;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kstart = kbeg < kend ? kbeg / kBK * kBK : kend;

  float m[kRows], l[kRows], acc[kRows][NS];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[i][s] = 0.f;
  }
  const float* qw = qs + warp * kRows * hd;
  const float* kr = ks + lane * ldk;
  float* pw = ps + warp * kRows * kBK;
  const int qp0 = q_offset + q0 + warp * kRows;

  for (int k0 = kstart; k0 < kend; k0 += kBK) {
    __syncthreads();  // q staged; the previous tile's readers are done
    for (int e = threadIdx.x; e < kBK * hd; e += kThreads) {
      const int j = e / hd;
      const bool in = k0 + j < tk;
      ks[j * ldk + (e - j * hd)] = in ? to_f32(kg[k0 * hd + e]) : 0.f;
      vs[e] = in ? to_f32(vg[k0 * hd + e]) : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    const int kp = k0 + lane;
    const bool exists = kp < tk;
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    for (int d4 = 0; d4 < hd / 4; ++d4) {
      const float4 kk = reinterpret_cast<const float4*>(kr)[d4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(qw + i * hd)[d4];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // online softmax: mask, tile max, rescale, p rounded to v's type
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = qp0 + i;
      const bool ok = exists && (!causal || qp >= kp) &&
                      (window <= 0 || qp - kp < window);
      const float si = ok ? s[i] * scale : kNegInf;
      float mt = si;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      }
      const float m_new = fmaxf(m[i], mt);
      const float p = exists ? expf(si - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + p;
      m[i] = m_new;
      pw[i * kBK + lane] = to_f32(from_f32<T>(p));
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) acc[i][sl] *= corr;
    }
    __syncwarp();

    // acc += p v over the tile's keys
    for (int j = 0; j < kBK; j += 4) {
      float4 pj[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pj[i] = *reinterpret_cast<const float4*>(pw + i * kBK + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * hd;
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) {
          const int d = lane + 32 * sl;
          const float vv = d < hd ? vrow[d] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float pij = reinterpret_cast<const float*>(&pj[i])[jj];
            acc[i][sl] = fmaf(pij, vv, acc[i][sl]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lt += __shfl_xor_sync(kFull, lt, off);
    }
    const float denom = fmaxf(lt, 1e-30f);
    const int r = warp * kRows + i;
    if (r < nq) {
      T* orow = out + (bh * tq + q0 + r) * hd;
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        const int d = lane + 32 * sl;
        if (d < hd) orow[d] = from_f32<T>(acc[i][sl] / denom);
      }
    }
  }
}

template <typename T, int NS>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int bh, int tq, int tk, int hd, int causal, int window,
                 int q_offset, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hd);
  auto kernel = flash_fwd_kernel<T, NS>;
  // raise the instantiation's shared-memory limit once per new size, so
  // calls captured in a CUDA graph (after a first call) never set it
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const float scale = static_cast<float>(std::pow(static_cast<double>(hd),
                                                  -0.5));
  const dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), tq, tk, hd, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int bh,
              int tq, int tk, int hd, int causal, int window,
              int q_offset, cudaStream_t stream) {
#define FLASH_CASE(ns)                                                    \
  case ns:                                                                \
    return launch_typed<T, ns>(q, k, v, out, bh, tq, tk, hd, causal,      \
                               window, q_offset, stream);
  switch ((hd + 31) / 32) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// Dynamic shared memory of one block at head dim `hd`, in bytes.
extern "C" int flash_fwd_smem_bytes(int hd) {
  return static_cast<int>(sizeof(float) * smem_floats(hd));
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  bf16 != 0
// means q, k, v and out are bf16, else f32.  window <= 0 means none.  The
// caller has checked shapes (q, out (bh, tq, hd); k, v (bh, tk, hd)),
// dtypes, contiguity, tq >= 1, hd % 4 == 0, hd <= 256 and q_offset >= 0.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, int bh, int tq, int tk, int hd,
                                int causal, int window, int q_offset,
                                int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_hd<__nv_bfloat16>(q, k, v, out, bh, tq, tk, hd, causal,
                                    window, q_offset, s);
  }
  return launch_hd<float>(q, k, v, out, bh, tq, tk, hd, causal, window,
                          q_offset, s);
}
