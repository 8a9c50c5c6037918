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
// output is acc / max(l, 1e-30), rounded once to q's type.  `scale` is
// hd^-0.5 computed once on the host in double and rounded to float, as
// the reference's Python float is, and applied to S in f32.  Both bodies
// launch one block per (bh, query tile), the heaviest causal tiles first,
// and walk the kv tiles that any row of the tile can see (the TPU's `live`
// test for causal and window, as a loop range).  Neither splits the keys
// across blocks or uses atomics: two runs give bit-equal output.  Both
// take hd up to 256 (a multiple of 4) and any Tq and Tk.
//
// bf16 inputs: the tensor-core body (`flash_mma_kernel`).  Warps own 16
// query rows each: 8 warps (128 rows) a block at hd <= 128, where two
// blocks of 256 threads fit an SM's registers (128 a thread) and shared
// memory (104 KB each at hd 128); 4 warps (64 rows) above.  kv tiles of 64
// keys.  Both products are warp-level `mma.sync.m16n8k16` bf16 x bf16 ->
// f32: S = Q K^T with Q fragments from `ldmatrix` and K rows as the
// col-major B operand (`ldmatrix`); O += P V with V fragments from
// `ldmatrix.trans`.  P goes from the S accumulator straight into the A
// registers of the PV product (the m16n8 C layout of two adjacent S tiles
// is the m16k16 A layout), rounded to bf16 there, which is the
// reference's `p.astype(v.dtype)`.  Q is staged in shared memory once in
// bf16; K and V tiles are double-buffered with `cp.async` (16-byte copies,
// or 8 / 4 where a row or a pointer is not 16-byte aligned, plain 2-byte
// loads where it is only 2-byte aligned), one __syncthreads a tile; rows
// are padded by 8 bf16 so that `ldmatrix` is free of bank conflicts.  hd
// is a template parameter rounded up to a multiple of 16; the padding
// columns are zero, so they add nothing to Q K^T, and the output's are not
// stored.  Keys past Tk are zero-filled and score -inf: p = 0 for them.
// The online softmax runs once per 64 keys in the log2 domain: log2(e) is
// folded into the scale on the host and 2^x runs on the SFU
// (`ex2.approx.ftz`, 2 ulp); masked scores are -1e30 there too, and the
// junk-wipe semantics are unchanged.  Only tiles that cross the diagonal,
// the window edge or Tk apply the mask, and a warp skips a tile that none
// of its rows can see.  Row max and row sum are reduced across each quad
// with __shfl_xor_sync (1, 2).  The output is acc times 1 / max(l, 1e-30)
// (within an f32 ulp of the quotient, then rounded once).  In bf16 p is
// rounded at the running max of 64-key tiles where the TPU kernel (and the
// plain version) round at that of their kv blocks of up to 512 keys: a
// bf16 ulp here and there, within 1e-2 of max|y|.
//
// What bounds the tensor-core body on an H100: the function's own bound at
// the Qwen prefill shape (hd 128, T 512, causal) is its bytes (q, k, v, o
// once).  The kernel also reads each K/V tile from L2 once per 128-row
// query tile and from shared memory once per warp (no fragment is reused
// across warps), computes the masked half of each diagonal tile, and
// issues `mma.sync` from 8 warps an SM, which leaves it latency-bound,
// well under the tensor cores' `wgmma` peak.  Left for later: `wgmma` on
// 64-row warpgroup tiles with K/V read from shared memory, TMA loads with
// `mbarrier`s, and warp specialisation (one producer warp keeping loads in
// flight for consumer warpgroups).
//
// f32 inputs: the CUDA-core body (`flash_simt_kernel`), unchanged: TF32
// would break the 1e-5 f32 parity.  One block of 8 warps per (bh, 64
// query rows), each warp owning 8 rows; kv tiles of 32 keys.  The query
// tile is staged in shared memory as f32 once; K (rows padded to hd + 4:
// conflict-free float4 reads) and V likewise per tile.  For QK^T lane l
// owns key l of the tile and reads q rows as broadcast float4s; the tile
// max is a warp shuffle reduction, the running sum stays a per-lane
// partial until the end.  For PV lane l owns dims l, l + 32, ... (hd/32
// accumulators a row) and reads p from shared memory as broadcast float4s.
// It is bound by shared-memory bandwidth (one wavefront per ~2.7 FMAs a
// lane at hd 128), not by the FMA pipes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------
// f32 inputs: the CUDA-core body
// ---------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;              // query rows per warp
constexpr int kBQ = kWarps * kRows;   // query rows per block
constexpr int kBK = 32;               // keys per kv tile: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

size_t smem_floats(int hd) {
  return static_cast<size_t>(kBQ) * hd + static_cast<size_t>(kBK) * (hd + 4) +
         static_cast<size_t>(kBK) * hd + static_cast<size_t>(kBQ) * kBK;
}

// NS = ceil(hd / 32): accumulator slots a lane holds per row.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// Raise `kernel`'s dynamic shared-memory limit to `smem` once per new size
// (`allowed` is the instantiation's own), so that calls captured in a
// CUDA graph after a first call never set it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

double inv_sqrt(int hd) { return std::pow(static_cast<double>(hd), -0.5); }

template <int NS>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int bh, int tq, int tk, int hd, int causal, int window,
                int q_offset, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hd);
  auto kernel = flash_simt_kernel<float, NS>;
  static size_t smem_allowed = 48 * 1024;
  const cudaError_t err = allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), tq, tk, hd,
      causal, window, q_offset, static_cast<float>(inv_sqrt(hd)));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bf16 inputs: the tensor-core body
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaBK = 64;   // keys per kv tile
constexpr int kPad = 8;      // bf16 padding a shared row

// Warps a block, 16 query rows each: 8 where two blocks of 256 threads fit
// an SM's registers (hd <= 128, at most 128 registers a thread), else 4.
__host__ __device__ constexpr int mma_warps(int HD) { return HD <= 128 ? 8 : 4; }

// Head dim HD (a multiple of 16): Q, two K and two V tiles of HD + kPad.
size_t mma_smem_bytes(int HD) {
  return sizeof(bf16) * static_cast<size_t>(HD + kPad) *
         (16 * mma_warps(HD) + 4 * kMmaBK);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2.approx.ftz: 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16: lo in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Copy W bytes global -> shared without waiting; `in` false zero-fills.
template <int W>
__device__ __forceinline__ void cp_async(bf16* dst, const bf16* src,
                                         bool in) {
  const int n = in ? W : 0;
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(W), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `rows` rows of a row-major (., hd) matrix at `src` into shared rows
// of HD + kPad, W bytes a copy; rows at or past `valid` are zero-filled.
template <int W, int HD, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int rows, int valid, int hd) {
  constexpr int E = W / static_cast<int>(sizeof(bf16));
  constexpr int LD = HD + kPad;
  const int per_row = hd / E;
  for (int c = threadIdx.x; c < rows * per_row; c += THREADS) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * E;
    const bool in = r < valid;
    const bf16* s = in ? src + static_cast<size_t>(r) * hd + col : src;
    if constexpr (W == 2) {
      dst[r * LD + col] = in ? *s : __float2bfloat16_rn(0.f);
    } else {
      cp_async<W>(dst + r * LD + col, s, in);
    }
  }
}

// The same for ROWS rows of exactly HD columns in 16-byte copies: each
// thread keeps one column and steps over rows, so that its addresses are a
// base and constant offsets.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows16(bf16* dst, const bf16* src,
                                             int valid) {
  constexpr int CPR = HD / 8;         // copies a row
  constexpr int RS = THREADS / CPR;   // rows a pass
  constexpr int LD = HD + kPad;
  const int tr = threadIdx.x / CPR;
  if (tr >= RS) return;
  const int col = threadIdx.x % CPR * 8;
  dst += tr * LD + col;
  const bf16* row0 = src + col;   // a valid address for zero-fills
  src = row0 + tr * HD;
#pragma unroll
  for (int r = 0; r < ROWS; r += RS) {
    if (ROWS % RS == 0 || r + tr < ROWS) {
      const bool in = r + tr < valid;
      cp_async<16>(dst + r * LD, in ? src + r * HD : row0, in);
    }
  }
}

template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int valid,
                                      int hd, int vec) {
  if (vec == 16 && hd == HD) {
    stage_rows16<HD, ROWS, THREADS>(dst, src, valid);
    return;
  }
  switch (vec) {
    case 16: stage_rows<16, HD, THREADS>(dst, src, ROWS, valid, hd); break;
    case 8: stage_rows<8, HD, THREADS>(dst, src, ROWS, valid, hd); break;
    case 4: stage_rows<4, HD, THREADS>(dst, src, ROWS, valid, hd); break;
    default: stage_rows<2, HD, THREADS>(dst, src, ROWS, valid, hd); break;
  }
}

// HD = hd rounded up to a multiple of 16.  `vec` is the copy width in
// bytes the pointers and hd allow (16, 8, 4 or 2); `scale_log2` is
// hd^-0.5 * log2(e).
template <int HD>
__global__ void __launch_bounds__(32 * mma_warps(HD),
                                  mma_warps(HD) == 8 ? 2 : 1)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int tq, int tk, int hd, int causal, int window,
                     int q_offset, float scale_log2, int vec) {
  constexpr int THREADS = 32 * mma_warps(HD);
  constexpr int BQ = 16 * mma_warps(HD);   // query rows a block
  constexpr int LD = HD + kPad;
  constexpr int NT = HD / 8;         // 8-column tiles of O a warp holds
  constexpr int NS = kMmaBK / 8;     // 8-key tiles of S
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);   // BQ x LD
  bf16* ks = qs + BQ * LD;                     // 2 stages of kMmaBK x LD
  bf16* vs = ks + 2 * kMmaBK * LD;             // 2 stages of kMmaBK x LD
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row (and row + 8)
  const int tig = lane % 4;  // fragment column pair
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nq = min(BQ, tq - q0);
  const bf16* kg = k + bh * tk * hd;
  const bf16* vg = v + bh * tk * hd;

  // the kv range any row of this tile can see
  const int qlo = q_offset + q0;
  const int qhi = qlo + nq - 1;
  const int kend = causal ? min(tk, qhi + 1) : tk;
  const int kbeg = window > 0 ? max(0, qlo - window + 1) : 0;
  const int kstart = kbeg < kend ? kbeg / kMmaBK * kMmaBK : kend;
  const int ntiles = (kend - kstart + kMmaBK - 1) / kMmaBK;

  // zero the padding columns [hd, HD) of every tile (they are contiguous
  // rows of LD): copies never write them
  if (hd < HD) {
    const int w = HD - hd;
    for (int e = threadIdx.x; e < (BQ + 4 * kMmaBK) * w; e += THREADS) {
      const int r = e / w;
      qs[r * LD + hd + (e - r * w)] = __float2bfloat16_rn(0.f);
    }
  }
  stage<HD, BQ, THREADS>(qs, q + (bh * tq + q0) * hd, nq, hd, vec);
  if (ntiles > 0) {
    const int valid = min(kMmaBK, tk - kstart);
    stage<HD, kMmaBK, THREADS>(ks, kg + static_cast<size_t>(kstart) * hd,
                               valid, hd, vec);
    stage<HD, kMmaBK, THREADS>(vs, vg + static_cast<size_t>(kstart) * hd,
                               valid, hd, vec);
  }
  cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[n][j] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's partial row sums
  const int wlo = qlo + warp * 16;  // the warp's first and last position
  const int whi = wlo + 15;
  const bf16* qa = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kstart + t * kMmaBK;
    const int buf = t & 1;
    cp_async_wait<0>();
    // tile t (and Q) has landed for every thread, and every warp is done
    // with tile t - 1, whose buffer now takes tile t + 1
    __syncthreads();
    if (t + 1 < ntiles) {
      const int k1 = k0 + kMmaBK;
      const int valid = min(kMmaBK, tk - k1);
      stage<HD, kMmaBK, THREADS>(ks + (buf ^ 1) * kMmaBK * LD,
                                 kg + static_cast<size_t>(k1) * hd, valid,
                                 hd, vec);
      stage<HD, kMmaBK, THREADS>(vs + (buf ^ 1) * kMmaBK * LD,
                                 vg + static_cast<size_t>(k1) * hd, valid,
                                 hd, vec);
      cp_async_commit();
    }

    // A warp skips a tile that none of its rows can see (all keys after
    // its rows, or all before their windows).  That is exact for every
    // row that sees a key at all: such a tile comes after the row's first
    // live key (p = 0, corr = 1) or is junk that the first live key wipes.
    const bool visible = !(causal && k0 > whi) &&
                         !(window > 0 && wlo - (k0 + kMmaBK - 1) >= window);
    if (visible) {
      const bf16* kb = ks + buf * kMmaBK * LD;
      const bf16* vb = vs + buf * kMmaBK * LD;

      // S = Q K^T: 16 rows x 64 keys a warp
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          unsigned b[4];
          ldmatrix_x4(b, kb + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * p], a, b[0], b[1]);
          mma_bf16(s[2 * p + 1], a, b[2], b[3]);
        }
      }

      // scale into the log2 domain; mask where this tile crosses the
      // diagonal, the window edge or Tk (keys past Tk score -inf: p = 0)
      const bool masked = k0 + kMmaBK > tk ||
                          (causal && k0 + kMmaBK - 1 > wlo) ||
                          (window > 0 && whi - k0 >= window);
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[n][j] * scale_log2;
          if (masked) {
            const int kp = k0 + n * 8 + tig * 2 + (j & 1);
            const int qp = wlo + g + (j >> 1) * 8;
            const bool ok = (!causal || qp >= kp) &&
                            (window <= 0 || qp - kp < window);
            x = kp >= tk ? -INFINITY : ok ? x : kNegInf;
          }
          s[n][j] = x;
          mt[j >> 1] = fmaxf(mt[j >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(kFull, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(kFull, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        corr[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

      // O += P V, 16 keys a step: S tiles 2kk and 2kk + 1 are P's A operand
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        unsigned a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = exp2_approx(s[2 * kk + h][0] - m[0]);
          const float p1 = exp2_approx(s[2 * kk + h][1] - m[0]);
          const float p2 = exp2_approx(s[2 * kk + h][2] - m[1]);
          const float p3 = exp2_approx(s[2 * kk + h][3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          a[2 * h] = pack_bf16(p0, p1);
          a[2 * h + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int nd = 0; nd < HD / 16; ++nd) {
          unsigned b[4];
          ldmatrix_x4_trans(
              b, vb + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                     nd * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * nd], a, b[0], b[1]);
          mma_bf16(o[2 * nd + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // acc times 1 / max(l, 1e-30): a division per element is a measurable
  // share of the kernel at the Qwen prefill shape, and the product is
  // within an f32 ulp of the quotient before the one rounding to bf16
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (row >= nq) continue;
    bf16* orow = out + (bh * tq + q0 + row) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + tig * 2;
      if (col < hd) {
        *reinterpret_cast<unsigned*>(orow + col) = pack_bf16(
            o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int bh, int tq, int tk, int hd, int causal, int window,
               int q_offset, cudaStream_t stream) {
  constexpr int BQ = 16 * mma_warps(HD);
  const size_t smem = mma_smem_bytes(HD);
  auto kernel = flash_mma_kernel<HD>;
  static size_t smem_allowed = 48 * 1024;
  const cudaError_t err = allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the widest copy every row start allows (hd * 2 bytes apart)
  const auto addr = reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v);
  const int vec = hd % 8 == 0 && addr % 16 == 0 ? 16
                  : addr % 8 == 0               ? 8
                  : addr % 4 == 0               ? 4
                                                : 2;
  const float scale_log2 =
      static_cast<float>(inv_sqrt(hd) * 1.4426950408889634);
  const dim3 grid(bh, (tq + BQ - 1) / BQ);
  kernel<<<grid, 32 * mma_warps(HD), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), tq, tk, hd,
      causal, window, q_offset, scale_log2, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int tq, int tk, int hd, int causal, int window,
               int q_offset, cudaStream_t stream) {
#define FLASH_CASE(ns)                                                    \
  case ns:                                                                \
    return launch_simt<ns>(q, k, v, out, bh, tq, tk, hd, causal, window,  \
                           q_offset, stream);
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

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int bh, int tq, int tk, int hd, int causal, int window,
                int q_offset, cudaStream_t stream) {
  // the output is stored as bf16 pairs
  if (reinterpret_cast<uintptr_t>(out) % 4) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
#define FLASH_CASE(n16)                                                   \
  case n16:                                                               \
    return launch_mma<16 * n16>(q, k, v, out, bh, tq, tk, hd, causal,     \
                                window, q_offset, stream);
  switch ((hd + 15) / 16) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
    FLASH_CASE(9)
    FLASH_CASE(10)
    FLASH_CASE(11)
    FLASH_CASE(12)
    FLASH_CASE(13)
    FLASH_CASE(14)
    FLASH_CASE(15)
    FLASH_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// Dynamic shared memory of one block at head dim `hd`, in bytes, for the
// body that runs on bf16 (bf16 != 0) or f32 inputs.
extern "C" int flash_fwd_smem_bytes(int hd, int bf16) {
  if (bf16) return static_cast<int>(mma_smem_bytes((hd + 15) / 16 * 16));
  return static_cast<int>(sizeof(float) * smem_floats(hd));
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  bf16 != 0
// means q, k, v and out are bf16 (the tensor-core body), else f32 (the
// CUDA-core body).  window <= 0 means none.  The caller has checked shapes
// (q, out (bh, tq, hd); k, v (bh, tk, hd)), dtypes, contiguity, tq >= 1,
// hd % 4 == 0, hd <= 256 and q_offset >= 0.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, int bh, int tq, int tk, int hd,
                                int causal, int window, int q_offset,
                                int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_bf16(q, k, v, out, bh, tq, tk, hd, causal, window,
                       q_offset, s);
  }
  return launch_f32(q, k, v, out, bh, tq, tk, hd, causal, window, q_offset,
                    s);
}
