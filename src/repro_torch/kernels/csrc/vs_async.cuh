// Asynchronous global -> shared copies (cp.async, sm_80+) shared by the
// stencil bodies of vsconv.cu (the stem body) and vsconv_dw.cu.
//
// A copy of `bytes` (4 or 16) from `src` into shared memory at `dst`;
// when `valid` is false the destination is filled with zeros and nothing
// is read (the src-size operand is 0; `src` must still be a mapped
// address, the callers pass the buffer's base).  16-byte copies bypass L1
// (.cg), 4-byte copies go through it (.ca: .cg takes 16 bytes only).
#pragma once

#include <cuda_runtime.h>

namespace vs {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `N` of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace vs
