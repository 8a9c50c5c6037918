"""Hand-written Hopper kernels: the sparse conv/matmul hot path and flash
attention.

- `vsmm`    -- vector-sparse matmul: ``csrc/vsmm.cu``, its ctypes wrapper
               `vsmm_kernel`, the plain version `vsmm_plain`
- `vsconv`  -- direct vector-sparse (grouped) conv over the halo and the
               row-tap stack layouts: ``csrc/vsconv.cu``,
               `vsconv_halo_kernel` / `vsconv_plain`,
               `vsconv_stack_kernel` / `vsconv_stack_plain`
- `vsconv_dw` -- depthwise conv over both layouts: ``csrc/vsconv_dw.cu``,
               `vsconv_dw_halo_kernel` / `vsconv_dw_plain`,
               `vsconv_dw_stack_kernel` / `vsconv_dw_stack_plain`
- `flash`   -- attention forward (causal, window, q_offset):
               ``csrc/flash_fwd.cu``, `flash_fwd_kernel` / `flash_fwd_plain`
- `ops`     -- public wrappers (layout prep, 1x1 / depthwise routing)
- `capture` -- CUDA-graph capture and replay that keeps the wrappers'
               launch counters true
- `ref`     -- dense oracles
- `_build`  -- nvcc at first use into the git-ignored ``build/``

CUDA C++ for sm_90a, built by nvcc and loaded with ctypes; nothing is
compiled or loaded at import time, so CPU-only installs import it all.
"""
