"""Hand-written Hopper kernels for the sparse conv/matmul hot path.

- `vsmm`    -- vector-sparse matmul: ``csrc/vsmm.cu``, its ctypes wrapper
               `vsmm_kernel`, the plain version `vsmm_plain`
- `vsconv`  -- direct vector-sparse conv over the halo layout:
               ``csrc/vsconv.cu``, `vsconv_halo_kernel`, `vsconv_plain`
- `ops`     -- public wrappers (layout prep, 1x1 routing)
- `ref`     -- dense oracles
- `_build`  -- nvcc at first use into the git-ignored ``build/``

CUDA C++ for sm_90a, built by nvcc and loaded with ctypes; nothing is
compiled or loaded at import time, so CPU-only installs import it all.
"""
