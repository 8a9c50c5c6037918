"""VSCNN core: the vector-sparse weight format, vector pruning, and the
structural sparse ops with their kernel dispatch.

- `device`        -- `resolve_device`: CUDA unless the caller asks for the CPU
- `vector_sparse` -- `VectorSparse` balanced block-CSR (the paper's index system)
- `pruning`       -- balanced vector pruning (host-side numpy)
- `sparse_ops`    -- `vs_matmul` / `vs_conv2d` (plain structural path + kernels)
"""
