"""VSCNN on PyTorch + hand-written Hopper kernels (the port of `repro`).

The package mirrors `repro`'s layout so each module's counterpart is easy
to find:

- `core`     -- `VectorSparse` (balanced block-CSR), vector pruning, the
                structural sparse ops and their kernel dispatch
- `kernels`  -- the CUDA C++ kernels (`csrc/`: sparse conv/matmul and
                flash attention), their ctypes wrappers, plain PyTorch
                versions and dense oracles
- `models`   -- the network IR, `sparsify`, `net_apply`, ResNet-18,
                MobileNetV1; the LM stack (`layers`, `attention`,
                `transformer`)
- `configs`  -- the registered CNN and LM configurations
- `launch`   -- the lockstep scheduler, the LM server and the CNN server
- `params`   -- the bridge that loads `repro`'s numpy weights

Public functions keep the reference's layouts: NHWC activations, HWIO conv
weights, `VectorSparse` with ``vals (NB, S, vk, vn)`` and ``idx (NB, S)``;
(B, T, H, hd) attention and (B, capacity, KV, hd) KV caches.
Entry points run on CUDA unless the caller passes ``device="cpu"``.

The subpackages' ``__init__`` files import nothing, so importing one module
never pulls in the rest (and the kernel modules never import each other in
a cycle): import from the submodules directly.
"""
