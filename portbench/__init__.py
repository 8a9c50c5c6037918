"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`run.py` runs one cell of ``BENCHMARK.json`` once; see ``README`` in
`run.py`'s docstring.  Nothing here imports JAX or the JAX package.
"""
