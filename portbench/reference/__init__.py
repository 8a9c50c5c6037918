"""Plain PyTorch references of the benchmark's configurations.

Each configuration file names its reference module here (``reference``).
A module gives `layer_table` (the layers with their shapes, in order) and
`forward` (the whole net in plain f32 PyTorch, NCHW).  `common` holds what
they share: the parameter schema, the weight preparation (BN folding and
the frozen balanced pruning) and the plain ops.  Nothing here imports the
program (`repro_torch`) or JAX.
"""
