"""Seeded LM weights that the port's CPU tests hand to both sides."""
import jax
import numpy as np

from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init_params


def seeded_params(cfg_ref, seed: int = 1):
    """The reference's init of ``cfg_ref`` as numpy, all-zero leaves
    (norm scales, biases, the RWKV lerp and decay vectors) filled with
    0.1 * N(0, 1) from ``seed`` so that both sides see them."""
    params = ref_init_params(RT.lm_schema(cfg_ref), jax.random.PRNGKey(0),
                             cfg_ref.dtype)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.any():
            return a
        return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree.map(fill, params)
