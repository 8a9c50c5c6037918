"""Distribution: logical-axis sharding (`sharding`), the vocab-sharded
chunked cross-entropy (`losses`), fp8-block gradient compression
(`compression`) and the GPipe pipeline over the pod dim (`pipeline`)."""
from typing import Any

from .sharding import (MeshRules, use_mesh, current, logical, spec_for,
                       named_sharding, sharding_tree, TRAIN_RULES,
                       SERVE_RULES)
from . import compression, pipeline  # noqa: E402

__all__ = ["MeshRules", "use_mesh", "current", "logical", "spec_for",
           "named_sharding", "sharding_tree", "TRAIN_RULES", "SERVE_RULES",
           "chunked_cross_entropy", "cross_entropy_dense", "compression",
           "pipeline"]


def __getattr__(name: str) -> Any:
    # `losses` imports the model layers, which import `sharding`: load it
    # on first use so that either side can be imported first
    if name in ("chunked_cross_entropy", "cross_entropy_dense"):
        from . import losses
        return getattr(losses, name)
    raise AttributeError(name)
