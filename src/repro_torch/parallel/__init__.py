"""Distribution: logical-axis sharding (`sharding`) and the chunked
cross-entropy (`losses`).  `compression` and `pipeline`, which only the
reference's training uses, are not ported yet."""
from typing import Any

from .sharding import (MeshRules, use_mesh, current, logical, spec_for,
                       named_sharding, sharding_tree, TRAIN_RULES,
                       SERVE_RULES)

__all__ = ["MeshRules", "use_mesh", "current", "logical", "spec_for",
           "named_sharding", "sharding_tree", "TRAIN_RULES", "SERVE_RULES",
           "chunked_cross_entropy", "cross_entropy_dense"]


def __getattr__(name: str) -> Any:
    # `losses` imports the model layers, which import `sharding`: load it
    # on first use so that either side can be imported first
    if name in ("chunked_cross_entropy", "cross_entropy_dense"):
        from . import losses
        return getattr(losses, name)
    raise AttributeError(name)
