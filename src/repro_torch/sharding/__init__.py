"""Logical-axis partitioning of the port's tensors on a ``DeviceMesh``."""
from .partition import (DEFAULT_RULES, NULL_CTX, PartitionRules, ShardCtx,
                        placements_for, tree_specs)

__all__ = ["DEFAULT_RULES", "NULL_CTX", "PartitionRules", "ShardCtx",
           "placements_for", "tree_specs"]
