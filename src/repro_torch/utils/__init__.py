from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import (
    global_norm,
    tree_count_params,
    tree_leaves,
    tree_map,
    tree_size_bytes,
    tree_zeros_like,
)

__all__ = ["get_logger", "global_norm", "tree_count_params", "tree_leaves",
           "tree_map", "tree_size_bytes", "tree_zeros_like"]
