"""Tree helpers of the port."""
from repro_torch.utils.trees import (
    TreeLayout,
    flat_buffer_of,
    flatten_tree,
    is_view_of,
    tree_add,
    tree_allclose,
    tree_bytes,
    tree_flatten,
    tree_global_norm,
    tree_layout,
    tree_leaves,
    tree_map,
    tree_scale,
    tree_size,
    tree_sub,
    tree_weighted_sum,
    unflatten_tree,
)

__all__ = ["TreeLayout", "flatten_tree", "unflatten_tree", "is_view_of",
           "flat_buffer_of", "tree_global_norm",
           "tree_layout", "tree_flatten", "tree_leaves", "tree_map", "tree_size",
           "tree_bytes", "tree_add", "tree_sub", "tree_scale",
           "tree_weighted_sum", "tree_allclose"]
