from dipper_tpu_torch.placement.api import (
    add_queries_to_backbone,
    build_placement_tree_from_matrix,
    build_placement_tree_from_seqs,
)

__all__ = [
    "add_queries_to_backbone",
    "build_placement_tree_from_matrix",
    "build_placement_tree_from_seqs",
]
