from dipper_tpu_torch.dc.pipeline import build_dc_tree, build_dc_tree_from_matrix

__all__ = ["build_dc_tree", "build_dc_tree_from_matrix"]
