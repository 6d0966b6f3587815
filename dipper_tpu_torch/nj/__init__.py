from dipper_tpu_torch.nj.engine import neighbor_joining, nj_tree_newick

__all__ = ["neighbor_joining", "nj_tree_newick"]
