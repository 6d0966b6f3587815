from dipper_tpu_torch.nj.engine import (neighbor_joining,
                                        neighbor_joining_plain,
                                        nj_tree_newick)

__all__ = ["neighbor_joining", "neighbor_joining_plain", "nj_tree_newick"]
