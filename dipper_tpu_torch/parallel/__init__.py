from dipper_tpu_torch.parallel.sharded import (
    Mesh,
    make_mesh,
    sharded_mash_matrix,
    sharded_placement_build,
)

__all__ = ["Mesh", "make_mesh", "sharded_mash_matrix",
           "sharded_placement_build"]
