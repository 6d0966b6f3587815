from dipper_tpu_torch.sketch.bank import get_sketch_bank
from dipper_tpu_torch.sketch.minhash import (sketch_batch_device,
                                             sketch_sequences)

__all__ = ["get_sketch_bank", "sketch_sequences", "sketch_batch_device"]
