"""dipper-tpu-torch: the PyTorch and CUDA port of dipper-tpu.

The JAX package `dipper_tpu` is the reference this package is held
against; this one imports neither it nor `jax`. Host code (FASTA,
PHYLIP and Newick I/O, the native sketcher, host rank compression) is a
copy of the reference's; device code (among it the MinHash sketcher and
rank compression of the NJ matrix and -o d) is PyTorch tensor code plus
hand-written CUDA kernels for Hopper (`csrc/`), each with a plain
PyTorch version that CPU tensors take.
"""

__version__ = "0.1.0"
