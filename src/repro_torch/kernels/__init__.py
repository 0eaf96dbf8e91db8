"""Hand-written CUDA kernels (``csrc/``), their bindings, and the wrappers
that do the padding and global reductions around them (``ops``)."""
