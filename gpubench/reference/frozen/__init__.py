"""A frozen copy of the port's generator, discriminator, ADA and GAN train
step (`ide3d_tpu_torch` as of the benchmark's first version), in plain
PyTorch: the training cells' reference. It imports nothing of the program:
K1 is the plain sort-and-composite (`_k1.py`), the data-parallel helpers are
those of one process (`_mesh.py`), and the optional architectures (built-in
encoder, feature volume, alias-free superres) are absent (`_absent.py`).
The copy makes the same random draws in the same order as the step it was
copied from, so that, given the same seed, weights and batches, it follows
the program's first steps. `conv2d_gradfix.QUANT` rounds every convolution's
operands (the lower-precision control)."""
