"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package, each with the reference's kernel / ops / ref split."""
