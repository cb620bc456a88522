"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package, each with the reference's kernel / ops / ref split."""


def cotangent(g):
    """A cotangent as a backward kernel takes it: contiguous and 16-byte
    aligned (``None`` stays ``None``)."""
    if g is None:
        return None
    g = g.contiguous()
    return g.clone() if g.data_ptr() % 16 else g
