"""Grouped (per-expert) matmul: the Hopper kernel (``kernel``), its
dispatcher (``ops``) and the plain PyTorch version (``ref``)."""
