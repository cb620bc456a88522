"""Mamba (S6) selective scan: the Hopper kernel (``kernel``), its
dispatcher (``ops``) and the plain PyTorch version (``ref``)."""
