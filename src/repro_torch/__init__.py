"""PyTorch / CUDA port of the CXL0 reproduction, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package sits beside it
with the same layout and module names (``configs``, ``models``,
``kernels``, ``train``, ``serve``, ``dsm``, ``launch``), imports ``torch``
and numpy and nothing of ``repro`` or ``jax``.  Each TPU kernel of the
reference becomes a kernel written by hand for Hopper (``csrc/``), with
the reference's kernel / ops / ref split.  Entry points take ``device``
(default ``"cuda"``) and raise when asked for a card that is not there.

Ported so far: durable continuous-batching serving of the dense GQA
decoder (olmo-1b), with the flash-attention forward as a CUDA kernel.
"""
