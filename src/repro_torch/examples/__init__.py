"""Twins of the JAX package's model examples (``examples/quickstart.py``,
``examples/durable_kv.py``), run as ``python -m
repro_torch.examples.<name>``."""
