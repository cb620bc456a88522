"""RWKV-6 WKV recurrence: the Hopper kernel (``kernel``), its dispatcher
(``ops``) and the plain PyTorch versions (``ref``)."""
