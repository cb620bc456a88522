"""The mesh layout of a state (``sharding``: logical-axis rules, named
shardings, sharded tensors that carry their per-place blocks) and gradient
compression (``compression``).  Sharded compute over ``torch.distributed``
is not here: the port's train step runs on whole tensors (ROADMAP A7b)."""
