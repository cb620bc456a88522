"""Twins of the JAX package's model benchmarks (``benchmarks/bench_*.py``):
``flit``, ``table1``, ``latency`` and ``model_fuzz``, each run as
``python -m repro_torch.bench.<name>``.  Each prints the reference's
``metric,value,note`` rows and writes ``BENCH_<name>.json`` in its schema,
so the committed ``benchmarks/baselines/*.json`` hold them too."""
