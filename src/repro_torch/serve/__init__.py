"""Durable continuous-batching serving over the CXL0 tier stack:
scheduler, trace, tiered KV lanes, paged blocks, session store, engine."""
