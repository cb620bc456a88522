"""Deterministic synthetic request traces (the port's copy of
``repro.serve.trace``: the same requests for the same seed).

Benchmarks and the serve-worker kill scenario must agree on the request
stream across PROCESSES (a restarted worker regenerates the trace from
the seed), so everything here is a pure function of its arguments:
prompts come from a seeded generator, request lengths cycle through the
choice tuples (guaranteed mixed-length without sampling noise).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request


def synthetic_trace(n_requests: int, *, seed: int = 0,
                    vocab_size: int = 256,
                    prompt_lens: Sequence[int] = (32,),
                    new_tokens: Sequence[int] = (4, 8, 16, 32, 48),
                    n_prompts: int = 0,
                    arrivals: Optional[Sequence[int]] = None,
                    ) -> List[Request]:
    """``n_requests`` deterministic requests.

    ``prompt_lens`` / ``new_tokens`` are cycled in order — a one-element
    ``prompt_lens`` gives the uniform-prompt trace the static baseline
    needs (it batches prompts unpadded), while the default ``new_tokens``
    mix is exactly the mixed-output-length workload where one long
    sequence holds a static batch hostage.

    ``n_prompts > 0`` draws only that many DISTINCT prompts (per prompt
    length) and cycles them — the shared-prefix serving workload where
    content-addressed prefix reuse (serve.paging) pays: request i and
    request i + n_prompts*len(prompt_lens) share their prompt exactly.

    ``arrivals`` stamps request i with arrival tick ``arrivals[i]``
    (cycled if shorter).  Omitted, every request arrives at tick 0 and
    the trace is byte-identical to the pre-arrival-time one: prompts
    come from the same RNG draws in the same order, and ``arrival=0``
    is the dataclass default."""
    rng = np.random.default_rng(seed)
    pool: dict = {}
    out: List[Request] = []
    for i in range(n_requests):
        L = int(prompt_lens[i % len(prompt_lens)])
        m = int(new_tokens[i % len(new_tokens)])
        if n_prompts > 0:
            slot = (i // len(prompt_lens)) % n_prompts
            if (L, slot) not in pool:
                pool[(L, slot)] = tuple(
                    int(t) for t in rng.integers(0, vocab_size, size=L))
            prompt = pool[(L, slot)]
        else:
            prompt = tuple(int(t)
                           for t in rng.integers(0, vocab_size, size=L))
        if arrivals is None:
            out.append(Request(rid=f"r{i:04d}", prompt=prompt,
                               max_new_tokens=m))
        else:
            out.append(Request(rid=f"r{i:04d}", prompt=prompt,
                               max_new_tokens=m,
                               arrival=int(arrivals[i % len(arrivals)])))
    return out


def trace_t_max(requests: Sequence[Request]) -> int:
    """Cache length covering every request in the trace."""
    return max(len(r.prompt) + r.max_new_tokens for r in requests)
