"""Deterministic synthetic traffic: diurnal sinusoid x bursty arrivals
(the port's copy of ``repro.scale.traffic``: the same trace for the same
seed and config).

A 24h day is compressed onto ``horizon_ticks`` scheduler ticks.  The
per-tick arrival intensity is

    lam(t) = base_rate * (1 + diurnal_amplitude * sin(2*pi*(t/H) + phase))
             + sum over burst starts b <= t of
                   burst_size * burst_decay ** (t - b)

— a diurnal carrier with seeded hawkes-like burst trains riding on top
(each burst start injects an exponentially decaying excitation, the
self-exciting shape of real flash crowds without the unbounded
branching).  Counts are Poisson draws from ``lam``; burst starts are
Bernoulli(burst_rate) per tick.  Everything is a pure function of
``(seed, config)`` drawn from one ``np.random.default_rng(seed)`` in a
fixed order, so a killed-and-restarted worker regenerates the exact
offered load — the same cross-process contract ``serve/trace.py`` keeps
for prompts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request
from repro_torch.serve.trace import synthetic_trace


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One offered-load shape.  ``horizon_ticks`` is the compressed day;
    defaults give ~5-minute buckets (288 = 24h / 5min) with a pronounced
    day/night swing and a few bursts."""
    seed: int = 0
    horizon_ticks: int = 288
    base_rate: float = 1.0            # mean sessions/tick at the carrier
    diurnal_amplitude: float = 0.8    # 0..1: day/night swing
    diurnal_phase: float = -0.5 * np.pi   # troughs at t=0 ("midnight")
    burst_rate: float = 0.02          # P(burst starts) per tick
    burst_size: float = 6.0           # initial excitation of a burst
    burst_decay: float = 0.7          # per-tick decay of the excitation
    prompt_lens: Tuple[int, ...] = (16, 32)
    new_tokens: Tuple[int, ...] = (4, 8, 16, 32)
    vocab_size: int = 256

    def __post_init__(self):
        assert self.horizon_ticks >= 1, self.horizon_ticks
        assert 0.0 <= self.diurnal_amplitude <= 1.0, self.diurnal_amplitude
        assert 0.0 <= self.burst_decay < 1.0, self.burst_decay


def arrival_counts(cfg: TrafficConfig) -> np.ndarray:
    """Sessions arriving per tick, shape ``(horizon_ticks,)`` int64.
    Deterministic in (seed, config): burst starts are drawn for every
    tick first, then one Poisson vector over the full intensity, so the
    draw order never depends on the values drawn."""
    rng = np.random.default_rng(cfg.seed)
    h = cfg.horizon_ticks
    t = np.arange(h, dtype=np.float64)
    diurnal = cfg.base_rate * (
        1.0 + cfg.diurnal_amplitude
        * np.sin(2.0 * np.pi * t / h + cfg.diurnal_phase))
    starts = rng.random(h) < cfg.burst_rate
    excitation = np.zeros(h)
    carry = 0.0
    for i in range(h):
        carry *= cfg.burst_decay
        if starts[i]:
            carry += cfg.burst_size
        excitation[i] = carry
    lam = np.maximum(diurnal + excitation, 0.0)
    return rng.poisson(lam).astype(np.int64)


def traffic_trace(cfg: TrafficConfig) -> List[Request]:
    """The full request trace for one compressed day: ``arrival_counts``
    expanded into per-request arrival ticks (requests of one tick are
    consecutive rids, FIFO within the tick), prompts and token budgets
    from ``synthetic_trace`` under the same seed.  Pure in (seed,
    config); identical across processes."""
    counts = arrival_counts(cfg)
    arrivals = np.repeat(np.arange(len(counts)), counts)
    return synthetic_trace(
        int(counts.sum()), seed=cfg.seed, vocab_size=cfg.vocab_size,
        prompt_lens=cfg.prompt_lens, new_tokens=cfg.new_tokens,
        arrivals=arrivals.tolist())


def offered_tokens(requests: Sequence[Request]) -> int:
    """Total decode tokens the trace asks for (the work the fleet must
    emit to serve the day with zero lost sessions)."""
    return sum(r.max_new_tokens for r in requests)
