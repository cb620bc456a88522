"""Deterministic, shardable, resumable data pipeline.

Requirements at 1000-node scale:
* **determinism** — batch ``i`` is a pure function of (seed, i), so any
  worker can recompute any shard (backup-shard straggler mitigation);
* **sharding** — each data-parallel rank reads only its slice;
* **resumability** — the pipeline state is one small ``PipelineState``
  (seed + step) that the DSM runtime persists as a durable object; restart
  resumes mid-epoch with no data loss/duplication;
* **rebalancing** — ``shard_plan`` can reassign shards when the worker set
  changes (elastic scaling) or a straggler is detected.

Sources: ``SyntheticLMSource`` (hash-based token stream, used by tests and
examples) and ``MemmapSource`` (binary token file via ``np.memmap``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """The durable pipeline position (a FliT-protocol object in the DSM
    runtime — persisted with every checkpoint commit)."""
    seed: int
    step: int

    def advance(self, n: int = 1) -> "PipelineState":
        return PipelineState(self.seed, self.step + n)


class SyntheticLMSource:
    """Deterministic pseudo-random token stream: token[j] of sequence i is a
    hash of (seed, i, j).  Cheap, reproducible anywhere, no files."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def sequence_batch(self, seed: int, start_seq: int, n_seqs: int,
                       seq_len: int) -> np.ndarray:
        i = np.arange(start_seq, start_seq + n_seqs, dtype=np.uint64)[:, None]
        j = np.arange(seq_len, dtype=np.uint64)[None, :]
        h = (i * np.uint64(2654435761) ^ j * np.uint64(40503)
             ^ np.uint64(seed) * np.uint64(97))
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        h ^= h >> np.uint64(29)
        return (h % np.uint64(self.vocab_size)).astype(np.int32)


class MemmapSource:
    """Flat binary int32 token file; sequence i = tokens[i*L:(i+1)*L]."""

    def __init__(self, path: str, vocab_size: int):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.vocab_size = vocab_size

    def sequence_batch(self, seed: int, start_seq: int, n_seqs: int,
                       seq_len: int) -> np.ndarray:
        n_total = len(self.tokens) // seq_len
        out = np.empty((n_seqs, seq_len), np.int32)
        for r, i in enumerate(range(start_seq, start_seq + n_seqs)):
            # seeded permutation over sequence index space (epoch shuffle)
            k = (i * 2654435761 + seed * 97) % max(n_total, 1)
            out[r] = self.tokens[k * seq_len:(k + 1) * seq_len]
        return out


def shard_plan(global_batch: int, n_ranks: int,
               weights: Optional[List[float]] = None) -> List[Tuple[int, int]]:
    """(start, count) per rank.  ``weights`` rebalances away from stragglers
    (straggler mitigation: a slow worker gets a smaller shard)."""
    if weights is None:
        weights = [1.0] * n_ranks
    total_w = sum(weights)
    counts = [int(round(global_batch * w / total_w)) for w in weights]
    # fix rounding drift
    drift = global_batch - sum(counts)
    for i in range(abs(drift)):
        counts[i % n_ranks] += 1 if drift > 0 else -1
    plan, start = [], 0
    for c in counts:
        plan.append((start, c))
        start += c
    return plan


class DataPipeline:
    def __init__(self, source, global_batch: int, seq_len: int,
                 state: Optional[PipelineState] = None):
        self.source = source
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.state = state or PipelineState(seed=0, step=0)

    def global_batch_at(self, step: int) -> np.ndarray:
        """The full (global_batch, seq_len+1) token block of one step
        (+1 so targets are the shifted tokens)."""
        start = step * self.global_batch
        return self.source.sequence_batch(self.state.seed, start,
                                          self.global_batch,
                                          self.seq_len + 1)

    def shard_at(self, step: int, rank: int, n_ranks: int,
                 weights=None) -> np.ndarray:
        """Rank-local slice of batch ``step`` — recomputable by ANY worker
        (deterministic), which is what backup shards rely on."""
        s, c = shard_plan(self.global_batch, n_ranks, weights)[rank]
        start = step * self.global_batch + s
        return self.source.sequence_batch(self.state.seed, start, c,
                                          self.seq_len + 1)

    def next_global(self) -> Dict[str, np.ndarray]:
        block = self.global_batch_at(self.state.step)
        self.state = self.state.advance()
        return {"tokens": block[:, :-1], "targets": block[:, 1:]}
