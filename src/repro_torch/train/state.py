"""Training state: params + optimizer + step counter + RNG key data — the
port of ``repro.train.state``.

The state tree is what the DSM runtime checkpoints: each top-level entry
(params / mu / nu / counters) is a durable object committed through the
FliT protocol (``repro_torch.dsm``).  ``rng`` keeps the reference's (2,)
uint32 key data and ``opt.step`` an int32 scalar, so the committed
``counters`` object has the reference's bytes and each package resumes
the other's pool.  The key data stays on the host: no step reads it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState, adamw_init


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    rng: torch.Tensor         # (2,) uint32, host


def key_data(seed: int) -> torch.Tensor:
    """The key data of the reference's ``jax.random.PRNGKey(seed)`` (32-bit
    seeds, as JAX without x64 takes them): ``[0, seed]`` as uint32."""
    return torch.from_numpy(np.array([0, seed & 0xFFFFFFFF], np.uint32))


def init_train_state(params, seed: int = 0,
                     moment_dtype: str = "float32") -> TrainState:
    return TrainState(params=params, opt=adamw_init(params, moment_dtype),
                      rng=key_data(seed))
