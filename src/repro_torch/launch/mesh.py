"""Rank device slices — the port of ``repro.launch.mesh``'s
``mesh_device_sets`` and ``rank_submesh``, on torch devices.

A cluster rank owns a SLICE of its process's devices: the local devices
of one kind (the CUDA devices torch sees, or the one host device) are
split into contiguous equal runs over the sorted live ranks, and this
rank's run is its slice.  Every rank derives the same layout from the
same ``live`` set, and after a shrink the survivors re-derive slices over
the remaining ranks.  With fewer devices than ranks, slices degrade to
single (possibly shared) devices — the reference's fallback, and the
layout of a cluster on one card: every rank's slice is ``cuda:0``.

The partition weights (``mesh_device_sets``) follow the device count the
PORT sees.  The reference counts ``jax.devices()``, which its tests force
to 8 host devices, so the same live set can weigh its ranks differently
in the two packages (see ``train.elastic.partition_plan``).

The production and debug meshes and ``parse_mesh`` (device meshes over
many cards) are not ported yet and raise (ROADMAP A7).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

A7 = ("device meshes over many cards are not ported yet (reference: "
      "repro.launch.mesh.{}, ROADMAP A7)")


def local_devices(device="cuda") -> List[torch.device]:
    """The devices of ``device``'s kind this process sees: every CUDA
    device for ``"cuda"`` (none without a card), the host for ``"cpu"``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def mesh_device_sets(live: Sequence[int], device="cuda") -> Dict[int, int]:
    """Per-rank slice weights for ``train.elastic.partition_plan``: how many
    devices each live rank's ``rank_submesh`` slice owns.  A pure function
    of (device count, live set), so every process derives the same map."""
    order = sorted(live)
    per = max(1, len(local_devices(device)) // max(1, len(order)))
    return {r: per for r in order}


def rank_submesh(rank: int, live: Sequence[int],
                 device="cuda") -> List[torch.device]:
    """The devices of ``rank``'s slice (see the module docstring)."""
    devs = local_devices(device)
    if not devs:
        raise RuntimeError(f"device={device!r}: torch sees no such device")
    order = sorted(live)
    if rank not in order:
        raise ValueError(f"rank {rank} not in live set {order}")
    per = max(1, len(devs) // max(1, len(order)))
    pos = order.index(rank)
    return devs[pos * per:(pos + 1) * per] or [devs[pos % len(devs)]]


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(A7.format("make_production_mesh"))


def make_debug_mesh(n_devices: int = 1, model: int = 1):
    raise NotImplementedError(A7.format("make_debug_mesh"))


def parse_mesh(spec: str):
    raise NotImplementedError(A7.format("parse_mesh"))
