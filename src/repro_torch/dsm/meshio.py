"""Device-local buffer access for mesh-sharded durable commits — the port
of ``repro.dsm.meshio``.

The host-gather flush path copies a WHOLE tree to the host before any
shard pipeline starts: one gather whose peak host footprint is the full
state, serialized in front of every pipeline.  With a ``Mesh`` configured
the sharded schedules take the device-native path instead:

* shard ASSIGNMENT comes from leaf METADATA only (``leaf_nbytes``: a
  ``ShardedTensor``'s or a tensor's ``nbytes``, no transfer), and a leaf's
  ``nbytes`` equals its gathered host copy's, so the byte-balanced
  ``partition_leaves`` assignment is the host-gather path's at the same
  shard count.  Same assignment, same leaf bytes, same frame writer:
  byte-equal shard files, CRCs and manifests;
* each leaf is MATERIALIZED inside its shard's flush pipeline
  (``assemble_leaf``): every replica-0 block of a ``ShardedTensor`` is
  copied to the host on its own and placed at its index, so the full tree
  never exists on the host at once and the copies overlap across
  pipelines;
* ``per_device_nbytes`` gives the per-place byte loads (metadata again)
  for the placement policy to price shard counts from the real layout.

D2H accounting: ``TierManager`` counts gather-path copies in
``d2h_gather_bytes`` and these per-block copies in ``d2h_shard_bytes``; a
device-local commit leaves ``d2h_gather_bytes`` at 0.  A ShardedTensor's
blocks count whatever device they are on (on the host the copy into one
tensor is still a copy), as the reference counts a host device's buffers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import Shard, ShardedTensor
from repro_torch.utils.tree import tree_leaves


def leaf_nbytes(leaf: Any) -> int:
    """Payload bytes of one leaf from metadata only (a tensor, a
    ShardedTensor, or anything numpy takes): equal to its host copy's."""
    nb = getattr(leaf, "nbytes", None)
    if nb is None:
        nb = np.asarray(leaf).nbytes
    return int(nb)


def _unique_shards(leaf: ShardedTensor) -> List[Shard]:
    """The leaf's blocks, replicas dropped (replica 0 of each index)."""
    return [s for s in leaf.addressable_shards if s.replica_id == 0]


def assemble_leaf(leaf: Any, count: Optional[Callable[[int], None]] = None
                  ) -> Any:
    """ONE leaf on the host, from its per-place blocks.

    Called inside a shard pipeline thread.  A host tensor or an
    ``np.ndarray`` passes through (post-recovery state is host-resident);
    a CUDA tensor is one copy of the whole; a ShardedTensor is copied
    block by block into a host tensor at each block's index (one copy of
    the block when it is the whole leaf); anything else (a numpy scalar,
    a number) goes through ``np.asarray``.  ``count`` receives the bytes
    copied — the ``d2h_shard_bytes`` feed."""
    if isinstance(leaf, np.ndarray) or (isinstance(leaf, torch.Tensor)
                                        and leaf.device.type == "cpu"):
        return leaf
    if isinstance(leaf, torch.Tensor):
        host = leaf.cpu()
        if count is not None:
            count(host.nbytes)
        return host
    if not isinstance(leaf, ShardedTensor):
        a = np.asarray(leaf)
        if count is not None:
            count(a.nbytes)
        return a
    shards = _unique_shards(leaf)
    if len(shards) == 1 and tuple(shards[0].data.shape) == leaf.shape:
        host = shards[0].data.to("cpu", copy=True)
        if count is not None:
            count(host.nbytes)
        return host
    out = torch.empty(leaf.shape, dtype=leaf.dtype)
    copied = 0
    for s in shards:
        block = s.data.to("cpu")          # ONE block -> host
        out[s.index] = block
        copied += block.nbytes
    if count is not None:
        count(copied)
    return out


def per_device_nbytes(tree: Any) -> List[int]:
    """The per-place byte loads of a flush of ``tree``, from metadata only:
    each replica-0 block's bytes are charged to its place; every other
    leaf (host state, counters, a plain tensor) is pooled on one
    pseudo-place.  Ordered by place id (the pseudo-place first), so every
    caller derives the same vector — the ``device_bytes`` input of
    ``placement.choose_shards``."""
    per: Dict[int, int] = {}
    for leaf in tree_leaves(tree):
        if not isinstance(leaf, ShardedTensor):
            per[-1] = per.get(-1, 0) + leaf_nbytes(leaf)
            continue
        for s in _unique_shards(leaf):
            per[s.place] = per.get(s.place, 0) + int(s.data.nbytes)
    return [per[k] for k in sorted(per)]


def mesh_device_count(mesh: Any) -> int:
    """The places of a Mesh (the device-derived shard-count ceiling)."""
    return int(np.prod(list(mesh.shape.values()))) if mesh is not None else 1
