"""Device meshes and rank device slices — the port of ``repro.launch.mesh``.

A ``Mesh`` is a grid of PLACES with named axes, the counterpart of a
``jax.sharding.Mesh``: place ``i`` is the ``i``-th cell in row-major mesh
order (what the reference's ``mesh.devices.flat[i]`` is), and each place
maps to a torch device.  The port is single-controller as the reference
is: one process sees every place and copies each one's buffer itself, so
a mesh needs no ``torch.distributed``.  Places go over the local devices
of the requested kind (every CUDA device torch sees, or the host) in
contiguous equal runs, as ``rank_submesh`` splits them; with fewer devices
than places, places share devices, so on one card a 2x4 mesh is eight
places on ``cuda:0``.  A place's id is its position in the mesh, never
its device's index: the per-place byte loads the placement policy prices
(``dsm.meshio.per_device_nbytes``) keep eight entries on one card, as the
reference's do over eight host devices.  A mesh may also be ABSTRACT (a
shape and axis names, no devices): ``make_production_mesh`` gives one,
which is all the sharding rules read.

``make_production_mesh`` is the single-pod (data=16, model=16) = 256-chip
mesh or the multi-pod (pod=2, data=16, model=16); ``make_debug_mesh`` a
small (data, model) mesh; ``parse_mesh`` the CLI's ``"DxM"`` /
``"PxDxM"``.

A cluster rank owns a SLICE of its process's devices: the local devices
of one kind are split into contiguous equal runs over the sorted live
ranks, and this rank's run is its slice.  Every rank derives the same
layout from the same ``live`` set, and after a shrink the survivors
re-derive slices over the remaining ranks.  With fewer devices than
ranks, slices degrade to single (possibly shared) devices — the
reference's fallback, and the layout of a cluster on one card: every
rank's slice is ``cuda:0``.

The partition weights (``mesh_device_sets``) follow the device count the
PORT sees.  The reference counts ``jax.devices()``, which its tests force
to 8 host devices, so the same live set can weigh its ranks differently
in the two packages (see ``train.elastic.partition_plan``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch


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


class Mesh:
    """A grid of places with named axes (see the module docstring).
    ``devices`` lists each place's torch device in mesh order; None makes
    the mesh abstract."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence] = None):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.axis_sizes: Tuple[int, ...] = tuple(int(n) for n in shape)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh shape {self.axis_sizes} against axes "
                             f"{self.axis_names}")
        self.devices: Optional[Tuple[torch.device, ...]] = None
        if devices is not None:
            self.devices = tuple(torch.device(d) for d in devices)
            if len(self.devices) != self.size:
                raise ValueError(f"{len(self.devices)} devices for a mesh "
                                 f"of {self.size} places")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax`` gives it)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, place: int) -> Dict[str, int]:
        """Axis name -> this place's coordinate along it."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = place % n
            place //= n
        return {a: out[a] for a in self.axis_names}

    def device_of(self, place: int) -> torch.device:
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        return self.devices[place]

    def __repr__(self) -> str:
        where = ("abstract" if self.devices is None else
                 ", ".join(sorted({str(d) for d in self.devices})))
        return f"Mesh({self.shape}, {where})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> Mesh:
    """A mesh whose places go over the local devices of ``device``'s kind:
    place i on device i while there are enough, else contiguous equal runs
    of places share a device (the counterpart of ``jax.make_mesh``)."""
    devs = local_devices(device)
    if not devs:
        raise RuntimeError(f"device={device!r}: torch sees no such device")
    n = math.prod(int(d) for d in shape)
    if len(devs) >= n:
        placed = devs[:n]
    else:
        placed = [devs[i * len(devs) // n] for i in range(n)]
    return Mesh(shape, axis_names, placed)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The pod's (data=16, model=16) mesh, or (pod=2, data=16, model=16):
    abstract (no process holds 256 devices; the rules read the shape)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_debug_mesh(n_devices: int = 1, model: int = 1,
                    device="cuda") -> Mesh:
    """A small (data, model) mesh of ``n_devices`` places (tests,
    examples)."""
    data = max(n_devices // model, 1)
    return make_mesh((data, model), ("data", "model"), device)


def parse_mesh(spec: str, device="cuda") -> Mesh:
    """``"2x4"`` -> a (data=2, model=4) Mesh; ``"2x2x2"`` adds the leading
    pod axis.  The CLI surface of the mesh lane (the scenario runner's and
    the worker's ``--mesh``)."""
    dims = tuple(int(d) for d in spec.lower().split("x"))
    if len(dims) == 2:
        return make_mesh(dims, ("data", "model"), device)
    if len(dims) == 3:
        return make_mesh(dims, ("pod", "data", "model"), device)
    raise ValueError(f"mesh spec {spec!r}: want DxM or PxDxM")
