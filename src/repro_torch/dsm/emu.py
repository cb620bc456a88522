"""Emulated CXL topologies: price every tier primitive from the calibrated
latency table (core/latency.py) under an injectable topology model — the
port of ``repro.dsm.emu``.

The paper calibrates CXL0 primitive latencies on ONE real CXL 1.1
host+device pair (Fig. 5) but argues the model "captures a wide range of
current and future CXL setups".  Following emucxl (arXiv:2404.08311) —
emulated latency injection is enough to study placement policies — and the
CXL survey taxonomy (arXiv:2412.20249: 1.1 direct-attach, 2.0 switched
pool, 3.0 fabric), this module makes the runtime *feel* a topology:

* a ``Topology`` names the knobs that differ across CXL generations —
  a remote-access latency multiplier over the 1.1 calibration, a per-hop
  switch/fabric latency, per-link bandwidth caps, the number of parallel
  links to the pool (shard fan-out), and a per-stream contention factor
  when concurrent flush pipelines share links;
* three presets span the survey's taxonomy: ``cxl11-direct``,
  ``cxl20-switched-pool``, ``cxl30-fabric``;
* ``TopologyEmulator`` prices one op (latency from Fig. 5, scaled by the
  topology; transfer from the bandwidth model; deterministic seeded
  queueing jitter) and records a ``PricedOp`` trace;
* ``attach_emulator(tiers, emu)`` instruments a live ``TierManager``
  in place: every ``lstore`` / ``rstore`` / ``rflush`` / ``mstore`` /
  ``rload`` — the sharded and async variants included — is priced at call
  time (so the trace order is the program order, deterministic) and then
  delegated unchanged.  Behaviour is untouched; only the trace grows.

The same pricing functions are the cost model behind the placement policy
(``dsm.placement``): decisions and emulation can never drift apart.

Every number here is a MODELLED cost of the emulated CXL link, priced from
the paper's Fig. 5 calibration (an x86 host + FPGA over CXL 1.1): never a
time measured on the machine that runs the code.  Leaves are sized from
their metadata (``nbytes``), so pricing a CUDA tensor copies nothing to
the host.

Unit convenience: 1 GB/s == 1 byte/ns, so ``nbytes / bw_gbps`` is ns.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.latency import DEVICE, HOST, LATENCY_NS
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Topology:
    """One emulated CXL setup.  Latencies are multipliers/offsets over the
    Fig. 5 calibration (which IS the 1.1 direct-attach measurement);
    bandwidths are per-link caps in GB/s (== bytes/ns)."""
    name: str
    generation: str             # "1.1" | "2.0" | "3.0"
    #: scales every REMOTE-locality latency vs the 1.1 calibration
    remote_multiplier: float
    #: fixed per-access switch/fabric traversal cost (ns; 0 = direct)
    switch_hop_ns: float
    #: one pool link's bandwidth cap (GB/s)
    link_bw_gbps: float
    #: parallel links to the pool — the useful shard fan-out
    n_links: int
    #: fractional per-extra-stream slowdown when concurrent flush
    #: pipelines contend for links (0 = perfect isolation)
    contention_per_stream: float
    #: peer host-buffer (RStore staging) path bandwidth (GB/s)
    staging_bw_gbps: float
    #: local HBM/DRAM tier bandwidth for LStore (GB/s)
    local_bw_gbps: float = 100.0
    #: serial submit/bookkeeping cost per extra shard pipeline (ns)
    shard_setup_ns: float = 2_000.0
    #: fixed manifest+CRC validation cost of a pool restore (ns)
    pool_restore_overhead_ns: float = 20_000.0

    def aggregate_bw_gbps(self, n_streams: int) -> float:
        """Effective aggregate pool bandwidth of ``n_streams`` concurrent
        flush pipelines: streams beyond ``n_links`` share links, and every
        active link pair pays the contention tax."""
        active = max(1, min(n_streams, self.n_links))
        return (self.link_bw_gbps * active
                / (1.0 + self.contention_per_stream * (active - 1)))


#: The survey taxonomy as concrete presets.  cxl11-direct IS the paper's
#: measured pair (multiplier 1.0, no hop); the 2.0/3.0 numbers follow the
#: survey's qualitative ordering: each switch/fabric hop adds latency,
#: pools add links (fan-out bandwidth) but cross-host staging paths
#: lengthen.
PRESETS: Dict[str, Topology] = {t.name: t for t in (
    Topology("cxl11-direct", "1.1",
             remote_multiplier=1.0, switch_hop_ns=0.0,
             link_bw_gbps=12.0, n_links=1, contention_per_stream=0.0,
             staging_bw_gbps=32.0),
    Topology("cxl20-switched-pool", "2.0",
             remote_multiplier=1.4, switch_hop_ns=80.0,
             link_bw_gbps=16.0, n_links=4, contention_per_stream=0.35,
             staging_bw_gbps=10.0),
    Topology("cxl30-fabric", "3.0",
             remote_multiplier=2.2, switch_hop_ns=150.0,
             link_bw_gbps=20.0, n_links=8, contention_per_stream=0.15,
             staging_bw_gbps=8.0),
)}


def get_topology(name_or_topology) -> Topology:
    if isinstance(name_or_topology, Topology):
        return name_or_topology
    try:
        return PRESETS[name_or_topology]
    except KeyError:
        raise KeyError(f"unknown topology {name_or_topology!r}; presets: "
                       f"{sorted(PRESETS)}") from None


def tree_nbytes(tree: Any) -> int:
    """Total payload bytes of a pytree (torch or numpy leaves, or specs),
    from each leaf's metadata: a CUDA tensor is never copied to size it."""
    total = 0
    for l in tree_leaves(tree):
        nb = getattr(l, "nbytes", None)
        if nb is None:
            nb = int(np.prod(np.shape(l))) * np.dtype(
                getattr(l, "dtype", np.float64)).itemsize
        total += int(nb)
    return total


# ---------------------------------------------------------------------------
# pricing (pure functions — shared by the emulator and the placement policy)
# ---------------------------------------------------------------------------

def _remote_lat(topo: Topology, node: str, prim: str) -> float:
    return (LATENCY_NS[(node, prim, "remote")] * topo.remote_multiplier
            + topo.switch_hop_ns)


def lstore_ns(topo: Topology, nbytes: int) -> float:
    """LStore: local volatile tier — locality-independent, no topology
    effects beyond the local-tier bandwidth."""
    return LATENCY_NS[(HOST, "lstore", "local")] + nbytes / topo.local_bw_gbps


def rstore_ns(topo: Topology, nbytes: int) -> float:
    """RStore into a PEER's host buffer: the cache-to-cache propagation
    path.  Host RStore is unavailable on real 1.1 hardware (Table 1), so
    like ``rmw_latency`` the latency point is the device-issued RStore."""
    return _remote_lat(topo, DEVICE, "rstore") + nbytes / topo.staging_bw_gbps


def rload_staging_ns(topo: Topology, nbytes: int) -> float:
    """Read back a copy a peer staged into OUR host buffer."""
    return (LATENCY_NS[(HOST, "load", "local")]
            + nbytes / topo.staging_bw_gbps)


def rflush_ns(topo: Topology, nbytes: int, n_streams: int = 1) -> float:
    """One durable flush stream into the pool (RFlush ≈ MStore latency,
    paper §5.2) carrying ``nbytes``, with ``n_streams`` total pipelines
    contending for the links."""
    return (_remote_lat(topo, HOST, "rflush")
            + nbytes * n_streams / topo.aggregate_bw_gbps(n_streams))


def mstore_ns(topo: Topology, nbytes: int) -> float:
    return _remote_lat(topo, HOST, "mstore") + nbytes / topo.link_bw_gbps


def rload_pool_ns(topo: Topology, nbytes: int) -> float:
    """Pool restore: remote load + manifest/CRC validation overhead."""
    return (_remote_lat(topo, HOST, "load") + topo.pool_restore_overhead_ns
            + nbytes / topo.aggregate_bw_gbps(1))


def sharded_flush_ns(topo: Topology, nbytes: int, n_shards: int) -> float:
    """Emulated wall time of a sharded durable flush: shards run in
    parallel across links (transfer divides by the aggregate bandwidth),
    but each extra pipeline costs serial setup — so the optimum shard
    count is topology- AND size-dependent."""
    k = max(1, n_shards)
    return (_remote_lat(topo, HOST, "rflush")
            + topo.shard_setup_ns * (k - 1)
            + nbytes / topo.aggregate_bw_gbps(k))


def sharded_flush_device_ns(topo: Topology, device_bytes, n_shards: int
                            ) -> float:
    """Emulated wall time of a DEVICE-sharded durable flush: the real
    per-device byte loads (``meshio.per_device_nbytes``) are packed onto
    ``n_shards`` pipelines largest-first, and the wall time is the
    heaviest pipeline's transfer at its per-pipeline share of the
    aggregate bandwidth — skewed device layouts price worse than the
    balanced-blob model, which is exactly why the placement policy wants
    the real vector.  Reduces to ``sharded_flush_ns`` when the loads are
    balanced."""
    loads = sorted((int(b) for b in device_bytes), reverse=True)
    if not loads:
        return sharded_flush_ns(topo, 0, n_shards)
    k = max(1, min(n_shards, len(loads)))
    lanes = [0] * k
    for b in loads:                      # greedy LPT onto the lightest lane
        lanes[lanes.index(min(lanes))] += b
    return (_remote_lat(topo, HOST, "rflush")
            + topo.shard_setup_ns * (k - 1)
            + max(lanes) / (topo.aggregate_bw_gbps(k) / k))


def join_transfer_ns(topo: Topology, nbytes: int, n_shards: int = 1
                     ) -> float:
    """Emulated cost of a grow-by-repartition join moving ``nbytes`` of
    state to the joiner: the survivors RStore the joiner's partition into
    its staging buffer, the joiner reads it back, and the gen+1 manifest
    re-flushes the moved objects durably under the new owner.  This is
    the capital cost an autoscale grow decision pays up front — cheap on
    fabric (GFAM staging bandwidth), expensive over a 1.1 direct link —
    which is exactly why scale decisions must flip per preset."""
    return (rstore_ns(topo, nbytes)
            + rload_staging_ns(topo, nbytes)
            + sharded_flush_ns(topo, nbytes, n_shards))


# ---------------------------------------------------------------------------
# the emulator: a priced-trace recorder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PricedOp:
    """One priced primitive in program order."""
    seq: int
    op: str                  # lstore/rstore/rflush/rflush_shard/mstore/rload
    name: str
    nbytes: int
    n_streams: int
    cost_ns: float


class TopologyEmulator:
    """Prices ops under one topology and records the trace.

    Deterministic by construction: the queueing jitter is drawn from a
    seeded generator in record order, and ``attach_emulator`` prices at
    CALL time (program order), so the same (topology, seed, op sequence)
    always yields the identical priced trace (tests/test_torch_emu.py
    holds it to the reference's trace, op for op and ns for ns).

    ``fault_model`` is an optional straggler/slow-writer model (anything
    with ``perturb(seq, op, name) -> (cost_multiplier, sleep_seconds)``,
    e.g. the reference's ``repro.dsm.faults.StragglerSpec``): the
    multiplier scales the priced cost — seeded by trace position, so
    still deterministic — and the sleep is a real capped stall applied
    OUTSIDE the trace lock, so
    concurrent flush pipelines genuinely reorder under the perturbation
    without perturbing the trace itself.
    """

    #: max fractional queueing jitter applied per op (+/-)
    JITTER = 0.02

    def __init__(self, topology, *, seed: int = 0, fault_model=None):
        self.topology = get_topology(topology)
        self.seed = seed
        self.fault_model = fault_model
        self.trace: List[PricedOp] = []
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    # -- pricing -------------------------------------------------------------
    def _base_ns(self, op: str, nbytes: int, n_streams: int) -> float:
        t = self.topology
        if op == "lstore":
            return lstore_ns(t, nbytes)
        if op == "rstore":
            return rstore_ns(t, nbytes)
        if op == "rload":
            return rload_staging_ns(t, nbytes)
        if op in ("rflush", "rflush_shard"):
            return rflush_ns(t, nbytes, n_streams)
        if op == "mstore":
            return mstore_ns(t, nbytes)
        raise KeyError(f"unpriceable op {op!r}")

    def record(self, op: str, name: str, nbytes: int,
               n_streams: int = 1) -> PricedOp:
        """Price one op and append it to the trace (thread-safe; jitter is
        consumed under the lock so trace order defines the draw order)."""
        sleep_s = 0.0
        with self._lock:
            jitter = 1.0 + self.JITTER * float(self._rng.uniform(-1.0, 1.0))
            cost = self._base_ns(op, nbytes, n_streams) * jitter
            if self.fault_model is not None:
                mult, sleep_s = self.fault_model.perturb(
                    len(self.trace), op, name)
                cost *= mult
            po = PricedOp(len(self.trace), op, name, int(nbytes),
                          n_streams, cost)
            self.trace.append(po)
        if sleep_s > 0.0:
            time.sleep(sleep_s)    # a real stall, outside the trace lock
        return po

    # -- summaries -----------------------------------------------------------
    def total_ns(self) -> float:
        return float(sum(p.cost_ns for p in self.trace))

    def per_op_ns(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p in self.trace:
            out[p.op] = out.get(p.op, 0.0) + p.cost_ns
        return out

    def reset(self):
        """Clear the trace AND re-seed the jitter stream — after reset the
        emulator reprices identically to a fresh one."""
        self.trace = []
        self._rng = np.random.default_rng(self.seed)


def attach_emulator(tiers, emu: TopologyEmulator):
    """Instrument a live TierManager in place: price every tier primitive
    through ``emu`` at call time, then delegate unchanged.  Returns
    ``tiers`` (with ``tiers.emulator`` set).  Sharded flushes are priced
    one ``rflush_shard`` op per shard with ``n_streams`` = the clamped
    shard count, BEFORE submission — program order, not completion order,
    so the trace stays deterministic under the thread pool."""
    from repro_torch.dsm.pool import partition_leaves
    from repro_torch.dsm.meshio import leaf_nbytes

    # a fused primitive (mstore = lstore + rflush) delegates to other
    # WRAPPED methods on the same instance: only the outermost call is
    # priced, so the fused op is charged once, not once plus its parts
    nesting = threading.local()

    def _hbm_nbytes(name: str) -> int:
        return tree_nbytes(tiers.hbm.get(name, ()))

    def _priced_call(record, orig, args, kwargs):
        if getattr(nesting, "depth", 0) == 0:
            record()
        nesting.depth = getattr(nesting, "depth", 0) + 1
        try:
            return orig(*args, **kwargs)
        finally:
            nesting.depth -= 1

    def _wrap(op, orig, nbytes_of):
        @functools.wraps(orig)
        def priced(*args, **kwargs):
            return _priced_call(
                lambda: emu.record(op, args[0] if args else "?",
                                   nbytes_of(*args, **kwargs)),
                orig, args, kwargs)
        return priced

    def _shard_assignment(name, n_shards):
        # metadata-only (leaf ``nbytes``): pricing a flush must not itself
        # copy a CUDA tree to the host — and a leaf's nbytes equals its
        # host copy's, so the priced assignment is the one the flush writes
        sizes = [leaf_nbytes(l) for l in tree_leaves(tiers.hbm[name])]
        return [sum(sizes[i] for i in idxs) for idxs in
                partition_leaves(sizes, n_shards)]

    def _wrap_sharded(orig):
        @functools.wraps(orig)
        def priced(name, n_shards, *args, **kwargs):
            def record():
                shard_bytes = _shard_assignment(name, n_shards)
                for nb in shard_bytes:
                    emu.record("rflush_shard", name, nb, len(shard_bytes))
            return _priced_call(record, orig, (name, n_shards) + args,
                                kwargs)
        return priced

    tiers.lstore = _wrap("lstore", tiers.lstore,
                         lambda name, tree: tree_nbytes(tree))
    tiers.rstore = _wrap("rstore", tiers.rstore,
                         lambda name, *a, **k: _hbm_nbytes(name))
    tiers.rflush = _wrap("rflush", tiers.rflush,
                         lambda name: _hbm_nbytes(name))
    tiers.flush_async = _wrap("rflush", tiers.flush_async,
                              lambda name: _hbm_nbytes(name))
    tiers.mstore = _wrap("mstore", tiers.mstore,
                         lambda name, tree: tree_nbytes(tree))
    tiers.rload = _wrap("rload", tiers.rload,
                        lambda name: tree_nbytes(
                            (tiers.staging.get(name) or (0, ()))[1]))
    tiers.rflush_sharded = _wrap_sharded(tiers.rflush_sharded)
    tiers.flush_async_sharded = _wrap_sharded(tiers.flush_async_sharded)
    tiers.emulator = emu
    return tiers
