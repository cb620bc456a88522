"""Cost-driven tier placement under an emulated CXL topology — the port of
``repro.dsm.placement``; every decision and its logged costs equal the
reference's, float for float (tests/test_torch_placement.py).

The runtime used to hard-code its placement choices: the committer's
shard count came from ``auto_shard_count`` (device count, topology-blind),
the KV-cache manager spilled wherever the caller said, and cluster ranks
ring-staged unconditionally.  ``PlacementPolicy`` replaces those choices
with cost-model decisions priced by the SAME functions the topology
emulator uses (``dsm.emu``), so under ``cxl11-direct`` the policy
behaves like the calibrated paper pair and under ``cxl30-fabric`` it
exploits link fan-out — and every decision is logged and assertable.

Three decisions, all per object size under the active topology:

* ``choose_spill``    — host RStore-staging vs pool for an evicted
  object.  Staging is cheap (cache-to-cache path) but volatile: with
  probability ``p_peer_loss`` the peer holding the copy crashes and the
  object must be REPLAYED (recomputed) at ``replay_ns_per_byte``.  The
  pool is durable but pays remote flush + restore (+ fixed manifest/CRC
  overhead).  The policy picks the lower EXPECTED cost;
* ``choose_shards``   — argmin over shard counts of the modelled sharded
  flush wall time (``emu.sharded_flush_ns``): setup cost per extra
  pipeline vs link fan-out.  Direct-attach (1 link) collapses to 1;
  fabric picks up to its 8 links for large states;
* ``choose_schedule`` — ``sync`` when the modelled blocking flush is
  below ``sync_threshold_ns`` (double-buffering would buy nothing),
  ``sharded-async`` otherwise.

Wiring in the port (each opt-in, defaults unchanged):

* ``DurableCommitter(placement=...)`` resolves its shard count — and,
  with ``mode="auto"``, its schedule — from the policy at first commit;
* the fleet controller (``serve.fleet``) prices ``choose_admission``
  (which engine serves a new request: queue-depth decode latency plus
  prefill replay vs pool block restore when a shared prefix is
  reusable) and ``choose_migration`` (is rebalancing an in-flight
  session worth the RStore+adopt traffic vs staying put).

``choose_spill`` (the reference's ``TieredKVCache.spill_auto``),
``plan_rank_staging`` (its cluster ranks) and ``choose_scale`` (its
autoscaler) are pure and ported with the module; the paths that call
them come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from repro_torch.dsm.emu import (Topology, get_topology,
                                 join_transfer_ns, rload_pool_ns,
                                 rload_staging_ns, rstore_ns,
                                 sharded_flush_device_ns, sharded_flush_ns)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One logged placement decision: what was chosen for which object,
    and the modelled cost of every alternative (ns) — so tests and the
    bench can assert WHY, not just what."""
    # "spill" | "shards" | "schedule" | "staging" | "admit" | "migrate"
    # | "scale"
    kind: str
    name: str
    nbytes: int
    choice: Any
    costs: Dict[str, float]
    topology: str


class PlacementPolicy:
    def __init__(self, topology, *,
                 p_peer_loss: float = 0.05,
                 replay_ns_per_byte: float = 0.2,
                 sync_threshold_ns: float = 1e6,
                 max_shards: int = 16,
                 restore_fraction: float = 1.0,
                 decode_tick_ns: float = 5e5):
        """``p_peer_loss``: probability the peer holding a staged-only copy
        crashes before the copy is consumed (the CXL0 cache-loss model);
        ``replay_ns_per_byte``: recompute cost of a lost copy;
        ``restore_fraction``: fraction of spilled objects later read back
        (1.0 = every spill is restored, the serving eviction pattern);
        ``decode_tick_ns``: modelled wall time of one slot-batched decode
        tick — converts an engine's queue depth into the wait a newly
        admitted (or rebalanced) request pays before its slot frees."""
        self.topology: Topology = get_topology(topology)
        self.p_peer_loss = p_peer_loss
        self.replay_ns_per_byte = replay_ns_per_byte
        self.sync_threshold_ns = sync_threshold_ns
        self.max_shards = max_shards
        self.restore_fraction = restore_fraction
        self.decode_tick_ns = decode_tick_ns
        self.decisions: List[Decision] = []

    def _log(self, kind: str, name: str, nbytes: int, choice,
             costs: Dict[str, float]) -> Decision:
        d = Decision(kind, name, int(nbytes), choice, dict(costs),
                     self.topology.name)
        self.decisions.append(d)
        return d

    def decisions_for(self, kind: str) -> List[Decision]:
        return [d for d in self.decisions if d.kind == kind]

    # -- spill tier ----------------------------------------------------------
    def spill_costs(self, nbytes: int) -> Dict[str, float]:
        """Expected end-to-end ns of evicting + later consuming one object
        per tier.  Staging: RStore now; with p_peer_loss the peer dies and
        the object is replayed, else it is read back from the buffer.
        Pool: best-shard-count durable flush now, remote restore later."""
        t = self.topology
        staging = (rstore_ns(t, nbytes)
                   + self.p_peer_loss * self.replay_ns_per_byte * nbytes
                   + (1.0 - self.p_peer_loss) * self.restore_fraction
                   * rload_staging_ns(t, nbytes))
        k = self.choose_shards(nbytes, log=False)
        pool = (sharded_flush_ns(t, nbytes, k)
                + self.restore_fraction * rload_pool_ns(t, nbytes))
        return {"staging": staging, "pool": pool}

    def choose_spill(self, name: str, nbytes: int) -> str:
        costs = self.spill_costs(nbytes)
        choice = min(costs, key=costs.get)
        self._log("spill", name, nbytes, choice, costs)
        return choice

    # -- shard count ---------------------------------------------------------
    def choose_shards(self, nbytes: int, name: str = "state", *,
                      log: bool = True, device_bytes=None) -> int:
        """Argmin of the modelled sharded-flush wall time.  Candidates stop
        at 2x the link count (beyond that streams only share links and pay
        setup) capped by ``max_shards``.  ``device_bytes`` (the real
        per-device byte loads of a mesh-sharded state, from
        ``meshio.per_device_nbytes``) switches the cost model to
        ``sharded_flush_device_ns`` — per-candidate costs then reflect
        the heaviest pipeline under the actual device layout, and the
        candidate range is additionally capped at the device count (a
        pipeline with no device buffer to drain buys nothing)."""
        t = self.topology
        hi = max(1, min(self.max_shards, 2 * t.n_links))
        if device_bytes is not None:
            hi = max(1, min(hi, len(device_bytes)))
            costs = {k: sharded_flush_device_ns(t, device_bytes, k)
                     for k in range(1, hi + 1)}
        else:
            costs = {k: sharded_flush_ns(t, nbytes, k)
                     for k in range(1, hi + 1)}
        best = min(costs, key=costs.get)
        if log:
            self._log("shards", name, nbytes, best,
                      {f"k{k}": v for k, v in costs.items()})
        return best

    # -- flush schedule ------------------------------------------------------
    def choose_schedule(self, nbytes: int, name: str = "state") -> str:
        """``sync`` when the modelled blocking flush is too small for
        double-buffering to pay for its join bookkeeping, else the
        production ``sharded-async`` schedule."""
        k = self.choose_shards(nbytes, name, log=False)
        flush = sharded_flush_ns(self.topology, nbytes, k)
        choice = "sync" if flush < self.sync_threshold_ns else "sharded-async"
        self._log("schedule", name, nbytes, choice,
                  {"flush_ns": flush,
                   "sync_threshold_ns": self.sync_threshold_ns})
        return choice


    # -- fleet admission -----------------------------------------------------
    def admission_costs(self, queue_depths: Dict[int, int], nbytes: int,
                        reusable: Dict[int, bool]) -> Dict[str, float]:
        """Expected ns until a new request's first token, per engine.
        Two terms: the queue wait (depth x modelled decode tick) and the
        prefill — replayed from the prompt at ``replay_ns_per_byte``
        unless this engine can restore a shared-prefix block set from
        the pool (``reusable``), which costs a pool RLoad instead."""
        t = self.topology
        out: Dict[str, float] = {}
        for eid, depth in queue_depths.items():
            fill = (rload_pool_ns(t, nbytes) if reusable.get(eid)
                    else self.replay_ns_per_byte * nbytes)
            out[f"e{eid}"] = depth * self.decode_tick_ns + fill
        return out

    def choose_admission(self, rid: str, queue_depths: Dict[int, int],
                         nbytes: int,
                         reusable: Dict[int, bool] = {}) -> int:
        """Pick the engine a new request is routed to (lowest expected
        time-to-first-token; ties break to the lowest engine id, which
        keeps the decision deterministic).  Logged as ``admit``."""
        costs = self.admission_costs(queue_depths, nbytes, reusable)
        choice = min(sorted(costs), key=costs.get)
        self._log("admit", rid, nbytes, choice, costs)
        return int(choice[1:])

    # -- fleet rebalancing ---------------------------------------------------
    def migration_costs(self, nbytes: int, imbalance: int
                        ) -> Dict[str, float]:
        """``move``: RStore the session's dirty blocks into the target's
        staging buffer + the target's adoption read.  ``stay``: the
        queue-depth gap keeps costing the session one decode-tick wait
        per tick of imbalance.  Clean pool-resident blocks move zero
        bytes either way (the block table carries them by reference)."""
        t = self.topology
        return {"move": rstore_ns(t, nbytes) + rload_staging_ns(t, nbytes),
                "stay": max(0, imbalance) * self.decode_tick_ns}

    def choose_migration(self, rid: str, nbytes: int,
                         imbalance: int) -> bool:
        """Is migrating ``rid``'s ``nbytes`` of dirty blocks to the less
        loaded engine worth the transfer, given the queue-depth
        ``imbalance`` (source depth minus target depth)?  Logged as
        ``migrate``."""
        costs = self.migration_costs(nbytes, imbalance)
        choice = costs["move"] < costs["stay"]
        self._log("migrate", rid, nbytes, choice, costs)
        return choice

    # -- fleet scaling -------------------------------------------------------
    def _queue_wait_ns(self, queue_depth: int, lanes: int,
                       session_ticks: float) -> float:
        """Total modelled wait of a ``queue_depth``-deep FIFO draining
        through ``lanes`` decode lanes: a lane is HELD for a whole
        session (~``session_ticks`` ticks), so the drain rate is
        lanes/session_ticks sessions per tick and the i-th queued
        session waits ~i*session_ticks/lanes ticks — summing to
        Q(Q+1)/2 * session_ticks/lanes ticks of wait."""
        if lanes <= 0:
            return float("inf")
        q = max(0, queue_depth)
        return (q * (q + 1) / 2.0 * session_ticks / lanes
                * self.decode_tick_ns)

    def scale_costs(self, queue_depth: int, n_engines: int,
                    slots_per_engine: int, state_nbytes: int, *,
                    busy_lanes: int = 0,
                    session_ticks: float = 16.0,
                    session_nbytes: int = 0,
                    window_ticks: int = 32,
                    engine_tick_ns: float = 2e5,
                    min_engines: int = 1,
                    max_engines: int = 8) -> Dict[str, float]:
        """Modelled ns of each scale action over the next decision window.
        Every alternative pays capacity rent (engines x ``engine_tick_ns``
        x window) plus the projected queue wait at the resulting lane
        count; ``grow`` additionally pays the join capital — the staged
        state transfer + re-flush (``emu.join_transfer_ns``) — and
        ``shrink`` pays draining a closing engine's live sessions to
        peers (RStore + adoption read per slot) AND the wait of the load
        the lost lanes displace (``busy_lanes`` — shrinking a busy fleet
        queues what no longer fits).  The controller scales out only
        when the queueing relief beats the join capital within the
        window (the inequality of the reference's ARCHITECTURE §12)."""
        t = self.topology
        lanes = n_engines * slots_per_engine
        rent = engine_tick_ns * window_ticks
        wait = lambda q, l: self._queue_wait_ns(q, l, session_ticks)
        costs = {"hold": wait(queue_depth, lanes) + n_engines * rent}
        if n_engines < max_engines:
            k = self.choose_shards(state_nbytes, log=False)
            costs["grow"] = (join_transfer_ns(t, state_nbytes, k)
                            + wait(queue_depth, lanes + slots_per_engine)
                            + (n_engines + 1) * rent)
        if n_engines > min_engines:
            drain = slots_per_engine * (rstore_ns(t, session_nbytes)
                                        + rload_staging_ns(t, session_nbytes))
            lanes_after = lanes - slots_per_engine
            displaced = queue_depth + max(0, busy_lanes - lanes_after)
            costs["shrink"] = (drain + wait(displaced, lanes_after)
                              + (n_engines - 1) * rent)
        return costs

    def choose_scale(self, name: str, queue_depth: int, n_engines: int,
                     slots_per_engine: int, state_nbytes: int, *,
                     busy_lanes: int = 0, session_ticks: float = 16.0,
                     session_nbytes: int = 0, window_ticks: int = 32,
                     engine_tick_ns: float = 2e5, min_engines: int = 1,
                     max_engines: int = 8) -> str:
        """Pick hold / grow / shrink for the fleet (ties break to
        ``hold`` — scaling must strictly pay for itself).  Logged as
        ``scale`` with every priced alternative, so the decision log
        shows WHY capacity moved, per topology."""
        costs = self.scale_costs(
            queue_depth, n_engines, slots_per_engine, state_nbytes,
            busy_lanes=busy_lanes, session_ticks=session_ticks,
            session_nbytes=session_nbytes, window_ticks=window_ticks,
            engine_tick_ns=engine_tick_ns, min_engines=min_engines,
            max_engines=max_engines)
        choice = min(sorted(costs), key=lambda a: (costs[a], a != "hold"))
        if costs[choice] >= costs["hold"]:
            choice = "hold"
        self._log("scale", name, state_nbytes, choice, costs)
        return choice


def plan_rank_staging(policy: PlacementPolicy, nbytes: int,
                      name: str = "partition") -> bool:
    """Should a cluster rank RStore-stage its ``nbytes`` partition into its
    ring sibling every step?  Yes iff the policy's spill model prefers the
    staging tier for this size under the active topology — otherwise the
    per-step RStore is dead weight and recovery should come from the pool
    (which the commit cadence already feeds).  Logged as a ``staging``
    decision."""
    costs = policy.spill_costs(nbytes)
    choice = costs["staging"] <= costs["pool"]
    policy._log("staging", name, nbytes, choice, costs)
    return choice
