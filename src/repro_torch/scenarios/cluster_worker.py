"""The killable CLUSTER worker: rank i of N data-parallel processes over ONE
shared DSM pool — the port of ``repro.scenarios.cluster_worker``.

Each rank OWNS a disjoint partition of a deterministic toy model state
(``train.elastic.partition_plan``) and the ranks advance in lockstep: per
step every rank computes the gradient contribution of its data shard
(``data.pipeline.shard_plan`` slice of the global batch), the
contributions are summed bit-exactly on the file all-reduce board, and
each rank applies the same scalar update to its owned tensors — so the
CLUSTER state at step k is a pure function of (seed, membership history),
and a crash + shrink + replay must be bit-identical to a planned shrink at
the same step.

Every step each rank LStores its partition and RStore-stages it into its
ring sibling's spill-file buffer; every ``--commit-every`` steps it
RFlushes (sharded pipelines) and completes through the multi-writer
cluster protocol: rank record, then ONE elected cluster manifest
referencing every rank's objects at that step.

``--kill-point`` arms the commit-window fault hook: the rank prints a JSON
kill line and ``os._exit``s at pre_flush / mid_flush / post_completeOp of
the first commit at or after ``--kill-step``.  Survivors detect the death
while blocked on the victim's all-reduce contribution (the orchestrator
posts the membership change), then run the elastic shrink protocol:

1. the victim's ring sibling recovers the victim's partition —
   **peer-staging** (its own spill buffer) if the staged step tag beats
   the newest cluster manifest, else **pool** — and publishes the
   recovered step ``q`` + source;
2. if ``q`` is older than the survivors' live step they ROLL BACK to the
   cluster manifest at ``q`` (never mix steps);
3. all survivors (the sibling also covering the victim's objects)
   GPF-flush state at ``q`` and commit a gen+1 recovery manifest;
4. everyone re-reads the full state from that manifest, repartitions over
   the survivor set, re-places the tensors it adopts on its device slice
   (``train.elastic.remesh`` over ``launch.mesh.rank_submesh``), re-plans
   data shards and resumes at ``q + 1``.

A planned shrink (``--shrink-at``, posted as a planned control entry by
the launcher) runs steps 3-4 with the departing rank still alive — the
reference run every kill scenario must match bit for bit.  A planned GROW
(a ``kind="grow"`` control change; the joiner runs with ``--joiner
--join-at s``) is the inverse, with the three join-phase kill points
(``dsm.faults.JOIN_POINTS``).

``--device cuda`` (the default) keeps each rank's owned tensors on the
card (every rank of a one-card cluster shares ``cuda:0``) and raises
without one; ``--device cpu`` keeps them on the host.  Pool and staging
reads come back as host tensors and are placed through ``remesh``; the
update runs on the device in fp32, one elementwise op at a time in the
reference's order (no fused or FMA-contracting op), so its bits equal the
reference's numpy update on either device.  The digest of a tensor is the
CRC32 of ``p``'s bytes after ``.cpu()``.  Beside the reference's fields
the result reports ``start_s`` (process start to the end of its first
step), ``recover_s`` (seconds from learning of a membership change to
resuming, None without one), ``recovered_bytes`` (bytes read back from
staging or the pool by recovery and repartitioning), ``commits``,
``steps_run`` and ``device``.

    python -m repro_torch.scenarios.cluster_worker --device cpu \\
        --pool "$TMPDIR/p" --rank 1 --world 3 --kill-point mid_flush \\
        --kill-step 3
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import SyntheticLMSource, shard_plan
from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.cluster import (POLL_S, ClusterProtocol, ControlPlane,
                                     FileStagingArea, MembershipChange,
                                     ScalarReduceBoard, rank_ns,
                                     ring_sibling)
from repro_torch.dsm.emu import tree_nbytes
from repro_torch.dsm.faults import JOIN_POINTS
from repro_torch.dsm.flit_runtime import KILL_POINTS
from repro_torch.dsm.pool import DSMPool, manifest_entry
from repro_torch.dsm.recovery import ColdStartError
from repro_torch.launch.mesh import mesh_device_sets, rank_submesh
from repro_torch.scale.grow import join_moves, join_name, join_templates
from repro_torch.scenarios.worker import kill_now, process_age_s
from repro_torch.train.elastic import partition_plan, remesh, reshard
from repro_torch.utils.device import resolve_device


def tensor_names(n: int) -> List[str]:
    return [f"t{i:02d}" for i in range(n)]


def init_tensor(name: str, dim: int, seed: int,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Deterministic per-tensor init: the reference's numpy draw, moved to
    ``device`` — any rank (or a replay) derives the same values, which is
    what makes ownership a pure bookkeeping choice."""
    rng = np.random.default_rng((seed, int(name[1:]), 0xC1))
    p = rng.standard_normal((dim, dim)).astype(np.float32)
    return {"p": torch.from_numpy(p).to(device),
            "mu": torch.zeros((dim, dim), dtype=torch.float32,
                              device=device),
            "nu": torch.zeros((dim, dim), dtype=torch.float32,
                              device=device)}


def partition_templates(rank: int, partition: Dict[str, int],
                        dim: int) -> Dict[str, Any]:
    """Pytree prototypes of one rank's two objects (for recovery reads)."""
    owned = sorted(t for t, r in partition.items() if r == rank)
    z = lambda: np.zeros((dim, dim), np.float32)
    return {
        rank_ns(rank, "params"): {t: z() for t in owned},
        rank_ns(rank, "opt"): {t: {"mu": z(), "nu": z()} for t in owned},
    }


class ClusterWorker:
    def __init__(self, args, fault_hook=None):
        self.args = args
        self.rank = args.rank
        self.device = resolve_device(args.device)
        self.fault_hook = fault_hook
        # --world is always the ORIGINAL world; a joiner's rank is outside
        # it and enters the live set only through the join protocol
        self.live = list(range(args.world))
        self.gen = 0
        #: control-log indices this process already acted on — a planned
        #: change is applied AT MOST ONCE
        self._applied_changes: set = set()
        self.pool = DSMPool(args.pool)
        self.control = ControlPlane(os.path.join(args.pool, "control"))
        self.board = ScalarReduceBoard(os.path.join(args.pool, "reduce"))
        self.staging = FileStagingArea(os.path.join(args.pool, "staging"))
        self.names = tensor_names(args.tensors)
        # each rank owns a device SLICE (launch.mesh.rank_submesh); the
        # partition plan weights ranks by their slice's device count
        self.partition = partition_plan(self.names, self.live,
                                        self._device_sets(self.live))
        self.tensors = {t: init_tensor(t, args.dim, args.seed, self.device)
                        for t in self.names if self.partition[t] == self.rank}
        self.source = SyntheticLMSource(1024)
        self.proto = ClusterProtocol(self.pool, self.rank, self.live,
                                     confirm=fault_hook is not None,
                                     retention=args.retention or None,
                                     timeout=args.timeout)
        # cost-driven placement (--topology): the policy decides whether
        # ring RStore-staging this rank's partition is worth its per-step
        # cost, and sizes the shard pipelines from the partition bytes
        placement = None
        self._stage_to_sibling = bool(args.replicate)
        n_shards = args.shards
        if getattr(args, "topology", None):
            from repro_torch.dsm.placement import (PlacementPolicy,
                                                   plan_rank_staging)
            placement = PlacementPolicy(args.topology)
            part_bytes = tree_nbytes(self.state_objects())
            self._stage_to_sibling = (args.replicate and plan_rank_staging(
                placement, part_bytes))
            n_shards = None             # resolved by the policy per bytes
        # one wiring path: the context owns tiers + committer; the cluster
        # protocol plugs in as the delegated completeOp and the ring
        # sibling as the RStore peer
        self.ctx = open_cxl0(
            self.pool, self.rank, schedule="sharded", n_shards=n_shards,
            placement=placement, fault_hook=fault_hook,
            complete_fn=self.proto.cluster_complete,
            replicate_to=self._proxy())
        self.tiers = self.ctx.tiers
        self.placement = self.ctx.placement
        self.committer = self.ctx.committer
        self.step_done = -1          # last step whose update is applied
        self.resumed_from: Optional[int] = None
        self.source_used: Optional[str] = None
        #: measurements beside the reference's result fields
        self.recover_s: Optional[float] = None
        self.recovered_bytes = 0
        self.commits = 0
        self.steps_run = 0
        self.start_s: Optional[float] = None

    def _device_sets(self, live):
        return mesh_device_sets(live, self.device)

    def _proxy(self):
        if not self._stage_to_sibling or self.rank not in self.live:
            return None       # a joiner has no ring sibling until adopted
        return self.staging.proxy(ring_sibling(self.rank, self.live))

    def _point(self, point: str, step: int):
        """Fire a protocol-phase fault point OUTSIDE the committer's
        commit window (the join phases) — same hook, same semantics."""
        if self.fault_hook is not None:
            self.fault_hook(point, step)

    def _place(self, tensors: Dict[str, Dict[str, Any]]
               ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Host tensors read back from staging or the pool -> this rank's
        device slice (``remesh``; the reshard transfer of a real
        cluster).  A rank computes on its slice's first device: laying its
        partition over a slice of several is sharded compute (ROADMAP
        A7b)."""
        placed, _ = remesh(tensors, None, rank_submesh(
            self.rank, self.live, self.device)[:1])
        return placed

    def _count_read(self, tree):
        self.recovered_bytes += tree_nbytes(tree)

    # -- state objects -------------------------------------------------------
    @property
    def owned(self) -> List[str]:
        return sorted(t for t, r in self.partition.items()
                      if r == self.rank)

    def state_objects(self) -> Dict[str, Any]:
        return {
            rank_ns(self.rank, "params"):
                {t: self.tensors[t]["p"] for t in self.owned},
            rank_ns(self.rank, "opt"):
                {t: {"mu": self.tensors[t]["mu"],
                     "nu": self.tensors[t]["nu"]} for t in self.owned},
        }

    def _meta(self, extra: Optional[dict] = None) -> dict:
        return self.proto.meta_for(partition=self.partition,
                                   **(extra or {}))

    # -- the deterministic data-parallel step --------------------------------
    def _partial(self, step: int) -> float:
        plan = shard_plan(self.args.global_batch, len(self.live))
        s, c = plan[sorted(self.live).index(self.rank)]
        tok = self.source.sequence_batch(
            self.args.seed, step * self.args.global_batch + s, c,
            self.args.seq + 1)
        # sum (not mean) of per-sequence means: the cross-rank combine is
        # then independent of how the batch is sharded
        return float(tok[:, :-1].astype(np.float64).mean(axis=1).sum())

    def _apply(self, x: np.float32):
        """The reference's fp32 update, one elementwise op a kernel in its
        order: ``g = 0.01 p + x``, ``p -= 0.1 g``, ``mu = 0.9 mu + 0.1 g``,
        ``nu = 0.95 nu + (0.05 g) g``.  Python-float scalars round to the
        same fp32 as ``np.float32``; ``x`` is an fp32 value."""
        x = float(np.float32(x))
        for t in self.owned:
            d = self.tensors[t]
            g = torch.add(torch.mul(d["p"], 0.01), x)
            d["p"] = torch.sub(d["p"], torch.mul(g, 0.1))
            d["mu"] = torch.add(torch.mul(d["mu"], 0.9), torch.mul(g, 0.1))
            d["nu"] = torch.add(torch.mul(d["nu"], 0.95),
                                torch.mul(torch.mul(g, 0.05), g))

    # -- shrink protocol -----------------------------------------------------
    def _flush_and_record(self, q: int,
                          extra: Optional[Dict[str, Any]] = None,
                          meta: Optional[dict] = None) -> dict:
        """GPF leg of a shrink: durably flush my objects (+ any adopted
        victim objects) at step ``q``, record, elect, and WAIT for the
        cluster manifest — the barrier every shrink participant crosses."""
        entries = {}
        objs = dict(self.state_objects())
        objs.update(extra or {})
        for name, tree in objs.items():
            self.tiers.lstore(name, tree)
            entries[name] = manifest_entry(self.tiers.rflush(name))
        self.proto.write_record(q, entries)
        self.proto.try_commit(q, meta or self._meta())
        self.commits += 1
        return self.proto.wait_manifest(q, control=self.control)

    def _repartition(self, m: dict, old_partition: Dict[str, int],
                     old_live: List[int]):
        """Re-read the FULL state from the shrink manifest, take my slice of
        the new partition over the survivor set, and place it on my device
        slice (``remesh``)."""
        full: Dict[str, Dict[str, Any]] = {}
        for r in sorted(old_live):
            tpl = partition_templates(r, old_partition, self.args.dim)
            pname, oname = rank_ns(r, "params"), rank_ns(r, "opt")
            params = self.pool.read_entry(pname, m["objects"][pname],
                                          tpl[pname])
            opt = self.pool.read_entry(oname, m["objects"][oname],
                                       tpl[oname])
            for t, p in params.items():
                full[t] = {"p": p, "mu": opt[t]["mu"], "nu": opt[t]["nu"]}
        self.partition = partition_plan(self.names, self.live,
                                        self._device_sets(self.live))
        mine = {t: full[t] for t in self.names
                if self.partition[t] == self.rank}
        self._count_read(mine)
        self.tensors = self._place(mine)
        if self.placement is not None:
            # partition sizes changed: re-price the staging decision and
            # let the next commit re-resolve the shard count
            self.committer.n_shards = None
            if self.args.replicate:
                from repro_torch.dsm.placement import plan_rank_staging
                self._stage_to_sibling = plan_rank_staging(
                    self.placement, tree_nbytes(self.state_objects()))
        self.committer.replicate_to = self._proxy()

    def _crash_shrink(self, victim: int):
        """A peer died mid-run: recover its partition (peer-staging beats
        the pool if newer), roll back if the pool copy is older than our
        live step, commit the gen+1 recovery manifest, repartition."""
        t0 = time.perf_counter()
        old_live, old_partition = list(self.live), dict(self.partition)
        gen_new = self.gen + 1
        live_new = [r for r in old_live if r != victim]
        adopter = ring_sibling(victim, old_live)
        victim_tpl = partition_templates(victim, old_partition,
                                         self.args.dim)
        if self.rank == adopter:
            view = self.staging.view(self.rank, victim_tpl)
            try:
                vobjs, q, source = self.ctx.recover(
                    victim_tpl, peers=(view,), exact=False)
            except ColdStartError:
                # the victim never durably committed under its OWN
                # namespace (a joiner killed mid-join): its entries come
                # from the newest manifest's partition meta
                vobjs, q, source = self._recover_via_manifest(victim)
            self._count_read(vobjs)
            self.control.post_shrink_result(
                gen_new, {"q": q, "source": source, "victim": victim,
                          "live": live_new})
        else:
            doc = self.control.wait_shrink_result(
                gen_new, timeout=self.args.timeout)
            q, source, vobjs = doc["q"], doc["source"], None
        self.gen = gen_new
        self.live = live_new
        self.proto.set_membership(gen_new, live_new)
        if q < self.step_done:
            # the victim's newest copy predates our live state: the whole
            # cluster rolls back to the manifest at q — never mix steps
            mq = self.proto.find_manifest(q)
            my_tpl = partition_templates(self.rank, old_partition,
                                         self.args.dim)
            pname, oname = rank_ns(self.rank, "params"), \
                rank_ns(self.rank, "opt")
            params = self.pool.read_entry(pname, mq["objects"][pname],
                                          my_tpl[pname])
            opt = self.pool.read_entry(oname, mq["objects"][oname],
                                       my_tpl[oname])
            back = {t: {"p": params[t], "mu": opt[t]["mu"],
                        "nu": opt[t]["nu"]} for t in params}
            self._count_read(back)
            self.tensors = reshard(back, self.device)
            self.step_done = q
        meta = self.proto.meta_for(
            partition=old_partition,
            next_partition=partition_plan(self.names, live_new,
                                          self._device_sets(live_new)),
            recovered={"victim": victim, "source": source})
        m = self._flush_and_record(q, extra=vobjs, meta=meta)
        self._repartition(m, old_partition, old_live)
        self.step_done = q
        self.resumed_from = q
        self.source_used = source
        self.recover_s = time.perf_counter() - t0

    def _planned_shrink(self, victim: int, at_step: int) -> bool:
        """Elastic scale-down at a step boundary: every rank — the
        departing one included — flushes state at ``at_step - 1`` into a
        gen+1 manifest; survivors repartition and continue.  Returns True
        if THIS rank is the one departing."""
        t0 = time.perf_counter()
        old_live, old_partition = list(self.live), dict(self.partition)
        q = at_step - 1
        gen_new = self.gen + 1
        self.gen = gen_new
        self.proto.set_membership(gen_new, old_live)   # all ranks record
        live_new = [r for r in old_live if r != victim]
        meta = self.proto.meta_for(
            partition=old_partition,
            next_partition=partition_plan(self.names, live_new,
                                          self._device_sets(live_new)),
            planned_shrink={"victim": victim, "at_step": at_step})
        m = self._flush_and_record(q, meta=meta)
        if self.rank == victim:
            return True
        self.live = [r for r in old_live if r != victim]
        self.proto.set_membership(gen_new, self.live)
        self._repartition(m, old_partition, old_live)
        self.recover_s = time.perf_counter() - t0
        return False

    # -- grow protocol -------------------------------------------------------
    def _planned_grow(self, joiner: int, at_step: int):
        """Elastic scale-UP at a step boundary, old-rank side: stage the
        joiner's new partition into ITS buffer (``join_staged``), flush my
        state at ``q = at_step - 1`` under the OLD partition into ONE gen+1
        manifest naming the joiner (``join_committed``), then switch to the
        grown live set and repartition (``join_adopted``)."""
        old_live, old_partition = list(self.live), dict(self.partition)
        q = at_step - 1
        gen_new = self.gen + 1
        live_new = sorted(old_live + [joiner])
        new_partition = partition_plan(self.names, live_new,
                                       self._device_sets(live_new))
        moves = join_moves(old_partition, new_partition, joiner)
        buf = self.staging.proxy(joiner).staging
        for t in sorted(moves):
            if moves[t] == self.rank:
                d = self.tensors[t]
                buf[join_name(t)] = (q, {"p": d["p"], "mu": d["mu"],
                                         "nu": d["nu"]})
        self._point("join_staged", q)
        self.gen = gen_new
        self.proto.set_membership(gen_new, old_live)   # old ranks record
        meta = self.proto.meta_for(
            partition=old_partition, next_partition=new_partition,
            join={"member": joiner, "at_step": at_step})
        m = self._flush_and_record(q, meta=meta)
        self._point("join_committed", q)
        self.live = live_new
        self.proto.set_membership(gen_new, live_new)
        self._repartition(m, old_partition, old_live)
        self._point("join_adopted", q)

    def _join(self, at_step: int):
        """Joiner side: observe the three phases and adopt.  The new
        partition is a pure function of the grown live set; the joiner's
        state comes staging-first (the copies the old ranks RStored into
        THIS rank's buffer, tag ``q``) with pool fallback through the join
        manifest's old-partition meta."""
        t0 = time.perf_counter()
        q = at_step - 1
        old_live, old_partition = list(self.live), dict(self.partition)
        live_new = sorted(old_live + [self.rank])
        new_partition = partition_plan(self.names, live_new,
                                       self._device_sets(live_new))
        moves = join_moves(old_partition, new_partition, self.rank)
        tpl = join_templates(moves, self.args.dim)
        deadline = time.monotonic() + self.args.timeout
        staged: Dict[str, Any] = {}
        while True:
            view = self.staging.view(self.rank, tpl)
            staged = {n: t for n, (tag, t) in view.staging.items()
                      if tag == q}
            if set(staged) == set(tpl):
                break
            m = self.proto.find_manifest(q)
            if m is not None and \
                    m["meta"].get("join", {}).get("member") == self.rank:
                staged = {}
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"join staging for rank {self.rank} "
                                   f"never completed")
            time.sleep(POLL_S)
        self._point("join_staged", q)
        while True:
            m = self.proto.find_manifest(q)
            if m is not None and \
                    m["meta"].get("join", {}).get("member") == self.rank:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"join manifest for rank {self.rank} "
                                   f"never appeared")
            time.sleep(POLL_S)
        self._point("join_committed", q)
        self.gen = int(m["meta"]["gen"])
        self.live = live_new
        self.proto.set_membership(self.gen, live_new)
        self.partition = new_partition
        if set(staged) == set(tpl) and tpl:
            mine = {t: staged[join_name(t)] for t in moves}
            source = "peer-staging"
        else:
            mine, source = self._read_via_partition_meta(
                m, sorted(moves)), "pool"
        self._count_read(mine)
        self.tensors = self._place(mine)
        if self.placement is not None:
            self.committer.n_shards = None
            if self.args.replicate:
                from repro_torch.dsm.placement import plan_rank_staging
                self._stage_to_sibling = plan_rank_staging(
                    self.placement, tree_nbytes(self.state_objects()))
        self.committer.replicate_to = self._proxy()
        self.step_done = q
        self.resumed_from = q
        self.source_used = source
        self.recover_s = time.perf_counter() - t0
        self._point("join_adopted", q)

    def _recover_via_manifest(self, victim: int):
        """Recover a victim that owns entries under the CURRENT partition
        but never committed them under its own ``w<victim>/`` namespace (a
        joiner killed at a join phase): the newest manifest's partition
        meta maps those entries back to the ranks that flushed them."""
        ms = self.proto._manifests_desc()
        if not ms:
            raise ColdStartError("no manifest to recover a joiner victim "
                                 "from")
        m = ms[0]
        need = sorted(t for t, r in self.partition.items() if r == victim)
        full = self._read_via_partition_meta(m, need)
        vobjs = {
            rank_ns(victim, "params"): {t: full[t]["p"] for t in need},
            rank_ns(victim, "opt"): {t: {"mu": full[t]["mu"],
                                         "nu": full[t]["nu"]}
                                     for t in need},
        }
        return vobjs, int(m["step"]), "pool"

    def _read_via_partition_meta(self, m: dict, tensors: List[str]
                                 ) -> Dict[str, Dict[str, Any]]:
        """Read ``tensors`` out of manifest ``m`` through ITS partition
        meta — the owners' ``w<r>/params`` / ``w<r>/opt`` aggregates as of
        that manifest, whatever the partition is NOW."""
        mpart = {t: int(r) for t, r in m["meta"]["partition"].items()}
        out: Dict[str, Dict[str, Any]] = {}
        for r in sorted({mpart[t] for t in tensors}):
            tpl = partition_templates(r, mpart, self.args.dim)
            pname, oname = rank_ns(r, "params"), rank_ns(r, "opt")
            params = self.pool.read_entry(pname, m["objects"][pname],
                                          tpl[pname])
            opt = self.pool.read_entry(oname, m["objects"][oname],
                                       tpl[oname])
            for t in tensors:
                if mpart[t] == r:
                    out[t] = {"p": params[t], "mu": opt[t]["mu"],
                              "nu": opt[t]["nu"]}
        return out

    # -- main loop -----------------------------------------------------------
    def run(self) -> dict:
        if getattr(self.args, "joiner", False):
            # a joiner enters through the join protocol, not the floor
            # barrier: it adopts at join_at - 1 and steps from join_at
            self._join(self.args.join_at)
            k = self.args.join_at
        else:
            # initial durable floor (step -1): even a kill inside the
            # FIRST commit window leaves a recoverable cluster manifest;
            # doubles as the start barrier
            self.ctx.put(self.state_objects(), step=-1)
            with self.ctx.commit(-1, meta=self._meta()):
                pass
            self.commits += 1
            self.proto.wait_manifest(-1, control=self.control)
            k = 0

        while k < self.args.steps:
            for ch in self.control.changes():
                if (ch["idx"] in self._applied_changes
                        or not ch.get("planned")
                        or ch.get("at_step") != k):
                    continue
                self._applied_changes.add(ch["idx"])
                if ch["kind"] == "shrink" and ch["member"] in self.live:
                    if self._planned_shrink(ch["member"], k):
                        return self._result({"planned_exit_at": k})
                elif (ch["kind"] == "grow"
                        and ch["member"] not in self.live
                        and ch["member"] != self.rank):
                    self._planned_grow(ch["member"], k)
            self.board.contribute(self.gen, k, self.rank, self._partial(k))
            try:
                total = self.board.combine(self.gen, k, self.live,
                                           control=self.control,
                                           timeout=self.args.timeout)
            except MembershipChange as e:
                self._crash_shrink(e.victim)
                k = self.step_done + 1
                continue
            self._apply(np.float32(total / self.args.global_batch / 1000.0))
            self.step_done = k
            self.steps_run += 1
            if self.start_s is None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                self.start_s = process_age_s()
            self.ctx.put(self.state_objects(), step=k)
            if (k + 1) % self.args.commit_every == 0:
                with self.ctx.commit(k, meta=self._meta()):
                    pass
                self.commits += 1
            k += 1

        # final GPF commit: make the last step durable whatever the cadence
        last = self.args.steps - 1
        if self.proto.find_manifest(last, gen=self.gen) is None:
            self._flush_and_record(last, meta=self._meta())
        digests = {
            t: zlib.crc32(self.tensors[t]["p"].cpu().contiguous()
                          .numpy().tobytes())
            for t in self.owned}
        return self._result({"live": sorted(self.live), "gen": self.gen,
                             "resumed_from": self.resumed_from,
                             "source": self.source_used,
                             "digests": digests, "final_step": last})

    def _result(self, fields: dict) -> dict:
        dev = self.device
        return {"rank": self.rank, **fields,
                "start_s": self.start_s, "recover_s": self.recover_s,
                "recovered_bytes": self.recovered_bytes,
                "commits": self.commits, "steps_run": self.steps_run,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--commit-every", type=int, default=2)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--tensors", type=int, default=6)
    ap.add_argument("--global-batch", type=int, default=6)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--replicate", type=int, default=1,
                    help="RStore-stage into the ring sibling (1) or not "
                         "(0 — recovery must come from the pool)")
    ap.add_argument("--retention", type=int, default=0,
                    help="cluster manifests kept by the elected "
                         "committer's post-commit gc (0 = unbounded)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="rendezvous timeout (s)")
    ap.add_argument("--topology", default=None,
                    help="emulated CXL topology preset (dsm.emu.PRESETS): "
                         "the placement policy decides ring staging and "
                         "the shard count from the partition bytes")
    ap.add_argument("--joiner", action="store_true",
                    help="this rank GROWS the cluster: it is outside "
                         "--world and runs the join protocol at --join-at")
    ap.add_argument("--join-at", type=int, default=0,
                    help="step the planned grow is posted for (the "
                         "joiner adopts state at join_at - 1)")
    ap.add_argument("--kill-point", default="none",
                    choices=("none",) + KILL_POINTS + JOIN_POINTS)
    ap.add_argument("--kill-step", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where each rank's owned tensors live")
    args = ap.parse_args(argv)

    box = {}
    hook = None
    if args.kill_point != "none":
        def hook(point, step):
            if point == args.kill_point and step >= args.kill_step:
                w = box.get("worker")
                kill_now(point, step, rank=args.rank,
                         steps_run=w.steps_run if w else 0)

    worker = ClusterWorker(args, fault_hook=hook)
    box["worker"] = worker
    print(json.dumps(worker.run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
