"""Fleet controller: N serve engines sharing ONE CXL0 pool — the port of
``repro.serve.fleet``.

The paper's pooled-memory regime (CXL 2.0 switched pool and up) is N
compute hosts load/storing into one cache-coherent capacity substrate.
For serving, that substrate is the paged KV layout (serve.paging): every
engine ``open_cxl0``s the SAME pool directory under a per-engine
namespace (``e<i>/`` object names, ``engine: i`` manifests), and three
fleet mechanisms fall out of blocks-as-pool-objects:

* **cost-routed admission** — a new request goes to the engine with the
  lowest modelled time-to-first-token (``dsm.placement.choose_admission``:
  queue depth x decode tick + prefill replay vs pool block restore when
  the prompt's shared-prefix objects already exist).  Every decision is
  logged on the policy and assertable;
* **live session migration** — an in-flight session moves between
  engines without losing a token.  The four-phase protocol (each phase
  boundary is a kill point the scenario runner drives):

    1. ``mig_stage``   source freezes the session (slot freed — the
                       scheduler refills it the same tick), LStores its
                       dirty blocks and RStores them into the TARGET's
                       staging buffer (``FileStagingArea`` — the peer
                       host-memory arm).  Clean blocks move zero bytes:
                       the block table carries their pool entries;
    2. ``mig_commit``  source commits the handoff: ``migrated_to`` marker
                       + block table + dirty-block flushes in ONE
                       manifest.  From here the target owns the session,
                       crash or no crash;
    3. ``mig_adopt``   target assembles the cache staging-first-else-pool
                       (both arms hold identical bytes — the handoff
                       commit flushed exactly what was staged), re-admits
                       the session AHEAD of its queue, and commits the
                       adoption under its own namespace;
    4. ``mig_release`` source drops its copy; the tombstone leaves its
                       committed table at its next commit.

  A kill before phase 2's manifest lands leaves the source the owner (it
  resumes the session as usual; the orphaned staging copies are inert).
  A kill after phase 2 leaves a durable marker: ``resume()`` finds it via
  the source's recovered handoff table and completes the adoption —
  staging-or-pool, bit-identical either way.  Manifests, tables and
  staging frames are the reference's, so each package resumes the
  other's killed fleet pool;
* **cross-engine prefix reuse** — the content-addressed ``kvblk/``
  objects (serve.sessions) are unnamespaced on purpose: any engine's
  publish serves every engine's admissions.

Exactly-one-owner invariant: a session is served by the engine whose
newest manifest holds it WITHOUT a ``migrated_to`` marker; a marker
points at the adopter.  ``resume()`` re-establishes the invariant from
manifests alone.

Every engine runs on ``device`` (``"cuda"`` by default; a bundle on
another device is refused, so no engine carries on on the CPU behind the
caller's back).  The placement policy's costs are MODELLED ns of the
emulated CXL topology (``dsm.emu``), not times measured here.  Not ported:
the committer's ``fault_hook`` kill points (ROADMAP A5); the migration's
four kill points (``mig_hook``) are.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.dsm.cluster import FileStagingArea
from repro_torch.dsm.placement import PlacementPolicy
from repro_torch.serve.engine import (ServeEngine, ServeResult,
                                      build_serve_engine)
from repro_torch.serve.paging import (BLOCK_TOKENS, BlockAllocator,
                                      BlockTable, STATE_BLOCK, prefix_hash,
                                      shared_head_name)
from repro_torch.serve.scheduler import Request

#: the four kill points of the migration protocol, in order — the hook
#: fires AFTER each phase's effects (same convention as the committer's
#: fault points: "pre_flush" fires before the flush, "mig_commit" fires
#: after the handoff manifest landed)
MIGRATION_POINTS = ("mig_stage", "mig_commit", "mig_adopt", "mig_release")

DEFAULT_TOPOLOGY = "cxl20-switched-pool"


@dataclasses.dataclass
class FleetResult:
    outputs: Dict[str, List[int]]         # rid -> tokens, fleet-wide
    per_engine: Dict[int, ServeResult]
    migrations: int
    prefix_hits: int
    emitted_tokens: int


class FleetController:
    """N engines, one pool, one shared frame allocator, one cost model.

    Engine ids are 1-based: id 0 is the single-engine legacy layout
    (unprefixed names), so a fleet pool and a single-engine pool can
    never alias each other's objects."""

    def __init__(self, arch: str = "olmo-1b", *, pool_path: str,
                 n_engines: int = 2, smoke: bool = True, n_slots: int = 2,
                 t_max: int = 48, commit_every: int = 2,
                 commit_mode: str = "sync",
                 topology: Optional[str] = None,
                 prefix_reuse: bool = True,
                 block_tokens: int = BLOCK_TOKENS, seed: int = 0,
                 restore_mode: str = "cache", retire_done: bool = False,
                 mig_hook: Optional[Callable] = None,
                 prefix_key: Optional[str] = None,
                 bundle=None, params=None, device="cuda"):
        """``prefix_key`` names the weights for prefix reuse (default: the
        port's own key of ``build_serve_engine``); pass the reference's
        key when ``bundle`` / ``params`` carry the reference's weights."""
        if n_engines < 1:
            raise ValueError(f"n_engines={n_engines}: a fleet needs one")
        if bundle is not None \
                and bundle.device.type != torch.device(device).type:
            raise ValueError(f"bundle on {bundle.device}, fleet asked for "
                             f"{device}")
        self.pool_path = pool_path
        self.topology = topology or DEFAULT_TOPOLOGY
        self.policy = PlacementPolicy(self.topology)
        self.mig_hook = mig_hook
        #: the migration staging arm lives INSIDE the pool directory
        #: (the pool only reads objects/ and manifests/) so one path
        #: names the whole shared substrate and staged handoffs survive
        #: process restarts like real peer host memory survives a
        #: SIBLING's crash
        self.staging = FileStagingArea(os.path.join(pool_path, "staging"))
        # ONE frame pool fleet-wide: migration moves a table's frames
        # between engines without alloc/free traffic
        frames = n_slots * (-(-t_max // block_tokens) + 1) + 8
        allocator = BlockAllocator(max(64, 4 * frames * n_engines))
        # everything a later add_engine() must replay to build an
        # identical serving front (bundle/params/allocator attach below)
        self._arch = arch
        self._build_kwargs = dict(
            smoke=smoke, n_slots=n_slots, t_max=t_max,
            pool_path=pool_path, commit_every=commit_every,
            commit_mode=commit_mode, topology=topology, seed=seed,
            restore_mode=restore_mode, retire_done=retire_done,
            block_tokens=block_tokens, prefix_reuse=prefix_reuse,
            prefix_key=prefix_key, device=device)
        self._bundle, self._params = bundle, params
        self.engines: Dict[int, ServeEngine] = {}
        self.allocator = allocator
        for _ in range(n_engines):
            self.add_engine()
        self.n_migrations = 0
        self.migration_log: List[tuple] = []
        #: finished work of engines that have since been drained away —
        #: results outlive the engine that produced them
        self._retired: Dict[int, ServeResult] = {}

    # -- elastic membership --------------------------------------------------
    def add_engine(self) -> int:
        """Grow the fleet by one serving front (next free 1-based id —
        ids are never reused, so a re-added engine can't alias a closed
        one's pool namespace).  The new engine shares the fleet's weight
        pytree and frame allocator; it serves admissions from its first
        tick.  Returns the new engine id."""
        eid = max(self.engines, default=0) + 1
        eng, cfg = build_serve_engine(
            self._arch, engine_id=eid, allocator=self.allocator,
            bundle=self._bundle, params=self._params,
            **self._build_kwargs)
        self.engines[eid] = eng
        self._bundle, self._params = eng.bundle, eng.params
        self.cfg = cfg
        return eid

    def remove_engine(self, eid: int):
        """Shrink the fleet by draining one engine: every RUNNING session
        live-migrates (token-lossless, the four-phase protocol) to the
        least-loaded peer, every PENDING request re-routes through
        cost-priced admission, then the engine closes.  Its pool
        namespace stays durable — history is never rewritten."""
        if len(self.engines) <= 1:
            raise ValueError("cannot remove the last engine")
        e = self.engines[eid]
        for rid in [r for r in e.sched.admission_order
                    if r in e.sched.running]:
            depths = {i: d for i, d in self.queue_depths().items()
                      if i != eid}
            dst = min(sorted(depths), key=lambda i: depths[i])
            self.migrate(rid, eid, dst)
        pending = list(e.sched.pending)
        e.sched.pending.clear()
        del self.engines[eid]
        if pending:
            self.submit(pending)
        self._retired[eid] = e.finish()
        e.close()

    # -- routing -------------------------------------------------------------
    def queue_depths(self) -> Dict[int, int]:
        return {i: e.sched.n_running + len(e.sched.pending)
                for i, e in self.engines.items()}

    def _prefix_reusable(self, e: ServeEngine, prompt) -> bool:
        if not e.prefix_reuse:
            return False
        h = prefix_hash(e.prefix_key, prompt, e.pager.block_tokens)
        return e.store.pool.max_version(shared_head_name(h)) > 0

    def submit(self, requests: Sequence[Request]):
        """Route each request to the engine the cost model picks.  The
        pool is shared, so prefix reusability is fleet-global — it
        lowers every engine's fill cost equally and the queue-depth term
        decides (logged per request as an ``admit`` decision)."""
        for r in requests:
            if any(r.rid in e.sessions or r.rid in e.results
                   for e in self.engines.values()):
                continue                      # recovered somewhere already
            first = next(iter(self.engines.values()))
            nbytes = len(r.prompt) * first.pager.token_nbytes
            hit = self._prefix_reusable(first, r.prompt)
            eid = self.policy.choose_admission(
                r.rid, self.queue_depths(), nbytes,
                {i: hit for i in self.engines})
            self.engines[eid].submit([r])

    # -- the fleet loop ------------------------------------------------------
    @property
    def done(self) -> bool:
        return all(e.sched.done for e in self.engines.values())

    def tick(self, *, rebalance: bool = True):
        """One lockstep round: every engine ticks, then at most one
        cost-approved rebalancing migration."""
        for e in self.engines.values():
            if not e.sched.done:
                e.tick()
        if rebalance:
            self.maybe_rebalance()

    def run(self, requests: Optional[Sequence[Request]] = None, *,
            rebalance: bool = True) -> FleetResult:
        if requests:
            self.submit(requests)
        ticks0 = {i: e._tick for i, e in self.engines.items()}
        while not self.done:
            self.tick(rebalance=rebalance)
        return self.finish(ticks0)

    def finish(self, ticks0: Optional[Dict[int, int]] = None) -> FleetResult:
        ticks0 = ticks0 or {}
        per = dict(self._retired)
        per.update({i: e.finish(ticks0.get(i, 0))
                    for i, e in self.engines.items()})
        outputs: Dict[str, List[int]] = {}
        for r in per.values():
            outputs.update(r.outputs)
        return FleetResult(
            outputs=outputs, per_engine=per,
            migrations=self.n_migrations,
            prefix_hits=sum(r.prefix_hits for r in per.values()),
            emitted_tokens=sum(r.emitted_tokens for r in per.values()))

    # -- rebalancing ---------------------------------------------------------
    def maybe_rebalance(self) -> Optional[str]:
        """Move one running session from an engine with a backlog to an
        idle engine IF the cost model approves: the freed slot admits the
        backlog next tick, the moved session keeps decoding on the
        target.  Deterministic: first (src, dst) pair in id order, the
        most recently admitted running session (least sunk cost)."""
        for si, src in sorted(self.engines.items()):
            if not src.sched.pending or not src.sched.running:
                continue
            for di, dst in sorted(self.engines.items()):
                if di == si or dst.sched.pending \
                        or not dst.sched.free_slots():
                    continue
                rid = next(r for r in reversed(src.sched.admission_order)
                           if r in src.sched.running)
                depths = self.queue_depths()
                # dirty payload ~ the partial tail block + state
                nbytes = src.pager.token_nbytes * src.pager.block_tokens
                if self.policy.choose_migration(
                        rid, nbytes, depths[si] - depths[di]):
                    self.migrate(rid, si, di)
                    return rid
        return None

    # -- live migration ------------------------------------------------------
    def _point(self, point: str, rid: str, src: int, dst: int):
        self.migration_log.append((point, rid, src, dst))
        if self.mig_hook is not None:
            self.mig_hook(point, rid=rid, src=src, dst=dst)

    def migrate(self, rid: str, src_id: int, dst_id: int):
        """The four-phase live handoff (docstring up top).  Bit-identical
        token stream: the adopted cache bytes equal the frozen lane
        bytes, whichever arm (staging or pool) they travelled."""
        src, dst = self.engines[src_id], self.engines[dst_id]
        session, table, cache1 = src.begin_migration(rid)
        src.stage_migration(rid, cache1, self.staging.proxy(dst_id),
                            tag=src._tick)
        self._point("mig_stage", rid, src_id, dst_id)
        src.commit_handoff(rid, dst_id)
        self._point("mig_commit", rid, src_id, dst_id)
        cache = self._read_migrated_cache(dst, dst_id, table)
        dst.install_session(session, table, cache)
        dst._commit()                     # adoption commit: dst owns rid
        self._point("mig_adopt", rid, src_id, dst_id)
        src.release_migrated(rid)
        self._point("mig_release", rid, src_id, dst_id)
        self.n_migrations += 1

    def _read_migrated_cache(self, dst: ServeEngine, dst_id: int,
                             table: BlockTable):
        """Assemble a handed-off cache with staging-or-pool precedence:
        the RStored copy in the TARGET's buffer if it validates (the hot
        arm — no pool read), else the pool entry the block table carries.
        The handoff commit flushed exactly the staged bytes, so the arms
        are interchangeable — which is what the kill-cell equivalence
        asserts."""
        pager = dst.pager
        tpl = {ref.name: (pager.state_template if blk == STATE_BLOCK
                          else pager.block_template)
               for blk, ref in table.refs.items()}
        view = self.staging.view(dst_id, tpl)
        blocks: Dict[int, Any] = {}
        for blk, ref in table.refs.items():
            hit = view.staging.get(ref.name)
            if hit is not None:
                blocks[blk] = hit[1]
            else:
                if ref.entry is None:
                    raise RuntimeError(
                        f"block {ref.name} neither staged nor durable")
                blocks[blk] = dst.store.pool.read_entry(
                    ref.name, ref.entry, tpl[ref.name])
        return pager.assemble(blocks)

    # -- crash recovery ------------------------------------------------------
    def resume(self) -> Dict[int, Optional[int]]:
        """Every engine recovers its own newest manifest, then handoffs
        whose adoption never committed are completed: the source's
        recovered ``migrated_to`` tombstone carries the block table, the
        target adopts staging-or-pool and commits, the source's copy is
        dropped.  Idempotent — a tombstone whose target already owns the
        session (adoption committed before the crash) is just released."""
        steps = {i: e.resume() for i, e in self.engines.items()}
        for si, src in sorted(self.engines.items()):
            for rid, table in list(src._handoffs.items()):
                s = src.sessions.get(rid)
                if s is None or s.migrated_to is None:
                    src._handoffs.pop(rid, None)
                    continue
                di, dst = s.migrated_to, self.engines.get(s.migrated_to)
                if dst is None:
                    continue                  # target not in this fleet
                if rid not in dst.sessions and rid not in dst.results:
                    if table is None:
                        continue              # no table: nothing to adopt
                    cache = self._read_migrated_cache(dst, di, table)
                    dst.install_session(s, table, cache,
                                        claim_frames=True)
                    dst._commit()             # adoption commit
                    self._point("mig_adopt", rid, si, di)
                src.release_migrated(rid)
                src._handoffs.pop(rid, None)
                self._point("mig_release", rid, si, di)
        return steps

    def close(self):
        for e in self.engines.values():
            e.close()
