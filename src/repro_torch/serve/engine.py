"""ServeEngine: continuous batching + HBM KV lanes + durable sessions — the
port of ``repro.serve.engine``.

The serving loop per decode tick (``tick()``; ``run()`` loops it):

1. **admit** — free slots refill FIFO from the scheduler; each admission
   prefills ONE sequence (B = 1; on the card its attention is the Hopper
   flash kernel, 16 launches per olmo-1b prefill), writes its cache into
   the slot lane and emits its first token — or, with prefix reuse on,
   restores the prompt's content-addressed pool blocks and skips the
   prefill entirely (a fresh prefill then publishes its blocks);
2. **decode** — one slot-masked batched decode step advances every running
   slot at its own position (``train.step.make_slot_decode_step``);
3. **retire** — sequences that hit their budget free their slot in the
   same tick; their block frames return to the allocator and their staged
   blocks leave the host tier;
4. **commit** (every ``commit_every`` ticks, durable pools only) — the
   PAGED layout: only the token blocks each session touched since the last
   commit are copied to the host, staged and flushed; the manifest carries
   every clean block by reference (serve.sessions), under the store's
   schedule (``sync`` / ``async`` / ``sharded`` / ``sharded-async``).
   ``paged=False`` keeps the legacy whole-lane layout: each running lane
   is copied on the card (``read_slot``), staged whole (``store.stage``)
   and flushed through the tiers' counted D2H copy at every commit.
   ``finish()`` commits the final table and drains the store, so the last
   async commit lands.

Crash recovery: a restarted server calls ``resume()`` — finished sessions
come back as results; running sessions re-enter the queue AHEAD of fresh
requests with their committed cache restored into a lane
(``restore_mode="cache"``) or replayed from the prompt
(``restore_mode="replay"``).  Both are bit-identical to the uninterrupted
run: the restored bytes ARE the committed lane bytes, and every step is
deterministic with fixed shapes.

Live migration (driven by ``serve.fleet``): ``begin_migration`` freezes a
session and frees its slot mid-flight, ``stage_migration`` RStores its
dirty blocks into the target's staging buffer, ``commit_handoff`` makes
the handoff durable, and the target's ``install_session`` re-admits it at
the FRONT of its queue — the token stream is bit-identical across the
handoff because the adopted cache bytes equal the frozen lane bytes.
``resume()`` keeps the table of each session this engine handed off
(``_handoffs``) for the fleet to finish an interrupted adoption.

``run_static`` is the static-batch baseline the benchmark compares
against: batched prefill (B = ``n_slots``), then decode until the LONGEST
sequence of the batch finishes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.dsm.api import CXL0Config
from repro_torch.serve.kvcache import TieredKVCache
from repro_torch.serve.paging import (BLOCK_TOKENS, BlockAllocator,
                                      BlockPager, BlockRef, BlockTable,
                                      STATE_BLOCK)
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.serve.sessions import Session, SessionStore
from repro_torch.train.step import make_serve_steps, make_slot_decode_step
from repro_torch.utils.tree import tree_leaves

#: the reference's refusal of an encoder-decoder architecture
DECODER_ONLY = ("the serving subsystem is decoder-only (the slot-masked "
                "decode has no encoder-state plumbing); encoder-decoder "
                "archs are not servable — see serve.engine.servable_archs")


@dataclasses.dataclass
class ServeResult:
    outputs: Dict[str, List[int]]     # rid -> emitted token ids
    decode_ticks: int
    prefills: int
    emitted_tokens: int
    mode: str
    resumed_step: Optional[int] = None
    resumed_sessions: int = 0
    commits: int = 0
    prefix_hits: int = 0              # admissions served from shared blocks
    migrated_in: int = 0
    migrated_out: int = 0


class ServeEngine:
    def __init__(self, bundle, params, *, n_slots: int = 4,
                 t_max: int = 96,
                 store: Optional[SessionStore] = None,
                 commit_every: int = 0,
                 restore_mode: str = "cache",
                 retire_done: bool = False,
                 paged: bool = True,
                 block_tokens: int = BLOCK_TOKENS,
                 allocator: Optional[BlockAllocator] = None,
                 prefix_reuse: bool = False,
                 prefix_key: str = ""):
        """``paged=False``: the legacy whole-lane commit layout (no pager,
        no prefix reuse).  ``allocator``: a frame allocator shared with
        other engines (a fleet's); by default the engine sizes its own."""
        if restore_mode not in ("cache", "replay"):
            raise ValueError(restore_mode)
        if bundle.cfg.is_encdec:
            raise ValueError(DECODER_ONLY)
        self.bundle = bundle
        self.params = params
        self.device = bundle.device
        self.n_slots = n_slots
        self.t_max = t_max
        self.store = store
        self.commit_every = commit_every if store is not None else 0
        self.restore_mode = restore_mode
        self.retire_done = retire_done
        self.paged = paged and store is not None
        #: reuse is sound only within one model identity: ``prefix_key``
        #: must name the weights (build_serve_engine sets it)
        self.prefix_reuse = prefix_reuse and self.paged
        self.prefix_key = prefix_key

        self._prefill, self._decode = make_serve_steps(bundle)
        self._slot_decode = make_slot_decode_step(bundle)
        self.kv = TieredKVCache(bundle, n_slots, t_max,
                                tiers=store.tiers if store else None,
                                placement=getattr(store, "placement", None))
        #: single-sequence prefill cache, zeroed before every prefill (the
        #: reference prefills into fresh zeros: positions past the prompt
        #: must be zero in the lane, and so in every committed block)
        self._caches1 = bundle.init_caches(1, t_max)
        self.sched = SlotScheduler(n_slots)
        self.sessions: Dict[str, Session] = {}
        self.results: Dict[str, List[int]] = {}
        self._resume_cache: Dict[str, Any] = {}
        #: recovered handoff tables of sessions this engine migrated OUT
        #: whose target may not have committed its adoption — the fleet
        #: resume completes these (``serve.fleet.FleetController.resume``)
        self._handoffs: Dict[str, Optional[BlockTable]] = {}
        if self.paged:
            self.pager = BlockPager(bundle, t_max, block_tokens)
            frames = n_slots * (self.pager.n_blocks(t_max) + 1) + 8
            self.allocator = allocator or BlockAllocator(max(64, 4 * frames))
            self.tables: Dict[str, BlockTable] = {}
        # host-side slot state
        self.pos = np.zeros(n_slots, np.int32)
        self.last_token = np.zeros(n_slots, np.int32)
        self.active = np.zeros(n_slots, bool)
        self._tick = 0
        self._resumed_step: Optional[int] = None
        self._n_resumed = 0
        self._n_prefills = 0
        self._n_commits = 0
        self._n_prefix_hits = 0
        self._n_migrated_in = 0
        self._n_migrated_out = 0

    # -- request intake ------------------------------------------------------
    def submit(self, requests: Sequence[Request]):
        fresh = []
        for r in requests:
            if len(r.prompt) + r.max_new_tokens > self.t_max:
                raise ValueError(f"{r.rid}: prompt {len(r.prompt)} + "
                                 f"budget {r.max_new_tokens} > t_max "
                                 f"{self.t_max}")
            if r.rid in self.sessions or r.rid in self.results:
                continue    # recovered, resuming, migrated or retired
            fresh.append(r)
        self.sched.submit(fresh)

    # -- crash recovery ------------------------------------------------------
    def resume(self) -> Optional[int]:
        """Recover the newest session commit from the pool.  Finished
        sessions become results; unfinished ones are queued AHEAD of any
        fresh request.  Sessions handed off to another engine stay as
        tombstones: ``submit`` skips them and the adopting engine (or the
        fleet resume) serves them.  Returns the recovered tick or None
        (cold pool)."""
        if self.store is None:
            return None
        rec = self.store.recover(self.pager if self.paged else None,
                                 self.kv.template1)
        if rec is None:
            return None
        for rid, s in rec.sessions.items():
            self.sessions[rid] = s
            if s.migrated_to is not None:
                # owned by the target engine; keep the handoff table so
                # the fleet resume can finish an interrupted adoption
                self._handoffs[rid] = rec.tables.get(rid)
                continue
            if s.done:
                self.results[rid] = list(s.emitted)
            else:
                self._resume_cache[rid] = rec.caches.get(rid)
                if self.paged and rid in rec.tables:
                    self.tables[rid] = rec.tables[rid]
                    for bid in rec.tables[rid].bids():
                        self.allocator.adopt(bid)
                self._n_resumed += 1
                self.sched.submit([Request(rid, s.prompt,
                                           s.max_new_tokens)])
        self._resumed_step = rec.step
        self._tick = rec.step + 1
        return rec.step

    # -- the continuous-batching loop ---------------------------------------
    def tick(self):
        """One scheduler round: admit, decode, commit-on-cadence."""
        for slot, req in self.sched.admit():
            self._admit(slot, req)
        if self.sched.n_running:
            self._decode_tick()
        self._tick += 1
        if self.commit_every and self._tick % self.commit_every == 0:
            self._commit()

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> ServeResult:
        if requests:
            self.submit(requests)
        ticks0 = self._tick
        while not self.sched.done:
            self.tick()
        return self.finish(ticks0)

    def finish(self, ticks0: int = 0) -> ServeResult:
        """Final commit + drain, then the result record."""
        if self.store is not None:
            self._commit()            # final table (all sessions done)
            self.store.drain()
        return ServeResult(
            outputs=dict(self.results),
            decode_ticks=self._tick - ticks0,
            prefills=self._n_prefills,
            emitted_tokens=sum(len(v) for v in self.results.values()),
            mode="continuous",
            resumed_step=self._resumed_step,
            resumed_sessions=self._n_resumed,
            commits=self._n_commits,
            prefix_hits=self._n_prefix_hits,
            migrated_in=self._n_migrated_in,
            migrated_out=self._n_migrated_out)

    def _admit(self, slot: int, req: Request):
        rid = req.rid
        s = self.sessions.get(rid)
        if s is not None and not s.done:
            cache1 = self._resume_cache.pop(rid, None)
            if (self.restore_mode == "cache" and cache1 is not None
                    and s.emitted):
                # fast-forward: committed cache bytes back into a lane
                self.kv.write_slot(slot, cache1)
                self.pos[slot] = s.pos
                self.last_token[slot] = s.emitted[-1]
                self.active[slot] = True
                return
            s.emitted = []            # replay: re-decode from the prompt
        else:
            s = Session(rid, tuple(req.prompt), req.max_new_tokens)
            self.sessions[rid] = s
            if self.prefix_reuse and self._admit_from_prefix(slot, s):
                return
        for leaf in tree_leaves(self._caches1):
            leaf.zero_()
        tokens = torch.tensor([s.prompt], dtype=torch.long,
                              device=self.device)
        logits, st = self._prefill(self.params, {"tokens": tokens},
                                   self._caches1)
        self._n_prefills += 1
        tok0 = int(torch.argmax(logits, -1)[0])
        self.kv.write_slot(slot, st.caches)
        self.pos[slot] = len(s.prompt)
        self.last_token[slot] = tok0
        self.active[slot] = True
        s.emitted.append(tok0)
        if self.prefix_reuse:
            self.store.publish_prefix(self.pager, self.prefix_key,
                                      s.prompt, st.caches, tok0)
        if len(s.emitted) >= s.max_new_tokens:
            self._finish(rid, slot)

    def _admit_from_prefix(self, slot: int, s: Session) -> bool:
        """Admission fast path: restore the prompt's shared blocks from the
        pool instead of prefilling.  Bit-identical to the prefill it
        replaces — the blocks were published from a prefill of the same
        prompt under the same weights (the same ``prefix_key``)."""
        hit = self.store.load_prefix(self.pager, self.prefix_key, s.prompt)
        if hit is None:
            return False
        blocks, shared, tok0 = hit
        self.kv.write_slot(slot, self.pager.assemble(blocks))
        table = BlockTable()
        for k, (name, entry) in shared.items():
            # the table references the SHARED objects: carried by name
            # into this engine's manifests, no bytes copied
            table.refs[k] = BlockRef(blk=k, bid=self.allocator.alloc(),
                                     tokens=self.pager.block_tokens,
                                     name=name, entry=entry)
        self.tables[s.rid] = table
        self.pos[slot] = len(s.prompt)
        self.last_token[slot] = tok0
        self.active[slot] = True
        s.emitted.append(tok0)
        self._n_prefix_hits += 1
        if len(s.emitted) >= s.max_new_tokens:
            self._finish(s.rid, slot)
        return True

    def _decode_tick(self):
        dev = self.device
        next_toks, _, _, new_pos = self._slot_decode(
            self.params,
            torch.from_numpy(self.last_token[:, None]).long().to(dev),
            self.kv.caches,
            torch.from_numpy(self.pos).to(dev),
            torch.from_numpy(self.active).to(dev))
        self.pos = new_pos.cpu().numpy().astype(np.int32)
        toks = next_toks.cpu().numpy()
        for rid, slot in list(self.sched.running.items()):
            s = self.sessions[rid]
            tok = int(toks[slot])
            s.emitted.append(tok)
            self.last_token[slot] = tok
            if len(s.emitted) >= s.max_new_tokens:
                self._finish(rid, slot)

    def _finish(self, rid: str, slot: int):
        self.sched.release(rid)
        self.active[slot] = False
        s = self.sessions[rid]
        s.done = True
        self.results[rid] = list(s.emitted)
        if self.store is not None:
            if self.paged:
                t = self.tables.pop(rid, None)
                if t is not None:
                    for bid in t.bids():
                        self.allocator.free(bid)
                self.store.discard_session_blocks(rid)
            else:
                self.store.discard(rid)

    def _stage_paged(self, rid: str, cache1: Any, proxy=None,
                     tag: Optional[int] = None):
        """Stage a running session's DIRTY blocks for the next commit, and
        RStore each into ``proxy``'s buffer when one is given (a
        migration's target)."""
        s = self.sessions[rid]
        table = self.tables.setdefault(rid, BlockTable())
        for blk, leaves in self.pager.slice_dirty(
                cache1, s.pos, table, self.store.tiers.to_host).items():
            ref = table.refs.get(blk)
            if ref is None:
                ref = BlockRef(blk=blk, bid=self.allocator.alloc(),
                               tokens=0,
                               name=self.store.block_name(rid, blk))
                table.refs[blk] = ref
            if blk != STATE_BLOCK:
                ref.tokens = self.pager.tokens_in_block(blk, s.pos)
            self.store.stage_block(s, ref, leaves)
            if proxy is not None:
                self.store.tiers.rstore(ref.name, proxy, tag=tag)

    def _commit(self):
        if self.paged:
            for rid, slot in self.sched.running.items():
                self._stage_paged(rid, self.kv.read_slot(slot))
            self.store.commit_paged(self.sessions, self.tables, self._tick,
                                    block_tokens=self.pager.block_tokens)
        else:
            for rid, slot in self.sched.running.items():
                self.store.stage(self.sessions[rid],
                                 self.kv.read_slot(slot))
            self.store.commit(self.sessions, self._tick)
        self._n_commits += 1
        if self.retire_done:
            # done sessions were durable in the table just committed;
            # retire them so commit cost stays O(live sessions)
            for rid in [r for r, s in self.sessions.items() if s.done]:
                del self.sessions[rid]

    # -- live migration mechanics (driven by serve.fleet) --------------------
    def begin_migration(self, rid: str):
        """Freeze an in-flight session: copy its lane and free the slot —
        freed by MIGRATION, not completion, so the scheduler refills it
        with the next pending request this very tick."""
        slot = self.sched.running[rid]
        cache1 = self.kv.read_slot(slot)
        self.active[slot] = False
        self.sched.release(rid)
        self._n_migrated_out += 1
        return (self.sessions[rid],
                self.tables.setdefault(rid, BlockTable()), cache1)

    def stage_migration(self, rid: str, cache1: Any, proxy, tag: int
                        ) -> BlockTable:
        """mig_stage: LStore the session's dirty blocks (the handoff commit
        flushes them — the pool arm) and RStore each into the TARGET's
        staging buffer (the hot arm).  Clean blocks move zero bytes: the
        target reads them from the pool entries the table carries."""
        self._stage_paged(rid, cache1, proxy, tag)
        return self.tables[rid]

    def commit_handoff(self, rid: str, target_id: int):
        """mig_commit: mark the session migrated and commit — ONE paged
        commit makes the marker, the block table and the staged dirty
        blocks durable atomically.  After this manifest lands the target
        owns the session, crash or no crash."""
        self.sessions[rid].migrated_to = target_id
        self._commit()

    def release_migrated(self, rid: str):
        """mig_release: the target's adoption commit landed — drop our
        copy.  Frame ids move WITH the table (one fleet allocator); staged
        payloads leave the host tier; the tombstone leaves the committed
        table at our next commit."""
        self.sessions.pop(rid, None)
        self.tables.pop(rid, None)
        self.store.discard_session_blocks(rid)

    def install_session(self, s: Session, table: BlockTable, cache1: Any,
                        *, claim_frames: bool = False):
        """Adopt a migrated-in session: queue it AHEAD of fresh requests
        with its cache ready to fast-forward into a lane.  ``claim_frames``
        re-asserts the table's frame ids in our allocator (restart
        recovery; a live handoff moves frames the shared fleet allocator
        already holds)."""
        s.migrated_to = None
        self.sessions[s.rid] = s
        self.tables[s.rid] = table
        if claim_frames:
            for bid in table.bids():
                self.allocator.adopt(bid)
        self._resume_cache[s.rid] = cache1
        self._n_migrated_in += 1
        self.sched.submit_front(Request(s.rid, s.prompt, s.max_new_tokens))

    # -- static baseline -----------------------------------------------------
    def run_static(self, requests: Sequence[Request]) -> ServeResult:
        """FIFO batches of ``n_slots``; each batch is prefilled at once and
        decodes until its LONGEST sequence finishes (the hostage effect
        continuous batching removes).  The batched decode routes the
        batch's MoE tokens under one capacity, as the reference's does."""
        outputs: Dict[str, List[int]] = {}
        ticks = prefills = 0
        reqs = list(requests)
        for i in range(0, len(reqs), self.n_slots):
            batch = reqs[i:i + self.n_slots]
            lens = {len(r.prompt) for r in batch}
            if len(lens) != 1:
                raise ValueError("the static baseline batches unpadded "
                                 f"prompts of one length, got {lens}")
            toks = torch.tensor([list(r.prompt) for r in batch],
                                dtype=torch.long, device=self.device)
            caches = self.bundle.init_caches(len(batch), self.t_max)
            logits, st = self._prefill(self.params, {"tokens": toks},
                                       caches)
            prefills += 1
            tok = torch.argmax(logits, -1)[:, None]
            emitted = [[t] for t in tok[:, 0].tolist()]
            for _ in range(max(r.max_new_tokens for r in batch) - 1):
                logits, st = self._decode(self.params, tok, st)
                tok = torch.argmax(logits, -1)[:, None]
                ticks += 1
                for row, t in enumerate(tok[:, 0].tolist()):
                    emitted[row].append(t)
            for r, row in zip(batch, emitted):
                outputs[r.rid] = row[:r.max_new_tokens]
        return ServeResult(
            outputs=outputs, decode_ticks=ticks, prefills=prefills,
            emitted_tokens=sum(len(v) for v in outputs.values()),
            mode="static")

    def close(self):
        if self.store is not None:
            self.store.close()


def servable_archs():
    """Arch ids the serving subsystem supports: the decoder-only ones (the
    launcher's argparse choices), as the reference filters them."""
    from repro_torch.configs import ARCH_IDS, ENCDEC_ARCHS
    return [a for a in ARCH_IDS if a not in ENCDEC_ARCHS]


def build_serve_engine(arch: str = "olmo-1b", *, smoke: bool = True,
                       n_slots: int = 4, t_max: int = 96,
                       pool_path: Optional[str] = None,
                       commit_every: int = 0, commit_mode: str = "sync",
                       n_shards: Optional[int] = None,
                       restore_mode: str = "cache",
                       retire_done: bool = False, seed: int = 0,
                       engine_id: int = 0, paged: bool = True,
                       block_tokens: int = BLOCK_TOKENS,
                       allocator: Optional[BlockAllocator] = None,
                       prefix_reuse: bool = False,
                       prefix_key: Optional[str] = None,
                       topology: Optional[str] = None,
                       dsm: Optional[CXL0Config] = None,
                       fault_hook=None, retention: int = 2,
                       bundle=None, params=None, device="cuda"):
    """Config -> bundle -> params -> optional durable session store ->
    engine.  Returns (engine, cfg).

    Params come from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, so two processes built with the same arguments on the same
    card hold bit-identical weights (they differ from the JAX package's
    ``jax.random`` weights).  Pass ``bundle`` + ``params`` to share one
    weight set across engines or to carry the reference's weights over
    (``models.params.from_reference``).  ``pool_path`` turns on durable
    sessions: a ``SessionStore`` of engine ``engine_id`` over that pool,
    committed under ``commit_mode`` (``n_shards`` flush pipelines for the
    sharded schedules; None sizes them at the first commit) every
    ``commit_every`` ticks, in the paged layout or, with ``paged=False``,
    the legacy whole-lane one.  ``topology`` (a ``dsm.emu`` preset) prices
    the shard count through its placement policy, and with
    ``commit_mode="auto"`` the schedule too; ``allocator`` shares one
    frame allocator across engines (the fleet's).

    The durable tier stack is wired from ONE ``CXL0Config``: pass it as
    ``dsm`` (the scenario worker does), or let ``pool_path`` /
    ``commit_mode`` / ``n_shards`` / ``retention`` / ``topology`` /
    ``fault_hook`` be folded into one here, as the reference does.
    ``fault_hook(point, step)`` fires inside each session commit's window
    (``dsm.flit_runtime.KILL_POINTS``); ``retention`` reaches the
    committer: the legacy layout's commits keep that many manifests, the
    paged layout's delegated completeOp runs no GC (as in the
    reference).

    ``prefix_key`` names the weights for prefix reuse.  Its default is
    the reference's key with ``|torch`` appended: the port's generated
    weights are not the reference's, so a pool the reference published
    must never hand its KV to a port engine.  An engine that carries the
    reference's weights passes the reference's key
    (``f"{arch}|{'smoke' if smoke else 'full'}|s{seed}"``), and its
    ``kvblk/`` / ``kvhead/`` objects are then the reference's."""
    from repro_torch.configs import (ENCDEC_ARCHS, get_config,
                                     get_smoke_config)
    from repro_torch.models.registry import build as build_model

    if arch in ENCDEC_ARCHS:
        raise ValueError(DECODER_ONLY)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if bundle is None:
        bundle = build_model(cfg, dec_pos_len=t_max, device=device)
    if params is None:
        params = bundle.init_params(
            torch.Generator(bundle.device).manual_seed(seed))
    store = None
    if dsm is None and pool_path is not None:
        dsm = CXL0Config(path=pool_path, schedule=commit_mode,
                         n_shards=n_shards, retention=retention,
                         topology=topology, fault_hook=fault_hook)
    if dsm is not None:
        store = SessionStore(ctx=dsm.open(), engine_id=engine_id)
    if prefix_key is None:
        prefix_key = f"{arch}|{'smoke' if smoke else 'full'}|s{seed}|torch"
    engine = ServeEngine(
        bundle, params, n_slots=n_slots, t_max=t_max, store=store,
        commit_every=commit_every, restore_mode=restore_mode,
        retire_done=retire_done, paged=paged, block_tokens=block_tokens,
        allocator=allocator, prefix_reuse=prefix_reuse,
        prefix_key=prefix_key)
    return engine, cfg
