"""Durable session store: serving state committed through the FliT path —
the port of ``repro.serve.sessions`` (paged layout).

One session commit at decode tick ``s`` is the paper's Alg. 2 over the
serving worker's live state with a DYNAMIC object set: one pool object per
token BLOCK, ``kv/<rid>/b<k>`` (serve.paging).  A commit flushes only the
blocks a session's position touched since the last commit; the manifest's
object dict is the union of those fresh flushes and the CARRIED entries of
every clean block (merged in a delegated completeOp), so any one manifest
describes every live cache completely.  The session table and the block
tables ride in the manifest meta — tokens, tables and block bytes become
durable in ONE atomic rename.  Manifests and meta are the reference's
documents, so either package recovers the other's pool, under every
schedule: under ``async`` / ``sharded-async`` the carried entries are
rebuilt before the commit call, the previous step's delegated completeOp
merges them with its own fresh entries, and ``absorb_written`` runs after
the call, in the reference's order.

Engines share a pool: engine ``i`` names its block objects under
``e<i>/`` (``engine_ns``; engine 0 unprefixed) and its manifests say
``"engine": i``, so a restarted server calls ``recover()`` and gets the
newest manifest of ITS engine whose every referenced object CRC-validates;
finished sessions come back as results, running ones as (tokens emitted,
restored cache).

Cross-engine prefix reuse: prompt-pure blocks are ALSO published as
content-addressed pool objects ``kvblk/<hash>`` + a ``kvhead/<hash>``
prefill head (serve.paging), written once via MStore; ``load_prefix``
restores them so a second engine serving the same prompt skips its
prefill.  A torn publish is invisible — the frames self-validate, and any
read failure degrades to a normal prefill.

Migration handoffs (``serve.fleet``): a session handed to another engine
carries ``migrated_to`` and keeps its committed block table in the
manifest (a tombstone); ``recover`` returns that table with the others so
a fleet restart can finish an interrupted adoption, and ``peek_engine``
reads a sibling engine's newest manifest.

Not ported yet: the legacy whole-lane layout (``stage`` / ``commit``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.pool import CorruptObjectError, DSMPool, manifest_entry
from repro_torch.serve.paging import (BlockPager, BlockRef, BlockTable,
                                      STATE_BLOCK, block_object_name,
                                      prefix_hash, shared_block_name,
                                      shared_head_name)

KV_PREFIX = "kv/"


def engine_ns(engine_id: int) -> str:
    """Per-engine object namespace in a shared pool.  Engine 0 writes
    unprefixed names, so single-engine pools look as they always did."""
    return f"e{engine_id}/" if engine_id else ""


@dataclasses.dataclass
class Session:
    """One admitted request's serving state."""
    rid: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    emitted: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cache_version: Optional[int] = None
    #: set by a migration handoff commit: this engine no longer owns the
    #: session, engine ``migrated_to`` does (``serve.fleet``)
    migrated_to: Optional[int] = None

    @property
    def pos(self) -> int:
        """Decode position the cache covers: the prompt plus every emitted
        token already FED BACK (the newest one is the next decode's input)."""
        return len(self.prompt) + len(self.emitted) - 1

    def to_meta(self) -> dict:
        d = {"prompt": list(self.prompt), "max_new": self.max_new_tokens,
             "emitted": list(self.emitted), "done": self.done,
             "cache_version": self.cache_version}
        if self.migrated_to is not None:
            d["migrated_to"] = self.migrated_to
        return d

    @classmethod
    def from_meta(cls, rid: str, d: dict) -> "Session":
        return cls(rid=rid, prompt=tuple(int(t) for t in d["prompt"]),
                   max_new_tokens=int(d["max_new"]),
                   emitted=[int(t) for t in d["emitted"]],
                   done=bool(d["done"]),
                   cache_version=d.get("cache_version"),
                   migrated_to=d.get("migrated_to"))


@dataclasses.dataclass
class RecoveredState:
    sessions: Dict[str, Session]     # full table (done + running)
    caches: Dict[str, Any]           # rid -> restored host cache (running)
    step: int                        # decode tick of the commit
    seq: int                         # manifest sequence
    tables: Dict[str, BlockTable] = dataclasses.field(default_factory=dict)


class SessionStore:
    def __init__(self, pool, *, mode: str = "sync",
                 n_shards: Optional[int] = None, engine_id: int = 0,
                 topology: Optional[str] = None):
        """``pool``: a pool directory or an open ``DSMPool``, committed
        through ``open_cxl0`` under ``mode`` (``n_shards`` pipelines for
        the sharded schedules; ``"auto"`` and the shard count priced by
        the placement policy of ``topology``).  The paged
        commit's delegated completeOp owns the manifests, so no retention
        GC runs and the store takes no ``retention`` (the reference's knob
        does nothing on this layout).  ``engine_id`` namespaces this
        store's objects and manifests in a shared pool."""
        self.ctx = open_cxl0(pool, schedule=mode, n_shards=n_shards,
                             topology=topology)
        self.pool: DSMPool = self.ctx.pool
        self.placement = self.ctx.placement
        self.engine_id = engine_id
        self.ns = engine_ns(engine_id)
        #: clean-block manifest entries carried into the next completeOp
        self._carried: Dict[str, dict] = {}
        #: entries of the most recent completeOp's fresh flushes
        self._last_written: Dict[str, dict] = {}

    @property
    def tiers(self):
        return self.ctx.tiers

    @property
    def committer(self):
        return self.ctx.committer

    def block_name(self, rid: str, blk: int) -> str:
        return block_object_name(rid, blk, self.ns)

    # -- paged commit side ---------------------------------------------------
    def stage_block(self, session: Session, ref: BlockRef, leaves):
        """LStore one dirty block payload; the next commit flushes it."""
        self.tiers.lstore(ref.name, leaves)
        ref.entry = None                      # durable entry now stale
        session.cache_version = self.tiers.versions[ref.name]

    def commit_paged(self, sessions: Dict[str, Session],
                     tables: Dict[str, BlockTable], step: int, *,
                     block_tokens: int):
        """Paged Alg. 2 commit: flush ONLY the staged dirty blocks, then one
        completeOp whose manifest carries the session + block tables in
        meta and the union of fresh + carried block entries."""
        if self.committer.complete_fn is None:
            self.committer.complete_fn = self._complete_paged
        meta = {"kind": "serve", "paged": True, "engine": self.engine_id,
                "block_tokens": block_tokens,
                "sessions": {rid: s.to_meta()
                             for rid, s in sessions.items()},
                "tables": {rid: t.to_meta() for rid, t in tables.items()}}
        self._carried = {}
        for t in tables.values():
            self._carried.update(t.entries())
        with self.ctx.commit(step, meta=meta) as txn:
            pass                # dirty blocks were staged via stage_block
        self.absorb_written(tables)
        return txn.stats

    def _complete_paged(self, step: int, written: Dict[str, Any],
                        meta: Optional[dict]) -> int:
        """Delegated completeOp: ONE manifest referencing the fresh
        flushes AND every carried clean block."""
        entries = {n: manifest_entry(o) for n, o in written.items()}
        merged = dict(self._carried)
        merged.update(entries)
        self._last_written = entries
        return self.pool.commit_manifest(step, merged, meta)

    def absorb_written(self, tables: Dict[str, BlockTable]):
        """Record freshly published entries into their block refs and drop
        the flushed payloads from the host tier — a clean block is carried
        by name from here on, never re-flushed."""
        if not self._last_written:
            return
        for t in tables.values():
            for ref in t.refs.values():
                e = self._last_written.get(ref.name)
                if e is not None:
                    ref.entry = e
                    if ref.blk != STATE_BLOCK \
                            and ref.name in self.tiers.hbm:
                        self.tiers.ldiscard(ref.name)
        self._last_written = {}

    def discard_session_blocks(self, rid: str):
        """Drop a finished or migrated session's staged blocks from the
        host tier (its carried entries leave with its table at the next
        commit)."""
        prefix = f"{self.ns}{KV_PREFIX}{rid}/"
        for name in [n for n in self.tiers.hbm if n.startswith(prefix)]:
            self.tiers.ldiscard(name)

    # -- cross-engine prefix reuse -------------------------------------------
    def publish_prefix(self, pager: BlockPager, key: str,
                       prompt: Tuple[int, ...], cache1: Any, tok0: int
                       ) -> int:
        """Publish the prompt-pure blocks of a freshly prefilled session as
        content-addressed shared objects (write-once: a block whose hash
        already exists in the pool is skipped).  The cache comes to the
        host through the tiers' counted copy.  Returns how many objects
        were newly written."""
        host = pager._host_leaves(cache1, self.tiers.to_host)
        wrote = 0
        for k, h in enumerate(pager.prompt_block_hashes(key, prompt)):
            name = shared_block_name(h)
            if self.pool.max_version(name) == 0:
                self.tiers.mstore(name, pager.slice_block(host, k))
                self.tiers.ldiscard(name)     # durable; keep out of commits
                wrote += 1
        hname = shared_head_name(
            prefix_hash(key, prompt, pager.block_tokens))
        if self.pool.max_version(hname) == 0:
            self.tiers.mstore(hname, pager.head_payload(host, len(prompt),
                                                        tok0))
            self.tiers.ldiscard(hname)
            wrote += 1
        return wrote

    def load_prefix(self, pager: BlockPager, key: str,
                    prompt: Tuple[int, ...]):
        """Restore a session's prefill state from shared prefix blocks:
        ``(blocks, shared_refs, tok0)`` on a full-prompt hit, else None
        (missing or torn objects: prefill normally)."""
        names = [shared_block_name(h)
                 for h in pager.prompt_block_hashes(key, prompt)]
        hname = shared_head_name(
            prefix_hash(key, prompt, pager.block_tokens))
        blocks: Dict[int, Any] = {}
        shared: Dict[int, Tuple[str, dict]] = {}
        try:
            for k, name in enumerate(names):
                v = self.pool.max_version(name)
                if v == 0:
                    return None
                blocks[k] = self.pool.read_object(name, v,
                                                  pager.block_template)
                shared[k] = (name, {"name": name, "version": v,
                                    "crc": None})
            v = self.pool.max_version(hname)
            if v == 0:
                return None
            head = self.pool.read_object(hname, v, pager.head_template)
        except (CorruptObjectError, OSError, ValueError):
            return None
        tail, state, tok0 = pager.split_head(head)
        if tail:
            blocks[len(names)] = tail
        if state:
            blocks[STATE_BLOCK] = state
        return blocks, shared, tok0

    def drain(self):
        return self.ctx.drain()

    def close(self):
        self.ctx.close()

    # -- recovery side -------------------------------------------------------
    def _manifests_for_engine(self) -> List[dict]:
        out = []
        for m in self.pool.manifests_desc():
            meta = m.get("meta") or {}
            if "sessions" not in meta:
                continue                      # not a serve commit
            if int(meta.get("engine", 0)) != self.engine_id:
                continue                      # a fleet sibling's commit
            out.append(m)
        return out

    def recover(self, pager: BlockPager) -> Optional[RecoveredState]:
        """Newest fully-valid paged session commit of THIS engine, or None
        on a cold pool.  Any torn or unreadable block fails the WHOLE
        manifest and recovery falls back to an older one."""
        for m in self._manifests_for_engine():
            meta = m.get("meta") or {}
            if not meta.get("paged"):
                raise NotImplementedError(
                    f"manifest {m['seq']} uses the legacy whole-lane "
                    f"layout, whose reader is not ported yet (reference: "
                    f"repro.serve.sessions.SessionStore._read_legacy)")
            got = self._read_paged(m, meta, pager)
            if got is None:
                continue                      # torn commit: older manifest
            sessions, caches, tables = got
            return RecoveredState(sessions, caches, m["step"], m["seq"],
                                  tables=tables)
        return None

    def _read_paged(self, m: dict, meta: dict, pager: BlockPager):
        sessions = {rid: Session.from_meta(rid, d)
                    for rid, d in meta["sessions"].items()}
        tables = {rid: BlockTable.from_meta(d)
                  for rid, d in (meta.get("tables") or {}).items()}
        # backfill the durable entries of blocks staged for this very
        # commit (their entry only exists post-completeOp)
        for t in tables.values():
            for ref in t.refs.values():
                e = m["objects"].get(ref.name)
                if e is not None:
                    ref.entry = e
        caches: Dict[str, Any] = {}
        for rid, s in sessions.items():
            if s.done or s.migrated_to is not None or rid not in tables:
                continue
            blocks: Dict[int, Any] = {}
            try:
                for blk, ref in tables[rid].refs.items():
                    entry = m["objects"].get(ref.name) or ref.entry
                    if entry is None:
                        return None
                    tpl = (pager.state_template if blk == STATE_BLOCK
                           else pager.block_template)
                    blocks[blk] = self.pool.read_entry(ref.name, entry, tpl)
            except (CorruptObjectError, KeyError, ValueError):
                return None
            caches[rid] = pager.assemble(blocks)
        return sessions, caches, tables

    def peek_engine(self, engine_id: int) -> Optional[dict]:
        """Newest serve manifest of a SIBLING engine (its meta carries the
        session and block tables)."""
        for m in self.pool.manifests_desc():
            meta = m.get("meta") or {}
            if "sessions" in meta and int(meta.get("engine", 0)) == engine_id:
                return m
        return None
