"""Crash injection + recovery (partial-crash model, paper §3.1) — the port
of ``repro.dsm.recovery``.

A worker crash loses its HBM and host-staging tiers; the pool and OTHER
workers are uninterrupted.  Recovery sources, best first:

1. **peer staging** — a surviving peer's RStore-staged copy NEWER than the
   pool's manifest, if it holds every requested object at one tag (the
   peer: anything with a ``.staging`` mapping of ``name -> (tag, host
   tree)``);
2. **pool manifest** — the newest manifest whose every object
   CRC-validates; torn objects fall back to the previous manifest.

Reads go through ``DSMPool.read_entry`` (plain and sharded entries).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.dsm.pool import CorruptObjectError, DSMPool


class CrashError(Exception):
    """Raised by fault-injection code to simulate a worker loss."""


class ColdStartError(RuntimeError):
    """No recoverable state exists anywhere (no fully-valid manifest, no
    consistent peer staging).  Resume paths catch THIS and nothing
    broader, so a real failure during recovery is never taken for a cold
    start."""


class RecoveryManager:
    def __init__(self, pool: DSMPool):
        self.pool = pool

    def recover_from_pool(self, templates: Dict[str, Any], *,
                          exact: bool = True
                          ) -> Optional[Tuple[Dict[str, Any], int, int]]:
        """Newest fully-valid manifest -> (objects, step, seq).  ``exact``:
        the manifest's object set must equal the template set; else it may
        hold more (subset recovery)."""
        for m in self.pool.manifests_desc():
            entries = m["objects"]
            if exact and set(entries) != set(templates):
                continue
            if not set(templates) <= set(entries):
                continue
            try:
                objs = {
                    name: self.pool.read_entry(name, entries[name],
                                               templates[name])
                    for name in templates}
            except (CorruptObjectError, KeyError, ValueError):
                continue            # torn commit or structure mismatch
            return objs, m["step"], m["seq"]
        return None

    def recover_latest(self, template_for: Callable[[str, dict], Any]
                       ) -> Optional[Tuple[Dict[str, Any], dict]]:
        """Newest fully-CRC-valid manifest for a DYNAMIC object set:
        ``template_for(name, entry)`` gives each object's prototype.
        Returns ``(objects, manifest)`` or None."""
        for m in self.pool.manifests_desc():
            try:
                objs = {
                    name: self.pool.read_entry(
                        name, entry, template_for(name, entry))
                    for name, entry in m["objects"].items()}
            except (CorruptObjectError, KeyError, ValueError):
                continue
            return objs, m
        return None

    def recover(self, templates: Dict[str, Any],
                peers: Tuple[Any, ...] = (), *,
                exact: bool = True) -> Tuple[Dict[str, Any], int, str]:
        """The recovery path: ``(objects, step, source)`` with source
        ``"peer-staging"`` when a peer's staged copy covers every template
        at one tag newer than the pool's newest valid manifest, else
        ``"pool"``.  Raises ColdStartError when neither exists."""
        pool_state = self.recover_from_pool(templates, exact=exact)
        best_peer: Optional[Dict[str, Any]] = None
        best_ver = -1
        for peer in peers:
            if not set(templates) <= set(peer.staging):
                continue
            staged = {n: peer.staging[n] for n in templates}
            vers = {v for v, _ in staged.values()}
            if len(vers) != 1:      # mixed-step staging: not consistent
                continue
            v = vers.pop()
            if v > best_ver:
                best_ver = v
                best_peer = {n: t for n, (_, t) in staged.items()}
        if pool_state is None and best_peer is None:
            raise ColdStartError("no recoverable state (cold start)")
        if best_peer is not None and (pool_state is None
                                      or best_ver > pool_state[1]):
            return best_peer, best_ver, "peer-staging"
        objs, step, _ = pool_state
        return objs, step, "pool"
