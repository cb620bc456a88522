"""Crash injection + recovery (partial-crash model, paper §3.1) — the port
of ``repro.dsm.recovery``.

A worker crash loses its HBM tier; the pool is uninterrupted.  Recovery
reads the **pool manifest**: the newest manifest whose every object
CRC-validates; torn objects fall back to the previous manifest.  The
reference's other source, a surviving peer's newer RStore-staged copy,
comes with peer staging (``repro.dsm.recovery``).

Reads go through ``DSMPool.read_entry`` (plain and sharded entries).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.dsm.pool import CorruptObjectError, DSMPool


class CrashError(Exception):
    """Raised by fault-injection code to simulate a worker loss."""


class ColdStartError(RuntimeError):
    """No recoverable state exists (no fully-valid manifest)."""


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

    def recover(self, templates: Dict[str, Any], *,
                exact: bool = True) -> Tuple[Dict[str, Any], int, str]:
        """The recovery path: the newest fully-valid manifest.  Returns
        ``(objects, step, "pool")``; raises ColdStartError when nothing is
        recoverable."""
        pool_state = self.recover_from_pool(templates, exact=exact)
        if pool_state is None:
            raise ColdStartError("no recoverable state (cold start)")
        objs, step, _ = pool_state
        return objs, step, "pool"
