"""Adversarial crash fuzzer: seeded episodes of kills + torn writes +
stragglers against train / serve / cluster / scale workloads, checked
against ONE invariant — *recovery always lands on a completed commit,
bit-identical to a clean run replayed to that step*.  The port of
``repro.scenarios.fuzz``: the same draws, the same episodes, the same
results (``EpisodeResult.to_json()`` equal to the reference's for equal
(config, schedule)), over the port's DSM stack.

The ``scale`` workload is the cluster workload plus one planned
grow-by-repartition (``repro_torch.scale.grow``): a joiner rank enters the
live generation mid-run, and kills can land at any of the three join
windows (``JOIN_POINTS``) on any rank — joiner included.

Where the kill-point suites enumerate ~6 hand-picked cells at 3 fixed
commit-window points, an episode here draws a whole ``FaultSchedule``
(``repro_torch.dsm.faults``) from a seed: worker deaths at arbitrary primitive
boundaries (any lstore/rstore/rflush/mstore/completeOp call index),
torn durable writes (visible rename, wrong bytes) and seeded straggler
delays — then drives the real DSM stack (``open_cxl0`` + the fault-hook
plumbing) through crash / recover / resume until the workload finishes.

The checker is an independent oracle, NOT the recovery code itself:

* the expected recovery point is recomputed from the pool's manifest
  files and the ``FaultyPool`` corruption ledger (and, for the cluster,
  from the raw peer ``.staging`` contents) — manifests whose required
  entries were torn must be skipped, peer staging wins only when it
  covers the victim at one consistent strictly-newer tag;
* the expected recovered *bytes* come from a pure-numpy clean replay of
  the workload (no DSM involved), so "bit-identical to a clean run" is
  checked against something the system under test never touched.  The
  pool reads back host torch tensors; their bytes are CRC'd through
  ``utils.convert.raw_numpy`` under the same dtype token and shape, so
  a digest equals the reference's for equal bytes.

Every episode is a pure function of (config, schedule): no wall clock,
no unseeded randomness.  On a violation the suite greedily shrinks the
schedule (drop straggler → drop torn → drop each kill, keep whatever
still violates) and dumps a minimal-reproducer JSON that
``replay_reproducer`` re-runs to the same violation.

``REPRO_FUZZ_BREAK_RECOVERY=1`` deliberately breaks the recovery seam
(the recovered objects are swapped for a stale commit's while keeping
the claimed step) — the checker must then fail; tests and the CI canary
use this to prove the invariant has teeth.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import zlib

import numpy as np
import torch

from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.cluster import rank_ns, ring_sibling
from repro_torch.dsm.emu import PRESETS, TopologyEmulator, attach_emulator
from repro_torch.dsm.faults import (FaultInjector, FaultSchedule, FaultyPool,
                                    InjectedCrash, JOIN_POINTS, KillSpec,
                                    StragglerSpec, TornSpec, attach_faults,
                                    PRIMITIVES)
from repro_torch.dsm.flit_runtime import COMMIT_MODES, KILL_POINTS
from repro_torch.dsm.recovery import ColdStartError, RecoveryManager
from repro_torch.scale.grow import join_moves
from repro_torch.train.elastic import partition_plan
from repro_torch.utils.convert import raw_numpy

WORKLOADS = ("train", "serve", "cluster", "scale")
TOPOLOGIES = tuple(PRESETS)

#: setting this env var swaps recovered objects for a STALE commit's
#: (keeping the claimed step) at the recovery seam — the injected bug the
#: invariant checker must catch
BREAK_ENV = "REPRO_FUZZ_BREAK_RECOVERY"

#: incarnations per episode before declaring a livelock (kills are finite
#: and torn decisions are per-version, so convergence is guaranteed —
#: this guard only turns a checker bug into a violation, not a hang)
MAX_INCARNATIONS = 60


@dataclasses.dataclass
class EpisodeConfig:
    """One episode's workload shape.  Everything that affects behaviour is
    here or in the FaultSchedule — together they ARE the reproducer."""
    workload: str
    topology: str = "cxl11-direct"
    mode: str = "sync"              # commit schedule (cluster: always sync)
    steps: int = 12                 # train/cluster step count
    commit_every: int = 3
    n_tensors: int = 3              # train tensor count / cluster objects
    dim: int = 8
    n_shards: int = 2
    world: int = 3                  # cluster ranks
    replicate: bool = True          # cluster ring RStore replication
    requests: int = 5               # serve sessions
    arrival_every: int = 2          # serve ticks between arrivals
    decode_len: int = 4             # serve decode ticks per session
    grow_at: int = 0                # scale: step at which rank `world` joins
    emu_seed: int = 0

    @property
    def serve_ticks(self) -> int:
        return (self.requests - 1) * self.arrival_every + self.decode_len + 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EpisodeConfig":
        return cls(**d)


@dataclasses.dataclass
class EpisodeResult:
    workload: str
    topology: str
    ok: bool
    violations: List[str]
    kills_fired: List[dict]
    recoveries: List[dict]
    cold_restarts: int
    torn_writes: int
    config: dict
    schedule: dict

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _Events:
    """Per-episode accumulator the workload engines write into."""

    def __init__(self):
        self.violations: List[str] = []
        self.kills: List[dict] = []
        self.recoveries: List[dict] = []
        self.cold = 0
        self.torn = 0


# ---------------------------------------------------------------------------
# digests + the independent oracle
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A recovered leaf (a host torch tensor) or a numpy value as numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arr_crc(arr, d: int = 0) -> int:
    a, tok = raw_numpy(arr)
    d = zlib.crc32(str((tok, tuple(a.shape))).encode(), d)
    return zlib.crc32(a.tobytes(), d)


def _named_crc(named: Dict[str, Any], names: Sequence[str]) -> int:
    d = 0
    for n in sorted(names):
        d = zlib.crc32(n.encode(), d)
        d = _arr_crc(named[n], d)
    return d


def _entry_corrupt(entry: dict, corrupt: set) -> bool:
    """Does a manifest entry (plain or sharded) reference any payload the
    FaultyPool ledger says was torn?"""
    if entry.get("sharded"):
        return any((sh["name"], sh["version"]) in corrupt
                   for sh in entry["shards"])
    return (entry["name"], entry["version"]) in corrupt


def _oracle_pool_step(pool: FaultyPool, required: set, *,
                      exact: bool) -> Optional[int]:
    """The expected recovery step, recomputed from manifest FILES plus the
    corruption ledger — independent of RecoveryManager's read path."""
    corrupt = {(n, v) for n, v, _ in pool.injected}
    for m in pool.manifests_desc():
        entries = m["objects"]
        if exact and set(entries) != required:
            continue
        if not required <= set(entries):
            continue
        if any(_entry_corrupt(entries[n], corrupt) for n in required):
            continue
        return m["step"]
    return None


def _oracle_latest_step(pool: FaultyPool) -> Optional[int]:
    """Expected step for dynamic-set (recover_latest) recovery: newest
    manifest NONE of whose entries reference a torn payload."""
    corrupt = {(n, v) for n, v, _ in pool.injected}
    for m in pool.manifests_desc():
        if not any(_entry_corrupt(e, corrupt)
                   for e in m["objects"].values()):
            return m["step"]
    return None


# ---------------------------------------------------------------------------
# the breakable recovery seam
# ---------------------------------------------------------------------------

def _stale_pool_objs(pool, templates: Dict[str, Any], newer_than: int, *,
                     exact: bool) -> Optional[Dict[str, Any]]:
    """Objects of some VALID manifest strictly older than ``newer_than``
    (used only by the deliberate break: stale bytes under a fresh step)."""
    for m in pool.manifests_desc():
        if m["step"] >= newer_than:
            continue
        entries = m["objects"]
        if exact and set(entries) != set(templates):
            continue
        if not set(templates) <= set(entries):
            continue
        try:
            return {n: pool.read_entry(n, entries[n], templates[n])
                    for n in templates}
        except Exception:
            continue
    return None


def _recover_seam(recovery, pool, templates: Dict[str, Any], *,
                  peers: Sequence[Any] = (), exact: bool = True
                  ) -> Optional[Tuple[Dict[str, Any], int, str]]:
    """THE recovery invocation every workload goes through.  With
    ``REPRO_FUZZ_BREAK_RECOVERY`` set, the recovered objects are swapped
    for a stale commit's while the claimed step stays — the bug the
    invariant must catch."""
    try:
        objs, step, source = recovery.recover(templates, tuple(peers),
                                              exact=exact)
    except ColdStartError:
        return None
    if os.environ.get(BREAK_ENV):
        stale = _stale_pool_objs(pool, templates, step, exact=exact)
        if stale is not None:
            objs = stale
    return objs, step, source


def _recover_latest_seam(recovery, pool, template_for
                         ) -> Optional[Tuple[Dict[str, Any], dict]]:
    got = recovery.recover_latest(template_for)
    if got is None or not os.environ.get(BREAK_ENV):
        return got
    _, m = got
    for m2 in pool.manifests_desc():
        if m2["step"] >= m["step"]:
            continue
        try:
            objs2 = {n: pool.read_entry(n, e, template_for(n, e))
                     for n, e in m2["objects"].items()}
        except Exception:
            continue
        stale = dict(m2)
        stale["step"] = m["step"]      # stale state under the fresh step
        return objs2, stale
    return got


# ---------------------------------------------------------------------------
# clean-replay models (pure numpy — the DSM stack never touches these)
# ---------------------------------------------------------------------------

def _train_names(cfg: EpisodeConfig) -> List[str]:
    return [f"t{j}" for j in range(cfg.n_tensors)]


def _train_init(cfg: EpisodeConfig) -> Dict[str, np.ndarray]:
    return {f"t{j}": np.full((cfg.dim, cfg.dim), 0.05 * (j + 1), np.float32)
            for j in range(cfg.n_tensors)}


def _train_advance(state: Dict[str, np.ndarray], i: int
                   ) -> Dict[str, np.ndarray]:
    out = {}
    for n, v in state.items():
        out[n] = (v * np.float32(0.99)
                  + np.float32(np.mean(v)) * np.float32(0.01)
                  + np.float32(0.001) * np.float32(i + 1)).astype(np.float32)
    return out


def _train_clean_digests(cfg: EpisodeConfig) -> Dict[int, int]:
    names = _train_names(cfg)
    state = _train_init(cfg)
    digests = {-1: _named_crc(state, names)}
    for i in range(cfg.steps):
        state = _train_advance(state, i)
        digests[i] = _named_crc(state, names)
    return digests


def _cluster_names(cfg: EpisodeConfig) -> List[str]:
    return [f"t{k}" for k in range(cfg.n_tensors)]


def _cluster_step_val(v: np.ndarray, s: int) -> np.ndarray:
    return (v * np.float32(0.97) + np.float32(np.mean(v)) * np.float32(0.03)
            + np.float32(0.001) * np.float32(s + 1)).astype(np.float32)


def _cluster_values_at(cfg: EpisodeConfig, step: int
                       ) -> Dict[str, np.ndarray]:
    """Cluster tensor values after completing ``step`` (-1 = initial).
    Membership-independent by design: a shrink changes who OWNS a tensor,
    never its value — so the clean trajectory is one pure function."""
    vals = {f"t{k}": np.full((cfg.dim,), 0.1 * (k + 1), np.float32)
            for k in range(cfg.n_tensors)}
    for s in range(step + 1):
        vals = {n: _cluster_step_val(v, s) for n, v in vals.items()}
    return vals


def _serve_clean(cfg: EpisodeConfig
                 ) -> Tuple[Dict[int, int], Dict[str, List[int]]]:
    """Pure replay of the serve workload: per-tick digests of
    (session table, active KV caches) + the final per-session outputs."""
    table: Dict[str, dict] = {}
    kvs: Dict[str, np.ndarray] = {}
    digests: Dict[int, int] = {}
    for t in range(cfg.serve_ticks):
        _serve_sim_step(cfg, table, kvs, t)
        digests[t] = _serve_digest(table, kvs)
    return digests, {r: rec["outputs"] for r, rec in table.items()}


def _serve_sim_step(cfg: EpisodeConfig, table: Dict[str, dict],
                    kvs: Dict[str, np.ndarray], t: int) -> List[str]:
    """Advance the serve state ONE tick in place; returns the session ids
    that finished this tick.  str keys throughout — the table travels via
    manifest meta (JSON), and int keys would not round-trip."""
    for r in range(cfg.requests):
        if r * cfg.arrival_every == t:
            rid = str(r)
            table[rid] = {"outputs": [], "done": False, "arrived": t}
            kvs[rid] = np.full((cfg.dim,), 0.01 * (r + 1), np.float32)
    finished: List[str] = []
    for rid in sorted(kvs, key=int):
        kv = (kvs[rid] * np.float32(0.98)
              + np.float32(0.002) * np.float32(t + 1)).astype(np.float32)
        kvs[rid] = kv
        tok = int(float(np.abs(kv).sum(dtype=np.float32)) * 1000.0) % 9973
        table[rid]["outputs"].append(tok)
        if len(table[rid]["outputs"]) >= cfg.decode_len:
            table[rid]["done"] = True
            del kvs[rid]
            finished.append(rid)
    return finished


def _serve_digest(table: Dict[str, dict], kvs: Dict[str, np.ndarray]) -> int:
    d = zlib.crc32(json.dumps(table, sort_keys=True).encode())
    for rid in sorted(kvs, key=int):
        d = zlib.crc32(rid.encode(), d)
        d = _arr_crc(kvs[rid], d)
    return d


# ---------------------------------------------------------------------------
# workload engines
# ---------------------------------------------------------------------------

def _reincarnate(ctx, open_ctx: Callable):
    """Kill this incarnation (volatile tiers vanish, in-flight flushes are
    joined-and-discarded) and start the next one."""
    ctx.crash()
    ctx.close()
    return open_ctx()


def _train_objects(cfg, state: Dict[str, np.ndarray], i: int
                   ) -> Dict[str, Any]:
    return {**state, "meta": {"step": np.int64(i)}}


def _train_templates(cfg) -> Dict[str, Any]:
    return {**{n: np.zeros((cfg.dim, cfg.dim), np.float32)
               for n in _train_names(cfg)},
            "meta": {"step": np.zeros((), np.int64)}}


def _check_train_recovery(cfg, pool, ctx, ev, digests, *, final=False):
    """One recovery + the full invariant: lands exactly on the oracle's
    newest un-torn completed commit, bit-identical to the clean replay.
    Returns (state, resume_step) or None (expected cold start)."""
    tag = "final recovery" if final else "recovery"
    templates = _train_templates(cfg)
    expected = _oracle_pool_step(pool, set(templates), exact=True)
    got = _recover_seam(ctx.recovery, pool, templates, exact=True)
    if expected is None:
        if got is not None:
            ev.violations.append(
                f"{tag}: recovered step {got[1]} but every completed commit "
                "references torn payloads")
        return None
    if got is None:
        ev.violations.append(
            f"{tag}: cold start despite a completed commit at step "
            f"{expected}")
        return None
    objs, step, source = got
    ev.recoveries.append({"step": step, "source": source,
                          "expected": expected, "final": final})
    if step != expected:
        ev.violations.append(
            f"{tag}: landed on step {step}; newest completed un-torn commit "
            f"is step {expected}")
        return None
    if _named_crc(objs, _train_names(cfg)) != digests[expected]:
        ev.violations.append(
            f"{tag}: state at step {step} is not bit-identical to the clean "
            "run replayed to that step")
        return None
    if int(_host(objs["meta"]["step"])) != expected:
        ev.violations.append(
            f"{tag}: committed meta.step != manifest step {expected}")
        return None
    state = {n: _host(objs[n]) for n in _train_names(cfg)}
    return state, step + 1


def _run_train(cfg: EpisodeConfig, sched: FaultSchedule,
               pool_dir: str) -> _Events:
    ev = _Events()
    digests = _train_clean_digests(cfg)
    pool = FaultyPool(pool_dir, torn=sched.torn)
    inj = FaultInjector(sched, worker=0)

    def open_ctx():
        ctx = open_cxl0(pool, worker_id=0, schedule=cfg.mode,
                        n_shards=cfg.n_shards, fault_hook=inj.window)
        attach_emulator(ctx.tiers, TopologyEmulator(
            cfg.topology, seed=cfg.emu_seed, fault_model=sched.straggler))
        return attach_faults(ctx, inj)

    ctx = open_ctx()
    state = _train_init(cfg)
    i, initialized = 0, False
    for _ in range(MAX_INCARNATIONS):
        try:
            if not initialized:
                ctx.put(_train_objects(cfg, state, -1), step=-1)
                with ctx.commit(-1):
                    pass
                ctx.drain()
                initialized = True
            while i < cfg.steps:
                state = _train_advance(state, i)
                ctx.put(_train_objects(cfg, state, i), step=i)
                if (i + 1) % cfg.commit_every == 0:
                    with ctx.commit(i):
                        pass
                i += 1
            ctx.drain()
            break
        except InjectedCrash as e:
            ev.kills.append({"worker": e.worker, "op": e.op,
                             "index": e.index, "phase": e.phase})
            ctx = _reincarnate(ctx, open_ctx)
            rec = _check_train_recovery(cfg, pool, ctx, ev, digests)
            if rec is None:
                state, i, initialized = _train_init(cfg), 0, False
                ev.cold += 1
            else:
                state, i = rec
                initialized = True
    else:
        ev.violations.append("episode did not converge (livelock guard)")
    # the forced last word: crash the finished worker and require recovery
    # to land on the newest completed commit one more time
    ctx = _reincarnate(ctx, open_ctx)
    _check_train_recovery(cfg, pool, ctx, ev, digests, final=True)
    if _named_crc(state, _train_names(cfg)) != digests[cfg.steps - 1]:
        ev.violations.append(
            "final in-memory state diverged from the clean run")
    ctx.close()
    ev.torn = len(pool.injected)
    return ev


def _check_serve_recovery(cfg, pool, ctx, ev, digests, *, final=False):
    tag = "final recovery" if final else "recovery"
    expected = _oracle_latest_step(pool)
    kv_tpl = np.zeros((cfg.dim,), np.float32)
    got = _recover_latest_seam(ctx.recovery, pool, lambda name, entry: kv_tpl)
    if expected is None:
        if got is not None:
            ev.violations.append(
                f"{tag}: recovered tick {got[1]['step']} but every "
                "completed commit references torn payloads")
        return None
    if got is None:
        ev.violations.append(
            f"{tag}: cold start despite a completed commit at tick "
            f"{expected}")
        return None
    objs, m = got
    step = m["step"]
    ev.recoveries.append({"step": step, "source": "pool",
                          "expected": expected, "final": final})
    if step != expected:
        ev.violations.append(
            f"{tag}: landed on tick {step}; newest completed un-torn commit "
            f"is tick {expected}")
        return None
    if int(m["meta"].get("tick", -2)) != expected:
        ev.violations.append(
            f"{tag}: committed meta.tick != manifest tick {expected}")
        return None
    table = m["meta"]["table"]
    kvs = {name.split("/", 1)[1]: _host(v) for name, v in objs.items()}
    if _serve_digest(table, kvs) != digests[expected]:
        ev.violations.append(
            f"{tag}: state at tick {step} is not bit-identical to the clean "
            "run replayed to that tick")
        return None
    return table, kvs, step + 1


def _run_serve(cfg: EpisodeConfig, sched: FaultSchedule,
               pool_dir: str) -> _Events:
    ev = _Events()
    digests, clean_outputs = _serve_clean(cfg)
    pool = FaultyPool(pool_dir, torn=sched.torn)
    inj = FaultInjector(sched, worker=0)

    def open_ctx():
        ctx = open_cxl0(pool, worker_id=0, schedule=cfg.mode,
                        n_shards=cfg.n_shards, fault_hook=inj.window)
        attach_emulator(ctx.tiers, TopologyEmulator(
            cfg.topology, seed=cfg.emu_seed, fault_model=sched.straggler))
        return attach_faults(ctx, inj)

    ctx = open_ctx()
    table: Dict[str, dict] = {}
    kvs: Dict[str, np.ndarray] = {}
    t = 0
    for _ in range(MAX_INCARNATIONS):
        try:
            while t < cfg.serve_ticks:
                finished = _serve_sim_step(cfg, table, kvs, t)
                ctx.put({f"kv/{rid}": kvs[rid]
                         for rid in sorted(kvs, key=int)}, step=t)
                for rid in finished:
                    ctx.tiers.ldiscard(f"kv/{rid}")
                if (t + 1) % cfg.commit_every == 0 or t == cfg.serve_ticks - 1:
                    with ctx.commit(t, meta={"tick": t, "table":
                                             json.loads(json.dumps(table))}):
                        pass
                t += 1
            ctx.drain()
            break
        except InjectedCrash as e:
            ev.kills.append({"worker": e.worker, "op": e.op,
                             "index": e.index, "phase": e.phase})
            ctx = _reincarnate(ctx, open_ctx)
            rec = _check_serve_recovery(cfg, pool, ctx, ev, digests)
            if rec is None:
                table, kvs, t = {}, {}, 0
                ev.cold += 1
            else:
                table, kvs, t = rec
                table = json.loads(json.dumps(table))
    else:
        ev.violations.append("episode did not converge (livelock guard)")
    ctx = _reincarnate(ctx, open_ctx)
    _check_serve_recovery(cfg, pool, ctx, ev, digests, final=True)
    outputs = {r: rec["outputs"] for r, rec in table.items()}
    if outputs != clean_outputs:
        ev.violations.append(
            "final served outputs diverged from the clean run")
    ctx.close()
    ev.torn = len(pool.injected)
    return ev


def _cluster_commit(cfg, pool, ctxs, injs, live, plan, vals, step):
    """The cluster's commit protocol for one step: every rank flushes its
    owned partitions (pre/mid-flush windows fire per rank), the leader —
    lowest live rank — performs the single elected completeOp, then every
    rank passes its post-completeOp window."""
    written: Dict[str, Any] = {}
    leader = min(live)
    for r in sorted(live):
        injs[r].window("pre_flush", step)
        first = True
        for n in sorted(k for k in vals if plan[k] == r):
            nsname = rank_ns(r, n)
            ctxs[r].tiers.lstore(nsname, vals[n])
            written[nsname] = ctxs[r].tiers.rflush(nsname)
            if first:
                injs[r].window("mid_flush", step)
                first = False
    injs[leader].call("completeOp", f"manifest@{step}",
                      pool.commit_manifest, step, written,
                      {"live": sorted(live)})
    for r in sorted(live):
        injs[r].window("post_completeOp", step)


def _cluster_recover(cfg, pool, ctxs, ev, live, old_plan, victim):
    """Recover the victim's partition through the real seam and check it
    against the oracle: expected source/step recomputed from raw peer
    staging + manifest files + the corruption ledger; expected bytes from
    the pure clean replay.  Returns the roll-back step, or None for an
    (expected) cold start."""
    vnames = sorted(n for n in old_plan if old_plan[n] == victim)
    templates = {rank_ns(victim, n): np.zeros((cfg.dim,), np.float32)
                 for n in vnames}
    pool_step = _oracle_pool_step(pool, set(templates), exact=False)
    peer_tag = None
    for p in sorted(live):
        tags = {(ctxs[p].tiers.staging.get(rank_ns(victim, n)) or
                 (None,))[0] for n in vnames}
        if None not in tags and len(tags) == 1:
            t = tags.pop()
            peer_tag = t if peer_tag is None else max(peer_tag, t)
    if peer_tag is not None and (pool_step is None or peer_tag > pool_step):
        expected, exp_src = peer_tag, "peer-staging"
    elif pool_step is not None:
        expected, exp_src = pool_step, "pool"
    else:
        expected, exp_src = None, None
    got = _recover_seam(RecoveryManager(pool), pool, templates,
                        peers=[ctxs[p].tiers for p in sorted(live)],
                        exact=False)
    if expected is None:
        if got is not None:
            ev.violations.append(
                f"cluster recovery: recovered step {got[1]} for w{victim} "
                "but nothing recoverable exists")
        return None
    if got is None:
        ev.violations.append(
            f"cluster recovery: cold start for w{victim} despite "
            f"recoverable state at step {expected} ({exp_src})")
        return None
    objs, step, source = got
    ev.recoveries.append({"victim": victim, "step": step, "source": source,
                          "expected": expected, "expected_source": exp_src})
    if (step, source) != (expected, exp_src):
        ev.violations.append(
            f"cluster recovery landed on ({step}, {source}); oracle says "
            f"({expected}, {exp_src})")
        return None
    want = _cluster_values_at(cfg, expected)
    for n in vnames:
        if _arr_crc(objs[rank_ns(victim, n)]) != _arr_crc(want[n]):
            ev.violations.append(
                f"cluster recovery: {n}@{expected} is not bit-identical to "
                "the clean run replayed to that step")
            return None
    return expected


def _run_cluster(cfg: EpisodeConfig, sched: FaultSchedule,
                 pool_dir: str) -> _Events:
    ev = _Events()
    names = _cluster_names(cfg)
    pool = FaultyPool(pool_dir, torn=sched.torn)
    injs = {r: FaultInjector(sched, worker=r) for r in range(cfg.world)}
    live = sorted(injs)
    ctxs: Dict[int, Any] = {}

    def open_rank(r):
        ctx = open_cxl0(pool, worker_id=r, schedule="sync",
                        fault_hook=injs[r].window)
        attach_emulator(ctx.tiers, TopologyEmulator(
            cfg.topology, seed=cfg.emu_seed + r,
            fault_model=sched.straggler))
        return attach_faults(ctx, injs[r], wrap_pool=False)

    for r in live:
        ctxs[r] = open_rank(r)
    plan = partition_plan(names, live)
    s = 0
    pending_commit: Optional[int] = -1      # the initial / re-mesh commit
    for _ in range(MAX_INCARNATIONS):
        try:
            if pending_commit is not None:
                _cluster_commit(cfg, pool, ctxs, injs, live, plan,
                                _cluster_values_at(cfg, pending_commit),
                                pending_commit)
                pending_commit = None
            while s < cfg.steps:
                vals = _cluster_values_at(cfg, s)
                for r in sorted(live):
                    sib = (ring_sibling(r, live)
                           if cfg.replicate and len(live) > 1 else None)
                    for n in sorted(k for k in names if plan[k] == r):
                        nsname = rank_ns(r, n)
                        ctxs[r].tiers.lstore(nsname, vals[n])
                        if sib is not None:
                            ctxs[r].tiers.rstore(nsname, ctxs[sib].tiers,
                                                 tag=s)
                if (s + 1) % cfg.commit_every == 0 or s == cfg.steps - 1:
                    _cluster_commit(cfg, pool, ctxs, injs, live, plan,
                                    vals, s)
                s += 1
            break
        except InjectedCrash as e:
            ev.kills.append({"worker": e.worker, "op": e.op,
                             "index": e.index, "phase": e.phase})
            victim = e.worker
            live.remove(victim)
            ctxs[victim].crash()
            ctxs[victim].close()
            ctxs.pop(victim)
            if not live:
                ev.violations.append("every worker dead — episode undefined")
                break
            old_plan = plan
            roll = _cluster_recover(cfg, pool, ctxs, ev, live, old_plan,
                                    victim)
            plan = partition_plan(names, live)
            if roll is None:
                # nothing recoverable for the victim's partition: the whole
                # (shrunk) cluster cold-restarts — every survivor's stale
                # staging is wiped with it
                for r in live:
                    ctxs[r].crash()
                    ctxs[r].close()
                    ctxs[r] = open_rank(r)
                s, pending_commit = 0, -1
                ev.cold += 1
            else:
                # survivors re-mesh at the recovered step: the adopted
                # partition re-enters under its NEW owner's namespace via a
                # GPF commit at the roll-back step
                s, pending_commit = roll + 1, roll
    else:
        ev.violations.append("episode did not converge (livelock guard)")
    # the forced last word: wipe EVERY survivor (staging included) — the
    # full cluster state must come back from the pool alone
    for r in sorted(live):
        ctxs[r].crash()
        ctxs[r].close()
        ctxs[r] = open_rank(r)
    templates = {rank_ns(plan[n], n): np.zeros((cfg.dim,), np.float32)
                 for n in names}
    expected = _oracle_pool_step(pool, set(templates), exact=False)
    got = _recover_seam(RecoveryManager(pool), pool, templates, exact=False)
    if expected is None:
        if got is not None:
            ev.violations.append(
                f"final recovery: recovered step {got[1]} but every "
                "completed commit references torn payloads")
    elif got is None:
        ev.violations.append(
            f"final recovery: cold start despite a completed commit at "
            f"step {expected}")
    else:
        objs, step, _source = got
        ev.recoveries.append({"step": step, "source": _source,
                              "expected": expected, "final": True})
        if step != expected:
            ev.violations.append(
                f"final recovery landed on step {step}; newest completed "
                f"un-torn commit is step {expected}")
        else:
            want = _cluster_values_at(cfg, expected)
            for n in names:
                if _arr_crc(objs[rank_ns(plan[n], n)]) != _arr_crc(want[n]):
                    ev.violations.append(
                        f"final recovery: {n}@{expected} is not "
                        "bit-identical to the clean run")
                    break
    for r in sorted(live):
        ctxs[r].close()
    ev.torn = len(pool.injected)
    return ev


def _scale_join(cfg, pool, ctxs, injs, live, open_rank, s):
    """The three-phase grow-by-repartition (see ``scale.grow``) in
    fuzz form — stage, commit, adopt — with a JOIN_POINTS window at every
    phase boundary.  Mutates ``live``/``ctxs`` in place; the caller's
    crash handling covers every interleaving: before the adoption commit
    the joiner owns nothing (a death anywhere just abandons the grow),
    after it the joiner is ordinary membership."""
    names = _cluster_names(cfg)
    joiner = cfg.world
    q = s - 1
    old_plan = partition_plan(names, sorted(live))
    new_plan = partition_plan(names, sorted(live) + [joiner])
    moves = join_moves(old_plan, new_plan, joiner)
    vals_q = _cluster_values_at(cfg, q)
    ctxs[joiner] = open_rank(joiner)
    # staged: each old rank RStores the entries the new partition re-homes
    # to the joiner into the joiner's volatile staging buffer at tag q
    for r in sorted(live):
        for n in sorted(k for k, src in moves.items() if src == r):
            ctxs[r].tiers.rstore(rank_ns(r, n), ctxs[joiner].tiers, tag=q)
        injs[r].window("join_staged", q)
    injs[joiner].window("join_staged", q)
    # committed: the OLD membership elects one more manifest at q — until
    # this lands, the grow simply never happened
    _cluster_commit(cfg, pool, ctxs, injs, live, old_plan, vals_q, q)
    for r in sorted(live):
        injs[r].window("join_committed", q)
    injs[joiner].window("join_committed", q)
    # adopted: the joiner installs its partition and the NEW membership
    # elects its re-meshed base manifest at q
    live.append(joiner)
    live.sort()
    for n in sorted(moves):
        ctxs[joiner].tiers.lstore(rank_ns(joiner, n), vals_q[n])
    _cluster_commit(cfg, pool, ctxs, injs, live, new_plan, vals_q, q)
    for r in sorted(live):
        injs[r].window("join_adopted", q)


def _run_scale(cfg: EpisodeConfig, sched: FaultSchedule,
               pool_dir: str) -> _Events:
    """The cluster workload plus ONE planned grow at ``cfg.grow_at``: rank
    ``world`` joins the live generation mid-run through the three-phase
    protocol.  The invariant is unchanged — the clean trajectory is
    membership-independent (``_cluster_values_at``), so recovery from a
    kill at ANY join window must land on a completed commit bit-identical
    to the clean replay, under whichever membership that commit carries
    (pre-manifest: the grow never happened; post-manifest: the joiner's
    partition is derivable from the pool alone)."""
    ev = _Events()
    names = _cluster_names(cfg)
    pool = FaultyPool(pool_dir, torn=sched.torn)
    joiner = cfg.world
    injs = {r: FaultInjector(sched, worker=r)
            for r in range(cfg.world + 1)}
    live = sorted(range(cfg.world))
    ctxs: Dict[int, Any] = {}

    def open_rank(r):
        ctx = open_cxl0(pool, worker_id=r, schedule="sync",
                        fault_hook=injs[r].window)
        attach_emulator(ctx.tiers, TopologyEmulator(
            cfg.topology, seed=cfg.emu_seed + r,
            fault_model=sched.straggler))
        return attach_faults(ctx, injs[r], wrap_pool=False)

    for r in live:
        ctxs[r] = open_rank(r)
    s = 0
    grown = False
    pending_commit: Optional[int] = -1      # the initial / re-mesh commit
    for _ in range(MAX_INCARNATIONS):
        try:
            if pending_commit is not None:
                _cluster_commit(cfg, pool, ctxs, injs, live,
                                partition_plan(names, live),
                                _cluster_values_at(cfg, pending_commit),
                                pending_commit)
                pending_commit = None
            while s < cfg.steps:
                if not grown and s == cfg.grow_at:
                    grown = True        # at-most-once, like the live protocol
                    _scale_join(cfg, pool, ctxs, injs, live, open_rank, s)
                plan = partition_plan(names, live)
                vals = _cluster_values_at(cfg, s)
                for r in sorted(live):
                    sib = (ring_sibling(r, live)
                           if cfg.replicate and len(live) > 1 else None)
                    for n in sorted(k for k in names if plan[k] == r):
                        nsname = rank_ns(r, n)
                        ctxs[r].tiers.lstore(nsname, vals[n])
                        if sib is not None:
                            ctxs[r].tiers.rstore(nsname, ctxs[sib].tiers,
                                                 tag=s)
                if (s + 1) % cfg.commit_every == 0 or s == cfg.steps - 1:
                    _cluster_commit(cfg, pool, ctxs, injs, live, plan,
                                    vals, s)
                s += 1
            break
        except InjectedCrash as e:
            ev.kills.append({"worker": e.worker, "op": e.op,
                             "index": e.index, "phase": e.phase})
            victim = e.worker
            # a joiner that never adopted owns nothing: drop it and
            # abandon the half-done grow, whoever the victim was
            if joiner in ctxs and joiner not in live:
                ctxs[joiner].crash()
                ctxs[joiner].close()
                ctxs.pop(joiner)
                if victim == joiner:
                    continue
            old_plan = partition_plan(names, live)
            live.remove(victim)
            ctxs[victim].crash()
            ctxs[victim].close()
            ctxs.pop(victim)
            if not live:
                ev.violations.append("every worker dead — episode undefined")
                break
            roll = _cluster_recover(cfg, pool, ctxs, ev, live, old_plan,
                                    victim)
            if roll is None:
                for r in live:
                    ctxs[r].crash()
                    ctxs[r].close()
                    ctxs[r] = open_rank(r)
                s, pending_commit = 0, -1
                ev.cold += 1
            else:
                s, pending_commit = roll + 1, roll
    else:
        ev.violations.append("episode did not converge (livelock guard)")
    # the forced last word: wipe EVERY survivor (staging included) — the
    # final membership's full state must come back from the pool alone
    for r in sorted(live):
        ctxs[r].crash()
        ctxs[r].close()
        ctxs[r] = open_rank(r)
    if live:
        plan = partition_plan(names, live)
        templates = {rank_ns(plan[n], n): np.zeros((cfg.dim,), np.float32)
                     for n in names}
        expected = _oracle_pool_step(pool, set(templates), exact=False)
        got = _recover_seam(RecoveryManager(pool), pool, templates,
                            exact=False)
        if expected is None:
            if got is not None:
                ev.violations.append(
                    f"final recovery: recovered step {got[1]} but every "
                    "completed commit references torn payloads")
        elif got is None:
            ev.violations.append(
                f"final recovery: cold start despite a completed commit at "
                f"step {expected}")
        else:
            objs, step, _source = got
            ev.recoveries.append({"step": step, "source": _source,
                                  "expected": expected, "final": True})
            if step != expected:
                ev.violations.append(
                    f"final recovery landed on step {step}; newest completed "
                    f"un-torn commit is step {expected}")
            else:
                want = _cluster_values_at(cfg, expected)
                for n in names:
                    if _arr_crc(objs[rank_ns(plan[n], n)]) != \
                            _arr_crc(want[n]):
                        ev.violations.append(
                            f"final recovery: {n}@{expected} is not "
                            "bit-identical to the clean run")
                        break
    for r in sorted(live):
        ctxs[r].close()
    ev.torn = len(pool.injected)
    return ev


_ENGINES = {"train": _run_train, "serve": _run_serve,
            "cluster": _run_cluster, "scale": _run_scale}


def run_episode(cfg: EpisodeConfig, sched: FaultSchedule,
                workdir: str) -> EpisodeResult:
    """One episode in a fresh pool under ``workdir``.  Engine exceptions
    are violations too — a fault schedule must never be able to crash the
    HARNESS, only the workers inside it."""
    os.makedirs(workdir, exist_ok=True)
    pool_dir = os.path.join(workdir, "pool")
    if os.path.exists(pool_dir):
        shutil.rmtree(pool_dir)
    try:
        ev = _ENGINES[cfg.workload](cfg, sched, pool_dir)
    except Exception as e:                      # noqa: BLE001
        ev = _Events()
        ev.violations.append(
            f"episode raised {type(e).__name__}: {e}")
    return EpisodeResult(
        workload=cfg.workload, topology=cfg.topology,
        ok=not ev.violations, violations=ev.violations,
        kills_fired=ev.kills, recoveries=ev.recoveries,
        cold_restarts=ev.cold, torn_writes=ev.torn,
        config=cfg.to_dict(), schedule=sched.to_dict())


# ---------------------------------------------------------------------------
# episode generation (pure function of the seed path)
# ---------------------------------------------------------------------------

def _op_estimate(cfg: EpisodeConfig) -> Dict[str, int]:
    """Rough per-worker op-count ceilings used to draw kill indices; an
    overshoot is a vacuous kill (a clean episode), which is fine — the
    distribution just thins toward the tail."""
    if cfg.workload == "train":
        n_obj = cfg.n_tensors + 1
        commits = cfg.steps // cfg.commit_every + 2
        est = {"lstore": (cfg.steps + 1) * n_obj, "rstore": 2, "mstore": 2,
               "rflush": commits * n_obj, "completeOp": commits}
    elif cfg.workload == "serve":
        active = cfg.decode_len // cfg.arrival_every + 1
        commits = cfg.serve_ticks // cfg.commit_every + 2
        est = {"lstore": cfg.serve_ticks * active, "rstore": 2, "mstore": 2,
               "rflush": commits * active, "completeOp": commits}
    else:                                   # cluster / scale
        per_rank = max(1, cfg.n_tensors // cfg.world)
        commits = cfg.steps // cfg.commit_every + 2
        if cfg.workload == "scale":
            commits += 2                    # the join's two extra elections
        est = {"lstore": (cfg.steps + commits) * per_rank,
               "rstore": cfg.steps * per_rank if cfg.replicate else 2,
               "mstore": 2, "rflush": commits * per_rank,
               "completeOp": commits}
    est["any"] = sum(est.values())
    return est


def make_episode(seed_path: Sequence[int], workload: str, topology: str
                 ) -> Tuple[EpisodeConfig, FaultSchedule]:
    """Draw one episode — config knobs + fault schedule — as a pure
    function of the seed path (``np.random.default_rng`` sequence seed)."""
    rng = np.random.default_rng(list(seed_path))
    cfg = EpisodeConfig(workload=workload, topology=topology)
    if workload in ("cluster", "scale"):
        cfg.mode = "sync"
        cfg.steps, cfg.commit_every, cfg.n_tensors = 8, 2, 4
        cfg.replicate = bool(rng.integers(0, 2))
        if workload == "scale":
            cfg.grow_at = int(rng.integers(1, cfg.steps - 1))
    else:
        cfg.mode = str(rng.choice(COMMIT_MODES))
    cfg.emu_seed = int(rng.integers(0, 2 ** 31 - 1))
    est = _op_estimate(cfg)
    n_kills = int(rng.choice([0, 1, 1, 1, 1, 2]
                             if workload in ("train", "serve")
                             else [0, 1, 1, 1, 1]))
    kills = []
    for _ in range(n_kills):
        if workload == "cluster":
            worker = int(rng.integers(0, cfg.world))
        elif workload == "scale":       # the joiner (rank `world`) included
            worker = int(rng.integers(0, cfg.world + 1))
        else:
            worker = 0
        if rng.random() < 0.25:
            points = (KILL_POINTS + JOIN_POINTS if workload == "scale"
                      else KILL_POINTS)
            point = str(rng.choice(points))
            # join windows only ever fire at the pre-join step q — pin the
            # kill there so a drawn join point is never vacuous
            at = (cfg.grow_at - 1 if point in JOIN_POINTS
                  else int(rng.integers(0, cfg.steps)))
            kills.append(KillSpec(worker=worker, point=point, at_step=at))
        else:
            op = str(rng.choice(("any",) + PRIMITIVES))
            kills.append(KillSpec(
                worker=worker, op=op,
                index=int(rng.integers(0, max(1, est[op]))),
                phase=str(rng.choice(("before", "after")))))
    torn = None
    if rng.random() < 0.5:
        torn = TornSpec(rate=float(rng.uniform(0.03, 0.3)),
                        salt=int(rng.integers(0, 2 ** 31 - 1)))
    straggler = None
    if rng.random() < 0.5:
        straggler = StragglerSpec(rate=float(rng.uniform(0.05, 0.3)),
                                  max_mult=float(rng.uniform(2.0, 8.0)),
                                  salt=int(rng.integers(0, 2 ** 31 - 1)))
    return cfg, FaultSchedule(kills=tuple(kills), torn=torn,
                              straggler=straggler)


# ---------------------------------------------------------------------------
# shrinking + reproducers
# ---------------------------------------------------------------------------

def _reductions(sched: FaultSchedule) -> List[FaultSchedule]:
    out = []
    if sched.straggler is not None:
        out.append(dataclasses.replace(sched, straggler=None))
    if sched.torn is not None:
        out.append(dataclasses.replace(sched, torn=None))
    for i in range(len(sched.kills)):
        out.append(dataclasses.replace(
            sched, kills=sched.kills[:i] + sched.kills[i + 1:]))
    return out


def _still_violates(cfg: EpisodeConfig, sched: FaultSchedule) -> bool:
    with tempfile.TemporaryDirectory(prefix="fuzz-shrink-") as d:
        return bool(run_episode(cfg, sched, d).violations)


def shrink_schedule(cfg: EpisodeConfig,
                    sched: FaultSchedule) -> FaultSchedule:
    """Greedy component removal to a fixpoint: drop the straggler model,
    the torn model, then each kill — keep any reduction that still
    violates.  Small schedules (<= 2 kills + 2 models) converge in a
    handful of re-runs."""
    changed = True
    while changed:
        changed = False
        for cand in _reductions(sched):
            if _still_violates(cfg, cand):
                sched = cand
                changed = True
                break
    return sched


def dump_reproducer(workdir: str, seed_path: Sequence[int],
                    cfg: EpisodeConfig, sched: FaultSchedule,
                    res: EpisodeResult, *, shrink: bool = True) -> str:
    """Write the minimal-reproducer JSON for a violated episode."""
    if shrink:
        try:
            sched = shrink_schedule(cfg, sched)
        except Exception:                       # noqa: BLE001
            pass          # an unshrunk reproducer still reproduces
    doc = {"kind": "cxl0-fuzz-reproducer", "version": 1,
           "seed_path": list(seed_path), "workload": cfg.workload,
           "topology": cfg.topology, "config": cfg.to_dict(),
           "schedule": sched.to_dict(), "violations": res.violations}
    path = os.path.join(
        workdir, "repro_{}_{}.json".format(
            cfg.workload, "-".join(str(p) for p in seed_path)))
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    return path


def replay_reproducer(doc_or_path, workdir: Optional[str] = None
                      ) -> EpisodeResult:
    """Re-run a reproducer document (or its file path) and return the
    episode result — same seed, same schedule, same outcome."""
    if isinstance(doc_or_path, str):
        with open(doc_or_path) as f:
            doc = json.load(f)
    else:
        doc = doc_or_path
    cfg = EpisodeConfig.from_dict(doc["config"])
    sched = FaultSchedule.from_dict(doc["schedule"])
    if workdir is not None:
        return run_episode(cfg, sched, workdir)
    with tempfile.TemporaryDirectory(prefix="fuzz-replay-") as d:
        return run_episode(cfg, sched, d)


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SuiteSummary:
    episodes: int = 0
    violations: int = 0
    kills_fired: int = 0
    torn_writes: int = 0
    recoveries: int = 0
    cold_starts: int = 0
    cells: List[dict] = dataclasses.field(default_factory=list)
    reproducers: List[str] = dataclasses.field(default_factory=list)
    log_path: str = ""


def run_fuzz_suite(workdir: str, *, episodes: int = 10, seed: int = 0,
                   topologies: Optional[Sequence[str]] = None,
                   workloads: Sequence[str] = WORKLOADS,
                   shrink: bool = True) -> SuiteSummary:
    """episodes x workloads x topologies, one fresh pool each.  Appends
    every episode result to ``fuzz_episodes.jsonl``; violated episodes are
    shrunk and dumped as reproducer JSONs next to it."""
    topologies = list(topologies or TOPOLOGIES)
    os.makedirs(workdir, exist_ok=True)
    summary = SuiteSummary(log_path=os.path.join(workdir,
                                                 "fuzz_episodes.jsonl"))
    with open(summary.log_path, "w") as log:
        for wi, workload in enumerate(WORKLOADS):
            if workload not in workloads:
                continue
            for ti, topo in enumerate(TOPOLOGIES):
                if topo not in topologies:
                    continue
                cell = {"workload": workload, "topology": topo,
                        "episodes": 0, "violations": 0, "kills": 0,
                        "torn": 0, "recoveries": 0, "cold_starts": 0}
                for ep in range(episodes):
                    seed_path = [seed, ep, wi, ti]
                    cfg, sched = make_episode(seed_path, workload, topo)
                    epdir = os.path.join(
                        workdir, f"ep_{workload}_{ti}_{ep}")
                    res = run_episode(cfg, sched, epdir)
                    log.write(json.dumps(
                        {"seed_path": seed_path, **res.to_json()}) + "\n")
                    cell["episodes"] += 1
                    cell["violations"] += len(res.violations)
                    cell["kills"] += len(res.kills_fired)
                    cell["torn"] += res.torn_writes
                    cell["recoveries"] += len(res.recoveries)
                    cell["cold_starts"] += res.cold_restarts
                    if res.violations:
                        summary.reproducers.append(dump_reproducer(
                            workdir, seed_path, cfg, sched, res,
                            shrink=shrink))
                    shutil.rmtree(epdir, ignore_errors=True)
                summary.cells.append(cell)
                summary.episodes += cell["episodes"]
                summary.violations += cell["violations"]
                summary.kills_fired += cell["kills"]
                summary.torn_writes += cell["torn"]
                summary.recoveries += cell["recoveries"]
                summary.cold_starts += cell["cold_starts"]
    return summary


def corpus_cluster_cell(point: str, replicate: bool, workdir: str, *,
                        steps: int = 6, commit_every: int = 2,
                        kill_step: Optional[int] = None) -> EpisodeResult:
    """One cell of the legacy 6-cell cluster kill matrix as a PINNED fuzz
    schedule: kill rank 1 at ``point`` of the commit window for
    ``kill_step`` (default: the second commit).  tests/test_cluster.py
    parametrizes over the full matrix — the old hand-enumerated suite is
    now a named corpus of the fuzzer."""
    if kill_step is None:
        kill_step = 2 * commit_every - 1
    cfg = EpisodeConfig(workload="cluster", topology="cxl11-direct",
                        mode="sync", steps=steps,
                        commit_every=commit_every, n_tensors=3, dim=8,
                        world=3, replicate=replicate)
    sched = FaultSchedule(kills=(
        KillSpec(worker=1, point=point, at_step=kill_step),))
    return run_episode(cfg, sched, workdir)
