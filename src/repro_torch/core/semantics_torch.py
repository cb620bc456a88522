"""CXL0 on tensors: the vectorized executable semantics, batched — the port
of ``repro.core.semantics_jax``.

The Python LTS (``core.semantics``) is the reference; this module is its
tensor twin for *scale*: a whole batch of states is two integer tensors,
one scheduler step computes every branch for every row and selects per row
by the action's kind (what ``vmap`` makes of the reference's
``lax.switch``), and ``run_schedules`` loops over the schedule's steps on
the tensors' device.  Millions of random schedules run at once on the
card: the fuzzing rig behind ``repro_torch.bench.model_fuzz``.

Encoding (the reference's, batched)
-----------------------------------
* ``C``: (B, N, L) int32, value or ``BOT = -1``
* ``M``: (B, L) int32 (the owner map is static)
* actions: (B, T, 5) int32 ``[kind, machine, loc, val, flavor]`` with kinds
  from ``ACT`` and flavors from ``FLAVOR``.  Disabled / blocked actions are
  no-ops (flushes drain eagerly — the executable interpretation the Python
  ``Simulator`` uses; the blocking LTS view lives in ``core.semantics``).
  A kind below 0 is a no-op and one above 10 an FAA, as the reference
  clamps; an FAA of a flavor other than l / r is an m-FAA.

Loads write their observed value into the step's output, so schedules
return full observation traces ``obs`` (B, T).

One deliberate difference: the reference's gathers clamp an out-of-range
machine or location and its scatters drop it; ``run_schedules`` checks
both once per batch and raises ``ValueError`` instead.

Everything is integer arithmetic, so a run is bit-identical on every
device.  ``lts_run`` drives the Python LTS one schedule at a time with the
same eager interpretation (the oracle of the tests and of
``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import state as cstate
from repro_torch.core.semantics import (
    step_crash, step_faa, step_load, step_lstore, step_mstore, step_rstore,
    step_tau_cc, step_tau_cm,
)

BOT = -1

ACT = dict(noop=0, lstore=1, rstore=2, mstore=3, load=4, lflush=5, rflush=6,
           tau_cc=7, tau_cm=8, crash=9, faa=10)
FLAVOR = dict(l=0, r=1, m=2)

#: the kinds ``random_schedules`` draws and their weights (crashes come
#: from a separate Bernoulli mask), as in the reference
KIND_WEIGHTS = (
    (ACT["lstore"], .2), (ACT["rstore"], .1), (ACT["mstore"], .1),
    (ACT["load"], .25), (ACT["lflush"], .05), (ACT["rflush"], .05),
    (ACT["tau_cc"], .1), (ACT["tau_cm"], .05), (ACT["faa"], .1))

_INT32_MIN = torch.iinfo(torch.int32).min


@dataclasses.dataclass(frozen=True)
class TorchSystem:
    """Static system description (owner map, volatility per machine)."""
    owner: Tuple[int, ...]
    volatile: Tuple[bool, ...]
    n_machines: int

    @property
    def n_locs(self) -> int:
        return len(self.owner)

    def owner_t(self, device) -> torch.Tensor:
        return torch.tensor(self.owner, dtype=torch.int32, device=device)

    def volatile_t(self, device) -> torch.Tensor:
        return torch.tensor(self.volatile, dtype=torch.bool, device=device)

    def config(self) -> cstate.SystemConfig:
        """The same system for the Python LTS."""
        return cstate.SystemConfig(n_machines=self.n_machines,
                                   owner=tuple(self.owner),
                                   volatile=tuple(self.volatile))


def initial_tensors(sys: TorchSystem, batch: int, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    C = torch.full((batch, sys.n_machines, sys.n_locs), BOT,
                   dtype=torch.int32, device=device)
    M = torch.zeros((batch, sys.n_locs), dtype=torch.int32, device=device)
    return C, M


def _check_indices(sys: TorchSystem, actions: torch.Tensor):
    if actions.dim() != 3 or actions.shape[-1] != 5:
        raise ValueError(f"actions must be (B, T, 5), got "
                         f"{tuple(actions.shape)}")
    if actions.dtype != torch.int32:
        raise ValueError(f"actions must be int32, got {actions.dtype}")
    if not actions.numel():
        return
    lo = actions[..., 1:3].amin(dim=(0, 1)).tolist()
    hi = actions[..., 1:3].amax(dim=(0, 1)).tolist()
    for what, a, b, n in (("machine", lo[0], hi[0], sys.n_machines),
                          ("loc", lo[1], hi[1], sys.n_locs)):
        if a < 0 or b >= n:
            raise ValueError(f"{what} index out of range [0, {n}): "
                             f"min {a}, max {b} (the JAX twin would clamp "
                             f"or drop it)")


def step(sys: TorchSystem, C: torch.Tensor, M: torch.Tensor,
         action: torch.Tensor, owner: Optional[torch.Tensor] = None,
         volatile: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One scheduler step of every row: ``action`` (B, 5) int32 ->
    ``(C, M, obs)`` with ``obs`` (B,).  Indices must be in range (see
    ``run_schedules``).  ``owner`` / ``volatile`` are the system's tensors
    on ``C``'s device (built here when not given)."""
    dev = C.device
    if owner is None:
        owner = sys.owner_t(dev)
    if volatile is None:
        volatile = sys.volatile_t(dev)
    B, N, _ = C.shape
    kind = action[:, 0].clamp(0, 10)
    i, x, v, fl = (action[:, 1].long(), action[:, 2].long(), action[:, 3],
                   action[:, 4])
    bot = torch.full_like(v, BOT)

    # column x of every row, and the machine masks over it
    xcol = x.view(B, 1, 1).expand(B, N, 1)
    col = C.gather(2, xcol).squeeze(2)                          # (B, N)
    mx = M.gather(1, x.view(B, 1)).squeeze(1)                   # (B,)
    k = owner[x].long()                                         # owner[x]
    machines = torch.arange(N, device=dev)
    is_i = machines == i.view(B, 1)
    is_k = machines == k.view(B, 1)
    botcol = torch.full_like(col, BOT)

    valid = col != BOT
    any_valid = valid.any(1)
    # _cached_value: the MAX of the valid cached values
    cval = torch.where(valid, col, _INT32_MIN).amax(1)
    loaded = torch.where(any_valid, cval, mx)                   # _load's out
    vi = col.gather(1, i.view(B, 1)).squeeze(1)                 # C[i, x]
    vk = col.gather(1, k.view(B, 1)).squeeze(1)                 # C[k, x]
    i_is_k = i == k

    def only(mask, val):
        """_lstore / _rstore's column: ``val`` at ``mask``, BOT elsewhere."""
        return torch.where(mask, val.view(B, 1), botcol)

    # C_i(x) -> C_k(x) (the non-owner half of an LFlush, and tau_cc)
    to_owner = torch.where(is_k, vi.view(B, 1), torch.where(is_i, BOT, col))
    has_i, has_k = vi != BOT, vk != BOT
    faa_new = loaded + v
    faa_col = torch.where((fl == 0).view(B, 1), only(is_i, faa_new),
                          torch.where((fl == 1).view(B, 1),
                                      only(is_k, faa_new), botcol))

    # per kind: (column x, M[x], obs); a no-op leaves all three as they
    # are, and a crash acts on whole rows below
    branches = {
        ACT["lstore"]: (only(is_i, v), mx, bot),
        ACT["rstore"]: (only(is_k, v), mx, bot),
        ACT["mstore"]: (botcol, v, bot),
        ACT["load"]: (torch.where(any_valid.view(B, 1) & is_i,
                                  loaded.view(B, 1), col), mx, loaded),
        ACT["lflush"]: (
            torch.where(has_i.view(B, 1),
                        torch.where(i_is_k.view(B, 1), botcol, to_owner),
                        col),
            torch.where(has_i & i_is_k, vi, mx), bot),
        ACT["rflush"]: (botcol, torch.where(any_valid, cval, mx), bot),
        ACT["tau_cc"]: (torch.where((has_i & ~i_is_k).view(B, 1), to_owner,
                                    col), mx, bot),
        ACT["tau_cm"]: (torch.where(has_k.view(B, 1), botcol, col),
                        torch.where(has_k, vk, mx), bot),
        ACT["faa"]: (faa_col, torch.where((fl == 0) | (fl == 1), mx, faa_new),
                     loaded),
    }
    new_col, new_mx, obs = col, mx, bot
    for b, (bc, bm, bo) in branches.items():
        sel = kind == b
        new_col = torch.where(sel.view(B, 1), bc, new_col)
        if bm is not mx:
            new_mx = torch.where(sel, bm, new_mx)
        if bo is not bot:
            obs = torch.where(sel, bo, obs)
    # write column x back through a mask, not a scatter: a select is one
    # pass whatever ``torch.use_deterministic_algorithms`` says, where a
    # deterministic scatter sorts its indices first
    at_x = torch.arange(C.shape[2], device=dev) == x.view(B, 1)     # (B, L)
    C = torch.where(at_x.view(B, 1, -1), new_col.unsqueeze(2), C)
    M = torch.where(at_x, new_mx.view(B, 1), M)

    # _crash: machine i's cache row empties; M zeroes at the locations i
    # owns, only where machine i is volatile
    crash = kind == ACT["crash"]
    C = torch.where((crash.view(B, 1) & is_i).unsqueeze(2), BOT, C)
    owned = owner.view(1, -1) == i.view(B, 1).to(owner.dtype)
    M = torch.where(owned & (crash & volatile[i]).view(B, 1), 0, M)
    return C, M, obs


def run_schedules(sys: TorchSystem, actions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, 5) int32 -> final ``C`` (B, N, L), ``M`` (B, L) and the
    observations (B, T), all on ``actions``' device.  Raises
    ``ValueError`` on an out-of-range machine or location."""
    _check_indices(sys, actions)
    B, T, _ = actions.shape
    dev = actions.device
    owner, volatile = sys.owner_t(dev), sys.volatile_t(dev)
    C, M = initial_tensors(sys, B, dev)
    obs = torch.empty((B, T), dtype=torch.int32, device=dev)
    for t in range(T):
        C, M, obs[:, t] = step(sys, C, M, actions[:, t], owner, volatile)
    return C, M, obs


def random_schedules(sys: TorchSystem, generator: torch.Generator,
                     batch: int, length: int, max_val: int = 4,
                     p_crash: float = 0.02) -> torch.Tensor:
    """Random (batch, length, 5) int32 action tensors for fuzzing, drawn
    from ``generator`` on its device: kinds by ``KIND_WEIGHTS``, a crash
    with probability ``p_crash`` in place of any of them, machines,
    locations and values uniform, flavor l."""
    dev = generator.device
    shape = (batch, length)
    kinds = torch.tensor([k for k, _ in KIND_WEIGHTS], dtype=torch.int32,
                         device=dev)
    cum = torch.tensor(np.cumsum([w for _, w in KIND_WEIGHTS]),
                       dtype=torch.float32, device=dev)
    u = torch.rand(shape, generator=generator, device=dev) * cum[-1]
    kind = kinds[torch.bucketize(u, cum, right=True).clamp_(
        max=len(KIND_WEIGHTS) - 1)]
    crash = torch.rand(shape, generator=generator, device=dev) < p_crash
    kind = torch.where(crash, ACT["crash"], kind)
    machines = torch.randint(0, sys.n_machines, shape, generator=generator,
                             device=dev, dtype=torch.int32)
    locs = torch.randint(0, sys.n_locs, shape, generator=generator,
                         device=dev, dtype=torch.int32)
    vals = torch.randint(0, max_val, shape, generator=generator, device=dev,
                         dtype=torch.int32)
    flavors = torch.zeros(shape, dtype=torch.int32, device=dev)
    return torch.stack([kind, machines, locs, vals, flavors], dim=-1)


def invariant_violations(C: torch.Tensor) -> torch.Tensor:
    """Count of (b, x) whose caches hold more than one distinct non-BOT
    value across machines (the single-valid-value invariant), as a 0-d
    int64 tensor on ``C``'s device."""
    valid = C != BOT
    hi = torch.where(valid, C, _INT32_MIN).amax(1)
    lo = torch.where(valid, C, torch.iinfo(torch.int32).max).amin(1)
    return (valid.any(1) & (hi != lo)).sum()


# ---------------------------------------------------------------------------
# The Python LTS under the same eager interpretation (the oracle)
# ---------------------------------------------------------------------------

def lts_run(cfg: cstate.SystemConfig, actions: Sequence[Sequence[int]]
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One (T, 5) schedule through the Python LTS (``core.semantics``) with
    eager flushes -> ``(C, M, obs)`` as int32 arrays."""
    flavors = {FLAVOR["l"]: "l", FLAVOR["r"]: "r"}
    s = cstate.initial_state(cfg)
    obs = []
    for kind, i, x, v, fl in actions:
        kind, i, x, v = min(max(int(kind), 0), 10), int(i), int(x), int(v)
        o = BOT
        if kind == ACT["lstore"]:
            s = step_lstore(cfg, s, i, x, v)
        elif kind == ACT["rstore"]:
            s = step_rstore(cfg, s, i, x, v)
        elif kind == ACT["mstore"]:
            s = step_mstore(cfg, s, i, x, v)
        elif kind == ACT["load"]:
            s, o = step_load(cfg, s, i, x)
        elif kind == ACT["lflush"]:
            if s.C[i][x] is not cstate.BOT:
                if cfg.owner[x] == i:
                    s = step_tau_cm(cfg, s, x)
                else:
                    s = step_tau_cc(cfg, s, i, x)
        elif kind == ACT["rflush"]:
            while s.cached_anywhere(x):
                non_owner = [h for h in s.holders(x) if h != cfg.owner[x]]
                if non_owner:
                    s = step_tau_cc(cfg, s, non_owner[0], x)
                else:
                    s = step_tau_cm(cfg, s, x)
        elif kind == ACT["tau_cc"]:
            s2 = step_tau_cc(cfg, s, i, x)
            s = s2 if s2 is not None else s
        elif kind == ACT["tau_cm"]:
            s2 = step_tau_cm(cfg, s, x)
            s = s2 if s2 is not None else s
        elif kind == ACT["crash"]:
            s = step_crash(cfg, s, i)
        elif kind == ACT["faa"]:
            s, o = step_faa(cfg, s, i, x, v, flavors.get(int(fl), "m"))
        obs.append(o)
    C = np.array([[(BOT if c is cstate.BOT else c) for c in row]
                  for row in s.C], np.int32)
    return C, np.array(s.M, np.int32), np.array(obs, np.int32)
