"""Slot-based continuous-batching scheduler (pure state machine; the port's
copy of ``repro.serve.scheduler``, unchanged).

The decode batch has ``n_slots`` fixed lanes.  A slot is either FREE or
RUNNING one request; the scheduler's contract (property-tested in
tests/test_serve.py):

* **admission never exceeds the slot count** — at most ``n_slots``
  requests run at once, everything else waits in the FIFO queue;
* **finished sequences free their slot within one step** — ``release``
  happens in the same scheduler tick that observes completion, so the
  next ``admit`` can refill the lane immediately (this is the whole
  throughput win over static batching: no lane idles behind the longest
  sequence of a batch);
* **FIFO fairness under oversubscription** — requests are admitted in
  arrival order; a request never overtakes an earlier one into a slot.

The scheduler owns WHICH request runs WHERE and nothing else: token
state lives with the engine, cache blocks with the KV manager.  That
keeps it a deterministic, millisecond-testable state machine.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a prompt and a decode budget.

    ``arrival`` is the tick the request enters the system (0 = present
    from the start, the pre-arrival-time behaviour).  Only arrival-aware
    callers (the reference's scale.traffic / scale.autoscaler) read it;
    the scheduler itself stays arrival-blind — whoever submits decides
    *when*."""
    rid: str
    prompt: Tuple[int, ...]              # prompt token ids
    max_new_tokens: int
    arrival: int = 0

    def __post_init__(self):
        assert len(self.prompt) > 0, "empty prompt"
        assert self.max_new_tokens >= 1, self.max_new_tokens
        assert self.arrival >= 0, self.arrival


class SlotScheduler:
    def __init__(self, n_slots: int):
        assert n_slots >= 1, n_slots
        self.n_slots = n_slots
        self.slots: List[Optional[str]] = [None] * n_slots
        self.pending: Deque[Request] = deque()
        self.running: Dict[str, int] = {}      # rid -> slot
        self._admitted: List[str] = []         # admission order (for tests)

    # -- queue side ----------------------------------------------------------
    def submit(self, requests: Sequence[Request]):
        for r in requests:
            assert r.rid not in self.running and all(
                p.rid != r.rid for p in self.pending), f"dup rid {r.rid}"
            self.pending.append(r)

    def submit_front(self, request: Request):
        """Queue a request AHEAD of everything pending.  Used for
        migrated-in and crash-resumed sessions: they were admitted first
        in their previous incarnation, so FIFO fairness (measured over
        the fleet's lifetime, not one engine's) puts them first here."""
        assert request.rid not in self.running and all(
            p.rid != request.rid for p in self.pending), \
            f"dup rid {request.rid}"
        self.pending.appendleft(request)

    # -- slot side -----------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, sid in enumerate(self.slots) if sid is None]

    @property
    def n_running(self) -> int:
        return len(self.running)

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the FIFO queue; returns (slot, request)
        pairs for the engine to prefill.  Never exceeds ``n_slots``."""
        placed: List[Tuple[int, Request]] = []
        for slot in self.free_slots():
            if not self.pending:
                break
            req = self.pending.popleft()
            self.slots[slot] = req.rid
            self.running[req.rid] = slot
            self._admitted.append(req.rid)
            placed.append((slot, req))
        return placed

    def release(self, rid: str) -> int:
        """Finished sequence frees its slot (same tick as completion)."""
        slot = self.running.pop(rid)
        assert self.slots[slot] == rid, (rid, slot, self.slots[slot])
        self.slots[slot] = None
        return slot

    @property
    def done(self) -> bool:
        return not self.pending and not self.running

    @property
    def admission_order(self) -> List[str]:
        return list(self._admitted)
