"""The paper's litmus tests (§3.4 Fig. 3, §3.5 tests 10–12, §6 test 13).

Each test is a serialized trace of CXL0 labels plus the expected verdict:
``True`` = the behavior is allowed (✓), ``False`` = illegal (✗).  Verdicts
are *per variant* for the §3.5 tests.  Machine/location indices are
0-based here; the paper's ``x^i`` notation (location on machine i) appears
in comments with the paper's 1-based numbering.

All memories are non-volatile (as the paper assumes for these tests).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from repro_torch.core.state import SystemConfig, make_config
from repro_torch.core.semantics import (
    Crash, Label, LFlush, LStore, Load, MStore, RFlush, RStore, Variant,
)
from repro_torch.core.explore import trace_feasible


@dataclasses.dataclass(frozen=True)
class LitmusTest:
    name: str
    description: str
    cfg: SystemConfig
    trace: Tuple[Label, ...]
    # verdict per variant: True = allowed (✓), False = illegal (✗)
    expected: Dict[Variant, bool]


def _expect(base: bool, lwb=None, psn=None) -> Dict[Variant, bool]:
    return {Variant.BASE: base,
            Variant.LWB: base if lwb is None else lwb,
            Variant.PSN: base if psn is None else psn}


# two machines, one location each: loc 0 = x^1 (machine 0), loc 1 = x^2
CFG2 = make_config(2, 1)
# three machines for test 7: loc i on machine i
CFG3 = make_config(3, 1)
# two locations on machine 1 plus one on machine 0 for tests 8/9
CFG_89 = SystemConfig(n_machines=2, owner=(0, 1), volatile=(False, False))


LITMUS_TESTS: Tuple[LitmusTest, ...] = (
    # ---------------- single machine (tests 1–3) --------------------------
    LitmusTest(
        "test1_rstore_lost",
        "A value stored with RStore may be lost on crash: it completes in "
        "the owner's cache, which is volatile. (paper: ✓)",
        CFG2,
        (RStore(0, 0, 1), Crash(0), Load(0, 0, 0)),
        _expect(True)),
    LitmusTest(
        "test2_mstore_survives",
        "MStore persists before returning, so the post-crash load cannot "
        "observe the initial value. (paper: ✗)",
        CFG2,
        (MStore(0, 0, 1), Crash(0), Load(0, 0, 0)),
        _expect(False)),
    LitmusTest(
        "test3_lflush_persists_local",
        "LStore + LFlush by the owner forces vertical propagation to local "
        "persistent memory; the value cannot be lost. (paper: ✗)",
        CFG2,
        (LStore(0, 0, 1), LFlush(0, 0), Crash(0), Load(0, 0, 0)),
        _expect(False)),

    # ---------------- multiple machines (tests 4–7) -----------------------
    LitmusTest(
        "test4_remote_rstore_lost",
        "RStore to a remote location completes in the remote owner's cache; "
        "if the owner crashes before write-back the value is lost. "
        "(paper: ✓)",
        CFG2,
        (RStore(0, 1, 1), Crash(1), Load(0, 1, 0)),
        _expect(True)),
    LitmusTest(
        "test5_rflush_prevents_loss",
        "RFlush blocks until no cache holds the line (∀j. C_j = ⊥), i.e. the "
        "value reached the owner's memory; the crash cannot lose it. "
        "(paper: ✗)",
        CFG2,
        (RStore(0, 1, 1), RFlush(0, 1), Crash(1), Load(0, 1, 0)),
        _expect(False)),
    LitmusTest(
        "test6_load_copy_saves_value",
        "Loading copies the value into the loader's cache, so after the "
        "writer crashes the reader still observes it from C_2. (paper: ✗ "
        "for the loss; under LWB the first remote load is instead served "
        "after a forced write-back, which also prevents the loss.)",
        CFG2,
        # machine 0 LStores to x^2 (remote); machine 1 loads it (copy into
        # C_2); machine 0 crashes; the value must still be visible.
        (LStore(0, 1, 1), Load(1, 1, 1), Crash(0), Load(1, 1, 0)),
        _expect(False)),
    LitmusTest(
        "test7_flush_moves_to_third_cache",
        "Machine 1's LFlush pushes its copy toward the owner's (machine 3) "
        "cache, so the value survives the writer's crash in C_3. (paper: ✗)",
        CFG3,
        # x^3 = loc 2 owned by machine 2. machine 0 writes, machine 1 loads
        # and flushes (copy moves to owner cache), machine 0 crashes.
        (LStore(0, 2, 1), Load(1, 2, 1), LFlush(1, 2), Crash(0),
         Load(1, 2, 0)),
        _expect(False)),

    # ---------------- multiple variables (tests 8–9) ----------------------
    LitmusTest(
        "test8_observed_then_lost",
        "A stored value that another operation already observed (and "
        "propagated into its own write) can be lost: recovery shows the "
        "later operation's effect without the first. (paper: ✓)",
        CFG_89,
        # y^1 = loc 0 (machine 0), x^2 = loc 1 (machine 1).
        # RStore_2(y^1, x^2) shorthand: machine 1 reads x^2 then RStores to
        # y^1. Machine 1 crashes; x is lost but y survived at machine 0.
        (RStore(0, 1, 1),            # machine 0 writes x^2 := 1 (owner cache)
         Load(1, 1, 1),              # machine 1 reads x^2 == 1
         RStore(1, 0, 1),            # ... and RStores it into y^1
         Crash(1),                   # machine 1 crashes: x^2 lost
         Load(0, 0, 1),              # y survived (machine 0's cache/memory)
         Load(0, 1, 0)),             # but x is back to 0 — inconsistent ✓
        # LWB too: machine 1 OWNS x^2, so its load is an own-cache hit and
        # does not force a write-back.
        _expect(True)),
    LitmusTest(
        "test9_mstore_prevents_inconsistency",
        "Using MStore for the first write persists x before it can be "
        "observed, so the inconsistent recovery of test 8 is impossible. "
        "(paper: ✗)",
        CFG_89,
        (MStore(0, 1, 1), Load(1, 1, 1), RStore(1, 0, 1), Crash(1),
         Load(0, 0, 1), Load(0, 1, 0)),
        _expect(False)),

    # ---------------- §3.5 variant-distinguishing tests 10–12 -------------
    LitmusTest(
        "test10_variants",
        "RStore_2(x^1,1); Load_2(x^1,1); f_1; Load_2(x^1,0) — the copy in "
        "C_2 may propagate home before the crash (BASE/PSN ✓); LWB forces "
        "the remote load through memory, so the value persisted (✗).",
        CFG2,
        (RStore(1, 0, 1), Load(1, 0, 1), Crash(0), Load(1, 0, 0)),
        {Variant.BASE: True, Variant.LWB: False, Variant.PSN: True}),
    LitmusTest(
        "test11_variants",
        "LStore_1(x^1,1); Load_2(x^1,1); f_1; Load_1(x^1,0) — same loss "
        "pattern with the writer being the owner. (✓, ✗, ✓)",
        CFG2,
        (LStore(0, 0, 1), Load(1, 0, 1), Crash(0), Load(0, 0, 0)),
        {Variant.BASE: True, Variant.LWB: False, Variant.PSN: True}),
    LitmusTest(
        "test12_variants",
        "LStore_2(x^1,1); f_1; Load_1(x^1,1); f_1; Load_2(x^1,0) — under "
        "LWB the owner's load can hit its OWN cache after a C-C propagation "
        "without touching memory, so a second crash still loses the value "
        "(✓); PSN poisons x^1 in C_2 at the first crash, making the "
        "intermediate Load_1(x^1,1) impossible (✗).",
        CFG2,
        (LStore(1, 0, 1), Crash(0), Load(0, 0, 1), Crash(0), Load(1, 0, 0)),
        {Variant.BASE: True, Variant.LWB: True, Variant.PSN: False}),

    # ---------------- §6 motivating example (test 13) ---------------------
    LitmusTest(
        "test13_remote_crash_breaks_local_program",
        "§6: x ∈ Loc_M2; M1 runs x=1; r1=x; r2=x. A crash of the REMOTE "
        "machine M2 between the two loads can make r1 ≠ r2 — impossible in "
        "any single-machine model. (✓ = assertion can fail; under LWB the "
        "first load hits M1's own cache, and the copy can still be evicted "
        "toward M2 and lost, so the behavior remains allowed)",
        CFG2,
        (LStore(0, 1, 1), Load(0, 1, 1), Crash(1), Load(0, 1, 0)),
        _expect(True)),
    LitmusTest(
        "test13b_lflush_insufficient",
        "§6: an LFlush between the store and the loads does NOT fix test 13 "
        "— it only moves the value into M2's (volatile) cache. (✓)",
        CFG2,
        (LStore(0, 1, 1), LFlush(0, 1), Load(0, 1, 1), Crash(1),
         Load(0, 1, 0)),
        _expect(True, lwb=False)),
    LitmusTest(
        "test13c_rflush_fixes",
        "§6: an RFlush (reaches physical memory) makes the assertion always "
        "hold. (✗)",
        CFG2,
        (LStore(0, 1, 1), RFlush(0, 1), Load(0, 1, 1), Crash(1),
         Load(0, 1, 0)),
        _expect(False)),
)


def run_litmus(test: LitmusTest, variant: Variant) -> bool:
    """True iff the behavior is allowed under ``variant``."""
    return trace_feasible(test.cfg, test.trace, variant)


def run_all(variants: Sequence[Variant] = tuple(Variant)):
    """-> list of (test, variant, allowed, expected) rows."""
    rows = []
    for t in LITMUS_TESTS:
        for v in variants:
            rows.append((t, v, run_litmus(t, v), t.expected[v]))
    return rows
