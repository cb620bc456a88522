"""CXL0 — the paper's contribution: a programming model for disaggregated
memory over CXL, as an executable artifact.

Layers:
* ``state`` / ``semantics``   — the operational semantics (LTS) + variants
* ``explore`` / ``refine``    — bounded model checking, trace inclusion
* ``litmus`` / ``props``      — the paper's litmus tests and Proposition 1
* ``flit`` / ``objects`` / ``sim`` / ``durable`` / ``harness``
                              — the FliT-for-CXL0 transformation (Alg. 2)
                                and the durable-linearizability checker
* ``latency``                 — Fig. 5 latency model + Table 1 mapping
* ``semantics_torch``         — vectorized tensor twin (batched fuzzing)
"""
from repro_torch.core.state import (  # noqa: F401
    BOT, State, SystemConfig, initial_state, make_config, check_invariant,
)
from repro_torch.core.semantics import (  # noqa: F401
    Variant, Label, LStore, RStore, MStore, Load, LFlush, RFlush, GPF, Crash,
    RMW, apply_label, step_with_tau,
)
from repro_torch.core.explore import trace_feasible, reachable  # noqa: F401
from repro_torch.core.flit import (  # noqa: F401
    POLICIES, DURABLE_POLICIES, NON_DURABLE_POLICIES,
)
from repro_torch.core.durable import durably_linearizable, linearizable  # noqa: F401
