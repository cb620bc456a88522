"""Quickstart: the CXL0 model in 4 acts — the port of
``examples/quickstart.py``, on ``repro_torch``.

  1. litmus tests — what can(not) happen under partial crashes;
  2. Proposition 1 — primitive simulations, checked exhaustively;
  3. FliT-for-CXL0 — the §6 transformation making a concurrent counter
     durably linearizable, with the untransformed object as the foil;
  4. the same transformation as a one-line API over the REAL runtime:
     ``open_cxl0(...).transform(CounterSpec())`` — completed increments
     survive a worker crash, recovered through the one recovery path.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from repro_torch.core.litmus import LITMUS_TESTS, run_litmus
from repro_torch.core.semantics import Variant
from repro_torch.core.props import PROP1_ITEMS, check_prop1_item
from repro_torch.core.state import make_config
from repro_torch.core.harness import WORKLOADS, run_once


def act1_litmus():
    print("=" * 70)
    print("Act 1 — litmus tests (paper Fig. 3 + §3.5 + §6)")
    print("=" * 70)
    for t in LITMUS_TESTS:
        verdicts = " ".join(
            f"{v.value}:{'✓' if run_litmus(t, v) else '✗'}"
            for v in Variant)
        print(f"  {t.name:42s} {verdicts}")


def act2_prop1():
    print("=" * 70)
    print("Act 2 — Proposition 1, verified exhaustively (2 machines × 2 locs)")
    print("=" * 70)
    cfg = make_config(2, 1)
    for item in PROP1_ITEMS[:4]:        # first four (fast subset)
        res = check_prop1_item(item, cfg)
        print(f"  Prop 1.{item.idx} {item.name:45s} "
              f"checked={res.checked}  ok={res.ok}")
    print("  (items 5-8 run in tests/test_props.py)")


def act3_flit():
    print("=" * 70)
    print("Act 3 — FliT transformation: durable vs not, under crashes")
    print("=" * 70)
    mk = WORKLOADS["counter"]
    for policy in ("raw", "original_flit", "flit_cxl0", "mstore_all"):
        viol = sum(not run_once(mk, policy, seed, p_crash=0.08,
                                max_crashes=2).durable
                   for seed in range(100))
        verdict = "NOT durable" if viol else "durably linearizable"
        print(f"  {policy:15s} violations={viol:3d}/100  -> {verdict}")


def act4_context():
    print("=" * 70)
    print("Act 4 — ctx.transform: the §6 counter on the real runtime")
    print("=" * 70)
    import shutil
    import tempfile
    from repro_torch.core.objects import CounterSpec
    from repro_torch.dsm.api import open_cxl0

    tmp = tempfile.mkdtemp(prefix="quickstart_act4_")
    try:
        ctx = open_cxl0(f"{tmp}/pool", schedule="sync")
        counter = ctx.transform(CounterSpec(), name="counter")
        got = [counter.op("inc") for _ in range(5)]
        print(f"  5 increments returned {got}; live value "
              f"{counter.state}")
        ctx.crash()         # the worker's volatile tiers vanish
        revived = open_cxl0(f"{tmp}/pool").transform(CounterSpec(),
                                                     name="counter")
        print(f"  after crash + recovery ({revived.recovered_from[1]}): "
              f"value {revived.state}, {revived.ops_done + 1} completed ops")
        assert revived.state == 5
        print("  every completed op survived — durably linearizable")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    act1_litmus()
    act2_prop1()
    act3_flit()
    act4_context()
