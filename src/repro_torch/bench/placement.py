"""Placement-policy benchmark: cost-driven tier placement against fixed
policies across the emulated CXL topology presets; the twin of
``benchmarks/bench_placement.py``.

    python -m repro_torch.bench.placement [--device cpu] [--out DIR]

For every preset (``cxl11-direct``, ``cxl20-switched-pool``,
``cxl30-fabric``) a seeded workload of 24 spill-then-consume objects
(log-uniform sizes, 4 KiB to 64 MiB) is placed three ways — always
RStore-staged to a peer, always flushed to the pool at the policy's best
shard count, or per object by ``PlacementPolicy.choose_spill`` — and
scored by the expected end-to-end ns of the SAME cost model the emulator
prices ops with:

* ``placement_policy_over_best_fixed.<preset>`` (<= 1.0),
  ``placement_decisions.<preset>`` (the staging / pool split),
  ``placement_policy_never_worse`` and ``placement_strict_win_presets``;
* ``placement_emulated_trace_ops.<preset>`` — the policy's routed spills
  driven through a real ``TierManager`` with the topology emulator
  attached (payloads capped at 4 KiB, as tensors on ``--device``): the
  priced ops of the trace.

Every ns and ms here is a MODELLED cost of the emulated CXL link, priced
from the paper's Fig. 5 calibration: none is a time measured on this
machine or on the card.  Exit status 1 if the policy ever loses to a
fixed strategy or never strictly wins.
"""
from __future__ import annotations

import shutil
import tempfile
from typing import Dict, List

import numpy as np

from repro_torch.bench.report import Report, arg_parser
from repro_torch.dsm.emu import PRESETS, TopologyEmulator, attach_emulator
from repro_torch.dsm.placement import PlacementPolicy

N_OBJECTS = 24
SIZE_RANGE = (4 << 10, 64 << 20)         # 4 KiB .. 64 MiB, log-uniform
SEED = 0


def workload_sizes(n: int = N_OBJECTS, seed: int = SEED) -> List[int]:
    rng = np.random.default_rng(seed)
    lo, hi = np.log(SIZE_RANGE[0]), np.log(SIZE_RANGE[1])
    return [int(np.exp(x)) for x in rng.uniform(lo, hi, size=n)]


def score(policy: PlacementPolicy, sizes: List[int]) -> Dict[str, float]:
    """Expected modelled ns of the whole workload under each strategy."""
    totals = {"staging": 0.0, "pool": 0.0, "policy": 0.0}
    n_staging = 0
    for i, nb in enumerate(sizes):
        costs = policy.spill_costs(nb)
        totals["staging"] += costs["staging"]
        totals["pool"] += costs["pool"]
        choice = policy.choose_spill(f"obj{i}", nb)
        totals["policy"] += costs[choice]
        n_staging += choice == "staging"
    totals["n_staging"] = n_staging
    totals["n_pool"] = len(sizes) - n_staging
    return totals


def emulated_run(preset: str, sizes: List[int],
                 device: str = "cuda") -> Dict[str, float]:
    """Drive the policy's routed spills through a real TierManager with
    the topology emulator attached: staging choices rstore into a peer
    context, pool choices rflush_sharded at the chosen shard count.
    Returns the priced-trace summary (deterministic for a preset + seed)."""
    import torch

    from repro_torch.dsm.api import open_cxl0
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    policy = PlacementPolicy(preset)
    emu = TopologyEmulator(preset, seed=SEED)
    tmp = tempfile.mkdtemp(prefix=f"bench_placement_{preset}_")
    try:
        tiers = attach_emulator(open_cxl0(f"{tmp}/pool").tiers, emu)
        peer = open_cxl0(f"{tmp}/peer")
        for i, nb in enumerate(sizes):
            name = f"obj{i}"
            # the routing is driven by the workload size nb; the payload
            # moved (and priced) is capped at 4 KiB to keep the run light
            tree = {"x": torch.zeros(max(1, min(nb, 1 << 12)) // 4,
                                     dtype=torch.float32, device=dev)}
            tiers.lstore(name, tree)
            if policy.choose_spill(name, nb) == "staging":
                tiers.rstore(name, peer)
            else:
                tiers.rflush_sharded(name, policy.choose_shards(nb, name))
        tiers.close()
        return {"ops": len(emu.trace), "total_ns": emu.total_ns(),
                **{f"{op}_ns": v for op, v in emu.per_op_ns().items()}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(device: str = "cuda") -> Report:
    report = Report("placement")
    sizes = workload_sizes()
    report.set_config(n_objects=N_OBJECTS, size_range=list(SIZE_RANGE),
                      seed=SEED, presets=sorted(PRESETS), device=device)
    strict_wins = 0
    all_ok = True
    for preset in sorted(PRESETS):
        t = score(PlacementPolicy(preset), sizes)
        best_fixed = min(t["staging"], t["pool"])
        ok = (t["policy"] <= t["staging"] + 1e-9
              and t["policy"] <= t["pool"] + 1e-9)
        strict_wins += t["policy"] < best_fixed * (1 - 1e-9)
        all_ok = all_ok and ok
        for strat in ("staging", "pool", "policy"):
            report.record(f"placement_total_ms.{preset}.{strat}",
                          t[strat] / 1e6,
                          f"preset={preset} strategy={strat} (modelled)",
                          fmt=".3f")
        report.record(f"placement_policy_over_best_fixed.{preset}",
                      t["policy"] / best_fixed,
                      f"preset={preset} (<= 1.0 required)", fmt=".4f")
        report.record(f"placement_decisions.{preset}",
                      f"{t['n_staging']}s/{t['n_pool']}p",
                      f"preset={preset} staging/pool split")
    report.record("placement_policy_never_worse", bool(all_ok),
                  "policy <= both fixed strategies on every preset")
    report.record("placement_strict_win_presets", int(strict_wins),
                  "presets where the policy beats BOTH fixed strategies")
    for preset in sorted(PRESETS):
        r = emulated_run(preset, sizes, device)
        report.record(f"placement_emulated_trace_ops.{preset}", r["ops"],
                      f"preset={preset} priced TierManager ops")
        report.record(f"placement_emulated_trace_ms.{preset}",
                      r["total_ns"] / 1e6,
                      f"preset={preset} priced-trace occupancy (modelled)",
                      fmt=".3f")
    return report


def main(argv=None) -> int:
    args = arg_parser(__doc__, device=True).parse_args(argv)
    report = run(args.device)
    report.write(args.out)
    v = report.values()
    return 0 if (v["placement_policy_never_worse"]
                 and v["placement_strict_win_presets"] >= 1) else 1


if __name__ == "__main__":
    raise SystemExit(main())
