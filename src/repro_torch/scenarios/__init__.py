"""Crash-injection scenarios — the port of ``repro.scenarios``.

Verifies the durable-linearizability claim at system scale: a real worker
process is killed (``os._exit``) at a point inside the commit window —
pre-flush, mid-flush (some shards durable, no manifest) or
post-completeOp — then restarted; the restarted process must recover the
newest completed commit and finish bit-identical to an uninterrupted run.

* ``repro_torch.scenarios.worker`` — the killable TRAINING worker (CLI);
* ``repro_torch.scenarios.serve_worker`` — the killable SERVING worker
  (one engine, or a fleet with migration kill points);
* ``repro_torch.scenarios.cluster_worker`` — the killable CLUSTER rank:
  one of N data-parallel processes over one shared pool;
* ``repro_torch.scenarios.cluster`` — kill 1 of N rank processes inside
  the commit window; the survivors shrink and must finish bit-identical
  to a planned shrink (``run_cluster_scenario`` / ``run_cluster_suite``);
* ``repro_torch.scenarios.runner`` — kill -> inspect -> restart ->
  compare, one scenario per kill point (CLI ``--suite
  train|serve|cluster|fuzz|all``; library ``run_scenario`` /
  ``run_suite`` / ``run_serve_scenario`` / ``run_serve_suite`` /
  ``run_fleet_suite``);
* ``repro_torch.scenarios.fuzz`` — the adversarial crash fuzzer
  (seeded kills, torn writes, stragglers) over the train / serve /
  cluster / scale workloads, held to one invariant by an independent
  oracle.

The scale suite (``repro.scenarios.scale``) is not ported (ROADMAP A6b).
Import the run functions from the submodules (they are not re-exported
here, so ``python -m`` entry points stay clean).
"""
from repro_torch.dsm.flit_runtime import KILL_POINTS

__all__ = ["KILL_POINTS"]
