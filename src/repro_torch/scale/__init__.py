"""Elastic scaling: synthetic traffic, the cost-priced autoscaler and its
fleet simulation, and the grow-by-repartition helpers — the port of
``repro.scale`` (host code).

* ``scale.traffic`` — deterministic diurnal x bursty session arrivals on
  ``serve/trace.py``'s pure-function contract;
* ``scale.autoscaler`` — a controller that prices "add / remove an
  engine" with the ``dsm/emu.py`` cost model through
  ``dsm/placement.py``, and the deterministic fleet simulation;
* ``scale.grow`` — which entries move to a joiner, and the join kill
  points (``JOIN_POINTS``).
"""
from repro_torch.scale.autoscaler import (Autoscaler, AutoscaleConfig,
                                          ScaleEvent, SimResult,
                                          simulate_autoscale, simulate_fixed)
from repro_torch.scale.grow import (JOIN_POINTS, join_moves, join_name,
                                    join_templates)
from repro_torch.scale.traffic import (TrafficConfig, arrival_counts,
                                       offered_tokens, traffic_trace)

__all__ = [
    "Autoscaler", "AutoscaleConfig", "ScaleEvent", "SimResult",
    "simulate_autoscale", "simulate_fixed",
    "JOIN_POINTS", "join_moves", "join_name", "join_templates",
    "TrafficConfig", "arrival_counts", "offered_tokens", "traffic_trace",
]
