"""Latency model (paper Fig. 5) and CXL transaction mapping (Table 1).

The paper measures CXL0 primitives on a real x86 CPU + FPGA pair over
CXL 1.1.  Exact nanosecond values are read off a bar chart, so this module
stores a *calibrated* table: absolute numbers are representative of
published CXL 1.1 measurements, and the paper's stated ratios hold exactly:

* host: local Read/MStore 2.34x faster than to HDM (remote);
* device: local (device-bias HDM) 1.94x faster than to HM (remote);
* device→HM: MStore = 1.45x RStore; RStore = 2.08x LStore;
* RFlush latency ≈ MStore latency (both reach physical memory);
* host and device remote accesses have approximately equal latency.
* in ``repro_torch`` too these ns are the paper's CXL measurements, the
  model's data: no number of ``repro_torch.core.latency`` is an H100 time.

``trace_cost`` prices a trace of CXL0 primitives — used by the FliT
benchmark (Alg. 2's LStore+RFlush vs. the MStore-everything strawman) and
by the DSM runtime's tier cost model.

Table 1 is encoded verbatim: the many-to-one mapping from CXL.cache /
CXL.mem transactions to CXL0 primitives, including the primitives that are
*unavailable* ("???" in the paper) on current hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

HOST, DEVICE = "host", "device"
HM, HDM = "HM", "HDM"          # Host-attached Memory / Host-managed Device Mem

# ---------------------------------------------------------------------------
# Fig. 5 — latency (ns) per (node, primitive, target-locality)
# target is "local" or "remote" from the issuing node's perspective:
#   host:   local = HM,  remote = HDM
#   device: local = HDM (device-bias), remote = HM
# ---------------------------------------------------------------------------

_R_HOST = 2.34      # host remote/local ratio (Read, MStore)
_R_DEV = 1.94       # device remote/local ratio
_R_RS_LS = 2.08     # device→HM: RStore vs LStore
_R_MS_RS = 1.45     # device→HM: MStore vs RStore

#: ns. Base calibration points (order-of-magnitude from CXL 1.1 literature).
LATENCY_NS: Dict[Tuple[str, str, str], float] = {}


def _build():
    host_read_local = 105.0           # DRAM load
    host_read_remote = host_read_local * _R_HOST
    dev_read_local = 201.0            # device-bias HDM
    dev_read_remote = dev_read_local * _R_DEV

    # host rows -------------------------------------------------------------
    LATENCY_NS[(HOST, "load", "local")] = host_read_local
    LATENCY_NS[(HOST, "load", "remote")] = host_read_remote
    # LStore retires into the store buffer: fast and locality-independent
    LATENCY_NS[(HOST, "lstore", "local")] = 12.0
    LATENCY_NS[(HOST, "lstore", "remote")] = 12.0
    LATENCY_NS[(HOST, "mstore", "local")] = 125.0
    LATENCY_NS[(HOST, "mstore", "remote")] = 125.0 * _R_HOST
    # RFlush ≈ MStore (paper §5.2)
    LATENCY_NS[(HOST, "rflush", "local")] = LATENCY_NS[(HOST, "mstore", "local")]
    LATENCY_NS[(HOST, "rflush", "remote")] = LATENCY_NS[(HOST, "mstore", "remote")]

    # device rows ------------------------------------------------------------
    LATENCY_NS[(DEVICE, "load", "local")] = dev_read_local
    LATENCY_NS[(DEVICE, "load", "remote")] = dev_read_remote
    # device LStore: single cache level, no write buffer; the cache used for
    # HM targets is slower than the HDM one (two separate caches in the IP)
    dev_lstore_remote = 90.0           # to HM (green bar — slower)
    LATENCY_NS[(DEVICE, "lstore", "local")] = 62.0
    LATENCY_NS[(DEVICE, "lstore", "remote")] = dev_lstore_remote
    dev_rstore_remote = dev_lstore_remote * _R_RS_LS
    LATENCY_NS[(DEVICE, "rstore", "remote")] = dev_rstore_remote
    LATENCY_NS[(DEVICE, "rstore", "local")] = LATENCY_NS[(DEVICE, "lstore", "local")]
    LATENCY_NS[(DEVICE, "mstore", "remote")] = dev_rstore_remote * _R_MS_RS
    LATENCY_NS[(DEVICE, "mstore", "local")] = (
        LATENCY_NS[(DEVICE, "mstore", "remote")] / _R_DEV)
    LATENCY_NS[(DEVICE, "rflush", "remote")] = LATENCY_NS[(DEVICE, "mstore", "remote")]
    LATENCY_NS[(DEVICE, "rflush", "local")] = LATENCY_NS[(DEVICE, "mstore", "local")]


_build()

#: RMW ≈ load + store on an EXCLUSIVE line (paper §3.3); approximated as the
#: sum of the load and the flavored store.
def rmw_latency(node: str, flavor: str, locality: str) -> float:
    store = {"l": "lstore", "r": "rstore", "m": "mstore"}[flavor]
    key = (node, store, locality)
    if key not in LATENCY_NS:           # host RStore unavailable — price as M
        key = (node, "mstore", locality)
    return LATENCY_NS[(node, "load", locality)] + LATENCY_NS[key]


def primitive_latency(node: str, prim: str, locality: str,
                      flavor: str = "l") -> float:
    if prim in ("faa", "cas", "rmw"):
        return rmw_latency(node, flavor, locality)
    if prim == "lflush":
        # evict to the next level: priced like a local store-and-forward
        return LATENCY_NS[(node, "lstore", locality)] * 2.0
    key = (node, prim, locality)
    if key not in LATENCY_NS:
        raise KeyError(f"primitive {prim} unavailable on {node} ({locality})")
    return LATENCY_NS[key]


def trace_cost(trace: Sequence[Tuple[str, str, str]],
               flavors: Optional[Sequence[str]] = None) -> float:
    """Σ latency over (node, primitive, locality) records, in ns."""
    total = 0.0
    for i, (node, prim, locality) in enumerate(trace):
        fl = flavors[i] if flavors else "l"
        total += primitive_latency(node, prim, locality, fl)
    return total


# ---------------------------------------------------------------------------
# Table 1 — CXL transactions observable per CXL0 primitive
# ---------------------------------------------------------------------------

UNAVAILABLE = "???"


@dataclasses.dataclass(frozen=True)
class MappingRow:
    primitive: str
    node: str
    operation: str                   # ISA / device operation that triggers it
    to_hm: Tuple[str, ...]           # CXL transactions targeting HM
    to_hdm: Tuple[str, ...]          # CXL transactions targeting HDM (host bias)

    @property
    def available(self) -> bool:
        return self.operation != UNAVAILABLE


TABLE1: Tuple[MappingRow, ...] = (
    # --- host rows (x86 instructions; CXL.cache H2D / CXL.mem M2S) ---------
    MappingRow("load", HOST, "Load", ("None", "SnpInv"), ("None", "MemRdData")),
    MappingRow("lstore", HOST, "Store", ("None", "SnpInv"),
               ("None", "MemRdData", "MemRd")),
    MappingRow("rstore", HOST, UNAVAILABLE, (UNAVAILABLE,), (UNAVAILABLE,)),
    MappingRow("mstore", HOST, "Non-Temporal Store + Fence", ("SnpInv",),
               ("MemWr",)),
    MappingRow("lflush", HOST, UNAVAILABLE, (UNAVAILABLE,), (UNAVAILABLE,)),
    MappingRow("rflush", HOST, "CLFlush", ("None", "SnpInv"),
               ("None", "MemInv", "MemWr")),
    # --- device rows (CXL.cache D2H / CXL.cache & CXL.mem) ------------------
    MappingRow("load", DEVICE, "Caching Read", ("None", "RdShared"),
               ("None", "RdShared")),
    MappingRow("lstore", DEVICE, "Caching Write", ("None", "RdOwn"),
               ("None", "RdOwn")),
    MappingRow("rstore", DEVICE, "HM: ItoMWr / HDM: Caching Write",
               ("ItoMWr",), ("None", "RdOwn")),
    MappingRow("mstore", DEVICE, "Caching Write + CLFlush",
               ("(RdOwn +) DirtyEvict", "WOWrInv/F", "WrInv"),
               ("None", "MemRd")),
    MappingRow("lflush", DEVICE, UNAVAILABLE, (UNAVAILABLE,), (UNAVAILABLE,)),
    MappingRow("rflush", DEVICE, "CLFlush", ("CleanEvict", "DirtyEvict"),
               ("None", "MemRd")),
)


def table1_row(primitive: str, node: str) -> MappingRow:
    for r in TABLE1:
        if r.primitive == primitive and r.node == node:
            return r
    raise KeyError((primitive, node))


def available_primitives(node: str) -> List[str]:
    return [r.primitive for r in TABLE1 if r.node == node and r.available]


#: §4 — which CXL0 primitives each *system configuration* admits
CONFIG_PRIMITIVES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "host_device_pair": {
        HOST: ("load", "lstore", "mstore", "rflush", "gpf", "l-rmw"),
        DEVICE: ("load", "lstore", "rstore", "mstore", "rflush", "l-rmw"),
    },
    "partitioned_pool": {
        HOST: ("load", "lstore", "mstore", "lflush", "rflush", "gpf",
               "l-rmw", "m-rmw"),
    },
    "shared_pool_coherent": {
        HOST: ("load", "lstore", "mstore", "rflush", "gpf", "l-rmw",
               "m-rmw"),
    },
    # non-coherent realistic pool: cache-bypassing subset only (§4)
    "shared_pool_noncoherent": {
        HOST: ("load_m", "mstore", "m-rmw"),
    },
}
