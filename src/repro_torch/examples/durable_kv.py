"""A durably linearizable KV store over the real DSM runtime — the port
of ``examples/durable_kv.py``, on ``repro_torch``'s synchronous schedule
(the reference relies on its "auto" default).  The §6 story told with the
unified API (`open_cxl0`), two ways:

* **commit regions** — puts are LStored and batches commit atomically:
  `with ctx.commit(step) as txn: txn.store(...)`.  A crash ANYWHERE
  inside a region emits no completeOp, so recovery lands exactly on the
  previous commit: the torn batch is invisible, never a mixed state.

* **the §6 transformation** — `ctx.transform(KVSpec(n))` wraps the same
  linearizable KV object with FliT-for-CXL0 at op granularity (per-op
  LStore + RFlush + completeOp): EVERY acknowledged put survives, even
  the ones a batch discipline would have lost in its torn tail — the
  paper's durable-linearizability upgrade as a reusable API.

Run:  PYTHONPATH=src python -m repro_torch.examples.durable_kv
"""
import shutil
import tempfile

import numpy as np

from repro_torch.core.objects import KVSpec
from repro_torch.dsm.api import open_cxl0
from repro_torch.dsm.recovery import CrashError

N_KEYS = 4


def kv_templates():
    return {f"kv/k{k}": np.zeros((), np.int64) for k in range(N_KEYS)}


def run_commit_regions(path):
    """Batch-committed KV writer that dies mid-batch."""
    ctx = open_cxl0(path, schedule="sync")
    acked = {}
    try:
        for step in range(3):
            with ctx.commit(step) as txn:
                for k in range(N_KEYS):
                    v = 10 * step + k
                    txn.store(f"kv/k{k}", np.int64(v))
                    acked[f"kv/k{k}"] = v
                    if step == 2 and k == 1:
                        raise CrashError("power loss mid-batch")
    except CrashError:
        pass
    ctx.crash()                        # volatile tiers vanish

    # a fresh incarnation: ONE recovery path, newest completed commit
    ctx2 = open_cxl0(path, schedule="sync")
    objs, step, source = ctx2.recover(kv_templates())
    recovered = {n: int(v) for n, v in objs.items()}
    return acked, recovered, step, source


def run_transformed(path):
    """The same workload through the §6-transformed KV object."""
    ctx = open_cxl0(path, schedule="sync")
    kv = ctx.transform(KVSpec(N_KEYS), name="kv6")
    acked = {}
    try:
        for step in range(3):
            for k in range(N_KEYS):
                v = 10 * step + k
                kv.op("put", k, v)     # LStore + RFlush + completeOp
                acked[k] = v
                if step == 2 and k == 1:
                    raise CrashError("power loss mid-batch")
    except CrashError:
        pass
    ctx.crash()

    kv2 = open_cxl0(path, schedule="sync").transform(KVSpec(N_KEYS),
                                                     name="kv6")
    recovered = {k: kv2.state[k] for k in range(N_KEYS)}
    return acked, recovered, kv2.ops_done


def main():
    tmp = tempfile.mkdtemp(prefix="durable_kv_")
    try:
        print("--- commit regions: batches are atomic, torn tail invisible")
        acked, rec, step, source = run_commit_regions(f"{tmp}/regions")
        print(f"    acked before the crash: {acked}")
        print(f"    recovered (commit step {step}, source={source}): {rec}")
        lost = {n for n, v in acked.items() if rec[n] != v}
        print(f"    the torn batch rolled back atomically: lost={sorted(lost)}")
        assert all(int(v) == 10 + int(n[-1]) for n, v in rec.items())

        print("--- §6 transform: every acknowledged put survives")
        acked6, rec6, ops = run_transformed(f"{tmp}/transform")
        print(f"    acked before the crash: {acked6}")
        print(f"    recovered after {ops + 1} completed ops: {rec6}")
        assert rec6 == acked6, (rec6, acked6)
        print("    durably linearizable: recovered state == acknowledged "
              "history")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
