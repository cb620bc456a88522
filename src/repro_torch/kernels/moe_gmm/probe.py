"""The grouped matmul's dx and dw kernels against another version of their
source, timed in turns on one card, and the forward's bits under both.

    git show <commit>:src/repro_torch/csrc/grouped_matmul.cu > build/gmm_other.cu
    PYTHONPATH=src python -m repro_torch.kernels.moe_gmm.probe \\
        --against build/gmm_other.cu

from the root of a checkout, on a machine with the card and ``nvcc``.  It
builds the other source into ``build/repro_torch/gmm-probe/`` (with
``csrc/`` on the include path) and then:

* at olmoe-1b-7b's two training shapes (E 64, C 640, D / F 2048 / 1024
  and back), times dx = dy w^T and dw = x^T dy of both versions in turns
  (other, checkout, checkout, other, three times): each a CUDA graph of 20
  launches of the raw C entry replayed 10 times between CUDA events.  It
  prints the medians of six, their ratio and every sample, each version's
  error against the fp32 plain backward (max abs error over max|plain|,
  limit 1e-2), and whether the two versions agree bit for bit;
* runs the forward at every forward shape of ``chip_smoke.py``'s phase 3
  under both versions and prints whether the outputs are bit-identical.

``--step`` (without ``--against``, or beside it) profiles one training step
of olmoe-1b-7b at phase 17's depth and batch (2 layers, (8, 512)) after two
warm-up steps, with the CUDA profiler: the step's device time, its top
operations by device time and the grouped matmul's share (forward, dx and
dw kernels).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.probe import _in_turns
from repro_torch.kernels.moe_gmm import kernel
from repro_torch.kernels.moe_gmm.ref import (grouped_matmul_dw_ref,
                                             grouped_matmul_dx_ref)

#: olmoe-1b-7b's expert products at its training capacity (8 x 512 tokens,
#: top-8 of 64 experts, capacity factor 1.25 -> C 640)
TRAIN_SHAPES = {"train_up": (64, 640, 2048, 1024),
                "train_down": (64, 640, 1024, 2048)}
#: phase 3's forward shapes (E, C, D, F): olmoe's, jamba-1.5-large's and
#: deepseek-v2's serving products, the training ones and the ragged ones
FWD_SHAPES = [(64, 80, 2048, 1024), (64, 80, 1024, 2048),
              (64, 32, 2048, 1024), (64, 32, 1024, 2048),
              (16, 80, 8192, 24576), (16, 80, 24576, 8192),
              (16, 32, 8192, 24576), (16, 32, 24576, 8192),
              (160, 24, 5120, 1536), (160, 24, 1536, 5120),
              (160, 32, 5120, 1536), (160, 32, 1536, 5120),
              (64, 640, 2048, 1024), (64, 640, 1024, 2048),
              (3, 37, 200, 72), (3, 1, 200, 72), (8, 48, 1000, 256),
              (4, 300, 512, 200)]
TOL = 1e-2
ENTRIES = ("repro_grouped_matmul_bf16", "repro_grouped_matmul_dx_bf16",
           "repro_grouped_matmul_dw_bf16")


def _build_other(path: Path) -> ctypes.CDLL:
    out = build.build_root() / "gmm-probe" / "libgmm_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc()] + build.NVCC_FLAGS
                   + ["-I", str(build.CSRC), "-o", str(out), str(path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name in ENTRIES:
        getattr(lib, name).argtypes = kernel._ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _call(fn, a, b, out, E, C, D, F) -> None:
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), E, C, D, F,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, err


def _backward(other: ctypes.CDLL, against: Path) -> None:
    mine = kernel.library()
    gen = torch.Generator("cuda").manual_seed(29)
    for name, (E, C, D, F) in TRAIN_SHAPES.items():
        x = torch.randn((E, C, D), generator=gen, device="cuda").bfloat16()
        w = torch.randn((E, D, F), generator=gen, device="cuda").mul_(
            0.02).bfloat16()
        dy = torch.randn((E, C, F), generator=gen, device="cuda").bfloat16()
        x[:, -37:] = 0      # capacity rows that hold no token
        dy[:, -37:] = 0
        for what, entry, a, b, like, want in (
                ("dx", "repro_grouped_matmul_dx_bf16", dy, w, x,
                 grouped_matmul_dx_ref(w.float(), dy.float())),
                ("dw", "repro_grouped_matmul_dw_bf16", x, dy, w,
                 grouped_matmul_dw_ref(x.float(), dy.float()))):
            outs = {"other": torch.empty_like(like),
                    "checkout": torch.empty_like(like)}
            fns = {"other": getattr(other, entry),
                   "checkout": getattr(mine, entry)}

            def run(v, a=a, b=b, outs=outs, fns=fns):
                _call(fns[v], a, b, outs[v], E, C, D, F)

            run("other")
            run("checkout")
            torch.cuda.synchronize()
            config = kernel.last_launch()
            errs = {v: float((o.float() - want).abs().max()
                             / want.abs().max()) for v, o in outs.items()}
            assert all(e <= TOL for e in errs.values()), (name, what, errs)
            same = torch.equal(outs["other"], outs["checkout"])
            med, times = _in_turns(lambda: run("other"),
                                   lambda: run("checkout"))
            print(f"grouped matmul {what} {name} E C D F {[E, C, D, F]}: "
                  f"checkout {med['checkout']:.5f} ms, {against} "
                  f"{med['other']:.5f} ms (medians of 6 in turns; "
                  f"checkout/other {med['checkout'] / med['other']:.3f}); "
                  f"err/max|plain| checkout {errs['checkout']:.3e}, other "
                  f"{errs['other']:.3e} (limit {TOL}); bit-identical to "
                  f"each other: {same}; checkout launch {config}; samples "
                  f"{times}", flush=True)
            del outs, want
        del x, w, dy


def _forward(other: ctypes.CDLL) -> None:
    mine = kernel.library()
    gen = torch.Generator("cuda").manual_seed(30)
    same_all = True
    for E, C, D, F in FWD_SHAPES:
        x = torch.randn((E, C, D), generator=gen, device="cuda").bfloat16()
        w = torch.empty((E, D, F), dtype=torch.bfloat16, device="cuda")
        for e in range(E):      # one expert at a time: jamba's w is 6.4 GB
            w[e] = torch.randn((D, F), generator=gen, device="cuda").mul_(
                0.02)
        outs = [torch.empty((E, C, F), dtype=torch.bfloat16, device="cuda")
                for _ in range(2)]
        for lib, out in zip((other, mine), outs):
            _call(lib.repro_grouped_matmul_bf16, x, w, out, E, C, D, F)
        torch.cuda.synchronize()
        same = torch.equal(*outs)
        same_all &= same
        print(f"grouped matmul forward E C D F {[E, C, D, F]}: outputs "
              f"bit-identical under both sources: {same}", flush=True)
        del x, w, outs
    print(f"grouped matmul forward: bit-identical at all "
          f"{len(FWD_SHAPES)} shapes: {same_all}", flush=True)


#: phase 17's olmoe-1b-7b: depth cut to 2 layers, batch (8, 512)
STEP_LAYERS, STEP_BATCH, STEP_SEQ = 2, 8, 512


def step_profile(arch: str, layers: int, kernels: str, what: str,
                 batch: int = STEP_BATCH, seq: int = STEP_SEQ,
                 top: int = 12) -> None:
    """Profile one training step of ``arch`` cut to ``layers`` layers at
    (``batch``, ``seq``) after two warm-up steps, with the CUDA profiler:
    print the step's device time, the share of the kernels whose names
    match the regex ``kernels`` (called ``what``) and the ``top``
    operations by device time."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMSource
    from repro_torch.launch.serve import set_determinism
    from repro_torch.models.registry import build as build_model
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    set_determinism()
    cfg = get_config(arch).with_(n_layers=layers)
    bundle = build_model(cfg, device="cuda")
    state = init_train_state(
        bundle.init_params(torch.Generator("cuda").manual_seed(0)), 0,
        cfg.moment_dtype)
    step = make_train_step(bundle)
    pipe = DataPipeline(SyntheticLMSource(cfg.vocab_size), batch, seq)

    def next_batch():
        return {k: torch.from_numpy(np.asarray(v)).cuda()
                for k, v in pipe.next_global().items()}

    for _ in range(2):
        state, _ = step(state, next_batch())
    b = next_batch()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    mine = sum(e.self_device_time_total for e in rows
               if re.search(kernels, e.key)) / 1e3
    print(f"{arch} train step ({layers} layers, ({batch}, {seq})), "
          f"profiled: loss {float(metrics['loss']):.6f}; device "
          f"{total:.3f} ms over {host_ms:.3f} host ms; {what} {mine:.3f} "
          f"ms ({100 * mine / total:.1f}%)", flush=True)
    for e in rows[:top]:
        name = re.sub(r"^void |at::native::|\(anonymous namespace\)::", "",
                      e.key)[:120]
        ms = e.self_device_time_total / 1e3
        print(f"  {name}: {e.count} launches, {ms:.3f} ms "
              f"({100 * ms / total:.1f}%)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path,
                    help="another version of csrc/grouped_matmul.cu")
    ap.add_argument("--step", action="store_true",
                    help="profile one olmoe-1b-7b training step")
    args = ap.parse_args(argv)
    if args.against is None and not args.step:
        ap.error("give --against, --step or both")
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.against is not None:
        other = _build_other(args.against)
        _backward(other, args.against)
        _forward(other)
    if args.step:
        step_profile("olmoe-1b-7b", STEP_LAYERS, r"gmm_(bf16|bwd)_kernel",
                     "grouped matmul kernels")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
