"""The flash forward's serving launch, or the flash backward at the training
shape, against another version of its source, timed in turns on one card.

    git show <commit>:src/repro_torch/csrc/flash_attention.cu > build/fa_other.cu
    PYTHONPATH=src python -m repro_torch.kernels.attention.probe \\
        --against build/fa_other.cu
    git show <commit>:src/repro_torch/csrc/flash_attention_bwd.cu > build/fa_bwd_other.cu
    PYTHONPATH=src python -m repro_torch.kernels.attention.probe --bwd \\
        --against build/fa_bwd_other.cu

from the root of a checkout, on a machine with the card and ``nvcc``.  It
builds the other source into ``build/repro_torch/flash-probe/`` (with
``csrc/`` on the include path) and times both in turns (other, checkout,
checkout, other, three times): each a CUDA graph of 20 launches of the raw
C entry replayed 10 times between CUDA events, inputs in the 50 MB L2 as a
prefill's fresh q / k / v are.  It prints the medians of six, their ratio
and every sample.

* Forward (the default): the serving shape (1, 16, 512, 128) causal, the
  logsumexp pointer null (an earlier version's entry has none), and
  whether the two outputs are bit-identical.
* ``--bwd``: olmo-1b's training shape (8, 16, 512, 128) causal, then
  deepseek-v2's (8, 128 over 128, 512, hd 192, hd_v 128), on the
  checkout's forward output and logsumexp; each version's dq, dk, dv
  against the fp32 plain backward (max abs error over max|plain|, limit
  2e-2) — the two need not agree bit for bit, as the order of the sums
  differs — and each version's launches by name with their device times
  (CUDA profiler, the mean of 20 calls).  A version whose entry takes no
  hd_v (before the MLA widths) is called with its own arguments and
  timed at the first shape only; the checkout is timed alone at the
  second.  The scratch handed to both is large enough for either
  version's.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import kernel, ops

SHAPE = (1, 16, 512, 128)        # B, H, S, hd: olmo-1b's prefill
BWD_SHAPE = (8, 16, 512, 128, 128)  # B, H, S, hd, hd_v: olmo-1b's training
MLA_BWD_SHAPE = (8, 128, 512, 192, 128)  # deepseek-v2's step, (8, 512)
TOL = 2e-2


def _build_other(path: Path, lib_name: str) -> ctypes.CDLL:
    out = build.build_root() / "flash-probe" / lib_name
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc()] + build.NVCC_FLAGS
                   + ["-I", str(build.CSRC), "-o", str(out), str(path)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def _other_entry(path: Path):
    fn = _build_other(path, "libfa_other.so").repro_flash_attention_fwd_bf16
    with_lse = "float* lse" in path.read_text()
    fn.argtypes = ([ctypes.c_void_p] * (5 if with_lse else 4)
                   + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, with_lse


def _graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _in_turns(run_other, run_checkout) -> tuple:
    """Medians of six graph timings of each, in turns, and the samples."""
    times = {"other": [], "checkout": []}
    for _ in range(3):
        for name in ("other", "checkout", "checkout", "other"):
            times[name].append(_graph_ms(run_other if name == "other"
                                         else run_checkout))
    med = {n: statistics.median(t) for n, t in times.items()}
    return med, times


def launch_ms(fn, reps: int = 20) -> dict:
    """Device ms of each kernel ``fn`` launches, by name (CUDA profiler,
    the mean over ``reps`` calls after 3 warm-up calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            m = re.search(r"\w+_kernel(<[\d, ]+>)?", e.key)
            out[m.group() if m else e.key[:60]] = \
                e.self_device_time_total / e.count / 1e3
    return out


def _forward(against: Path) -> None:
    other, other_lse = _other_entry(against)
    B, H, S, hd = SHAPE
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn((B, S, H, 1, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    out = torch.empty_like(q)
    ref = torch.empty_like(q)
    strides = kernel._bhs(q) + kernel._bhs(k) + kernel._bhs(v) + \
        kernel._bhs(out)

    def run_other(o=ref):
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
        err = other(*ptrs, *([None] if other_lse else []), B, H, H, S, S,
                    hd, hd, *strides, hd ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def run_checkout():
        kernel.flash_attention_fwd(q, k, v, out, causal=True,
                                   scale=hd ** -0.5)

    run_other()
    run_checkout()
    torch.cuda.synchronize()
    same = torch.equal(out, ref)
    med, times = _in_turns(run_other, run_checkout)
    print(f"flash forward at {SHAPE} causal, logsumexp off: checkout "
          f"{med['checkout']:.5f} ms, {against} {med['other']:.5f} ms "
          f"(medians of 6 in turns; checkout/other "
          f"{med['checkout'] / med['other']:.3f}); outputs bit-identical: "
          f"{same}; samples {times}", flush=True)


def _bwd_entry(path: Path):
    """Another version's backward entry, and whether it takes hd_v and the
    four stride triples (since the MLA widths) or hd and two."""
    fn = _build_other(path, "libfa_bwd_other.so") \
        .repro_flash_attention_bwd_bf16
    sig = re.search(r"repro_flash_attention_bwd_bf16\((.*?)\)",
                    path.read_text(), re.S).group(1)
    new_sig = "hd_v" in sig
    fn.argtypes = (kernel._BWD_ARGTYPES if new_sig else
                   [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, new_sig


def _bwd_at(shape, other, other_new_sig: bool, against: Path) -> None:
    """One backward shape (B, H over H, S, hd, hd_v, causal): each
    version's errors, the two in turns where the other takes the widths
    (else the checkout alone, six graph timings), and each one's launches
    by name."""
    B, H, S, hd, hd_v = shape
    scale = hd ** -0.5
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(s, generator=g, device="cuda").bfloat16()
                     for s in ((B, S, H, 1, hd), (B, S, H, hd),
                               (B, S, H, hd_v), (B, S, H, 1, hd_v)))
    out = torch.empty_like(dout)
    lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
    kernel.flash_attention_fwd(q, k, v, out, causal=True, scale=scale,
                               lse=lse)
    # large enough for either version (the mma.sync one took B*H*S floats)
    rows = torch.empty(max(kernel.bwd_scratch_floats(B, H, S), B * H * S),
                       dtype=torch.float32, device="cuda")
    with_other = other_new_sig or hd == hd_v
    names = ("other", "checkout") if with_other else ("checkout",)
    grads = {n: [torch.empty_like(t) for t in (q, k, v)] for n in names}
    ptrs = lambda bufs: ([t.data_ptr() for t in (q, k, v, out, lse, dout)]
                         + [t.data_ptr() for t in bufs] + [rows.data_ptr()])
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run_other():
        widths = [hd, hd_v] if other_new_sig else [hd]
        strides = kernel._bhs(q) + kernel._bhs(k) + (
            kernel._bhs(v) + kernel._bhs(out) if other_new_sig else [])
        err = other(*ptrs(grads["other"]), B, H, H, S, S, *widths,
                    *strides, scale, 1, stream())
        assert err == 0, err

    def run_checkout():
        kernel.flash_attention_bwd(q, k, v, out, lse, dout,
                                   *grads["checkout"], causal=True,
                                   scale=scale)

    runs = {"other": run_other, "checkout": run_checkout}
    for n in names:
        runs[n]()
    torch.cuda.synchronize()
    want = ops.plain_attention_bwd(q, k, v, out, lse, dout, causal=True)
    errs = {}
    for name, got in grads.items():
        errs[name] = {n: float((a.float() - w).abs().max() / w.abs().max())
                      for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        assert all(e <= TOL for e in errs[name].values()), (name, errs)
    label = f"flash backward at {shape} causal"
    if with_other:
        same = all(torch.equal(a, b) for a, b in zip(*grads.values()))
        med, times = _in_turns(run_other, run_checkout)
        print(f"{label}: checkout {med['checkout']:.5f} ms, {against} "
              f"{med['other']:.5f} ms (medians of 6 in turns; "
              f"checkout/other {med['checkout'] / med['other']:.3f}); "
              f"err/max|plain| checkout {errs['checkout']}, other "
              f"{errs['other']} (limit {TOL}); bit-identical to each "
              f"other: {same}; samples {times}", flush=True)
    else:
        times = [_graph_ms(run_checkout) for _ in range(6)]
        print(f"{label}: checkout {statistics.median(times):.5f} ms "
              f"(median of 6; {against} does not take hd_v {hd_v} under hd "
              f"{hd}); err/max|plain| {errs['checkout']} (limit {TOL}); "
              f"samples {times}", flush=True)
    for name in names:
        per = launch_ms(runs[name])
        print(f"flash backward {name} at {shape} launches (device ms each, "
              f"profiler): " + ", ".join(f"{k} {ms:.5f}"
                                         for k, ms in per.items())
              + f"; sum {sum(per.values()):.5f}", flush=True)


def _backward(against: Path) -> None:
    other, new_sig = _bwd_entry(against)
    for shape in (BWD_SHAPE, MLA_BWD_SHAPE):
        _bwd_at(shape, other, new_sig, against)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="another version of csrc/flash_attention.cu, or "
                         "with --bwd of csrc/flash_attention_bwd.cu")
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward at the training shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    (_backward if args.bwd else _forward)(args.against)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
