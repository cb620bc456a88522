"""The flash forward's serving launch against another version of its source,
timed in turns on one card.

    git show <commit>:src/repro_torch/csrc/flash_attention.cu > build/fa_other.cu
    PYTHONPATH=src python -m repro_torch.kernels.attention.probe \\
        --against build/fa_other.cu

from the root of a checkout, on a machine with the card and ``nvcc``.  It
builds the other source into ``build/repro_torch/flash-probe/`` (its C
entry with or without the logsumexp pointer: an earlier version has none)
and times both at the serving shape (1, 16, 512, 128) causal, the
logsumexp pointer null, in turns (other, checkout, checkout, other, three
times): each a CUDA graph of 20 launches replayed 10 times between CUDA
events, inputs in the 50 MB L2 as a prefill's fresh q / k / v are.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention import kernel

SHAPE = (1, 16, 512, 128)        # B, H, S, hd: olmo-1b's prefill


def _other_entry(path: Path):
    out = build.build_root() / "flash-probe" / "libfa_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc()] + build.NVCC_FLAGS + ["-o", str(out),
                                                        str(path)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).repro_flash_attention_fwd_bf16
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="another version of csrc/flash_attention.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other, other_lse = _other_entry(args.against)
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
    times = {"other": [], "checkout": []}
    for _ in range(3):
        for name in ("other", "checkout", "checkout", "other"):
            times[name].append(_graph_ms(run_other if name == "other"
                                         else run_checkout))
    med = {n: statistics.median(t) for n, t in times.items()}
    print(f"flash forward at {SHAPE} causal, logsumexp off: checkout "
          f"{med['checkout']:.5f} ms, {args.against} {med['other']:.5f} ms "
          f"(medians of 6 in turns; checkout/other "
          f"{med['checkout'] / med['other']:.3f}); outputs bit-identical: "
          f"{same}; samples {times}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
