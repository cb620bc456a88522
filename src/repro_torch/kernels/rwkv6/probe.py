"""Where the WKV-6 kernel's time goes on the card: per-launch device times
of each of its kernels at the rwkv6-7b path's two shapes, and at the
prefill, the same for copies of ``csrc/wkv6.cu`` with one kind of work
taken out (timing only: their outputs are wrong).

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6.probe

from the root of a checkout, on a machine with the card and ``nvcc``.
Copies: "no_lo" drops the products of the split operands' low parts,
"no_mma" every mma.sync product, "no_exp" replaces each exponential by
its argument, "no_pdl" launches the three passes one after another
instead of for programmatic dependent launch.  The variant sources and
libraries go to ``build/repro_torch/wkv6-probe/``.  Per kernel: CUDA
profiler device times, the mean of 20 back-to-back calls after 3 warm-up
calls (under programmatic dependent launch a pass's time includes its
wait for the one before); per call: device time of 20 calls captured in
a CUDA graph and replayed 10 times.  Inputs stay in the 50 MB L2 between
calls.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6 import kernel

SHAPES = {"prefill": (1, 512, 64, 64), "decode": (4, 1, 64, 64)}


def _no_lo(src: str) -> str:
    return "\n".join(
        "if (0) " + line.strip() if "mma(" in line and (
            "alo," in line or " lo," in line or "b0l, b1l" in line)
        else line for line in src.splitlines())


def _no_mma(src: str) -> str:
    return src.replace('  asm volatile(\n      "mma.sync',
                       '  if (0) asm volatile(\n      "mma.sync')


def _no_exp(src: str) -> str:
    return src.replace("__expf(", "probe_exp_(").replace(
        "namespace {", "namespace {\n__device__ __forceinline__ float "
        "probe_exp_(float x) { return x; }", 1)


def _no_pdl(src: str) -> str:
    return src.replace("programmaticStreamSerializationAllowed = 1;",
                       "programmaticStreamSerializationAllowed = 0;")


VARIANTS = {"no_lo": _no_lo, "no_mma": _no_mma, "no_exp": _no_exp,
            "no_pdl": _no_pdl}


def _variant_libs() -> dict:
    out = build.build_root() / "wkv6-probe"
    out.mkdir(parents=True, exist_ok=True)
    src = build.source("wkv6").read_text()
    procs = {}
    for name, edit in VARIANTS.items():
        cu = out / f"wkv6_{name}.cu"
        cu.write_text(edit(src))
        procs[name] = subprocess.Popen(
            [build.nvcc()] + build.NVCC_FLAGS + ["-o", str(out / f"{name}.so"),
                                                 str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"probe variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.repro_wkv6_fwd_chunked.argtypes = [ctypes.c_void_p] * 9 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def _per_kernel_us(fn) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("wkv6_")[1].split("<")[0]:
            round(e.self_device_time_total / e.count, 2)
            for e in prof.key_averages() if "wkv6_" in e.key}


def _call_us(fn, reps: int = 20, replays: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
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
    return round(start.elapsed_time(end) * 1e3 / (reps * replays), 2)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = {"kernel": kernel.library(), **_variant_libs()}
    g = torch.Generator("cuda").manual_seed(3)
    for shape_name, (B, T, H, n) in SHAPES.items():
        def rn(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        r, k, v = (rn(B, T, H, n).bfloat16() for _ in range(3))
        logw, u, S0 = -torch.exp(rn(B, T, H, n) * 0.5), rn(H, n) * 0.3, \
            rn(B, H, n, n) * 0.1
        y, S = torch.empty(r.shape, device="cuda"), torch.empty_like(S0)
        def base():
            kernel.wkv6_fwd(r, k, v, logw, u, S0, y, S)
        print(f"{shape_name} {(B, T, H, n)} kernel: {_call_us(base)} us a call, "
              f"{_per_kernel_us(base)}", flush=True)
        if T < kernel.CHUNKED_MIN_T:
            continue
        scratch = torch.empty(libs["kernel"].repro_wkv6_scratch_bytes(B, T, H, n),
                              dtype=torch.uint8, device="cuda")
        for name in VARIANTS:
            def call(lib=libs[name]):
                lib.repro_wkv6_fwd_chunked(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                    u.data_ptr(), S0.data_ptr(), y.data_ptr(), S.data_ptr(),
                    scratch.data_ptr(), B, T, H, n,
                    torch.cuda.current_stream().cuda_stream)
            print(f"{shape_name} {(B, T, H, n)} {name}: {_call_us(call)} us a "
                  f"call, {_per_kernel_us(call)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
