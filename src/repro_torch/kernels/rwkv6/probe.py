"""Where the WKV-6 kernels' time goes on the card.

    PYTHONPATH=src python -m repro_torch.kernels.rwkv6.probe
    git show <commit>:src/repro_torch/csrc/wkv6_bwd.cu > build/wkv6_bwd_other.cu
    git show <commit>:src/repro_torch/csrc/wkv6.cu > build/wkv6_other.cu
    PYTHONPATH=src python -m repro_torch.kernels.rwkv6.probe --bwd \\
        --against build/wkv6_bwd_other.cu --fwd-against build/wkv6_other.cu \\
        --step

from the root of a checkout, on a machine with the card and ``nvcc``.  The
other sources build into ``build/repro_torch/wkv6-probe/`` with ``csrc/``
on the include path.

Without options: per-launch device times of each of the forward's kernels
at the rwkv6-7b path's two shapes, and at the prefill the same for copies
of ``csrc/wkv6.cu`` with one kind of work taken out (timing only: their
outputs are wrong): "no_lo" drops the products of the split operands' low
parts, "no_mma" every mma.sync product, "no_exp" replaces each exponential
by its argument, "no_pdl" launches the three passes one after another
instead of for programmatic dependent launch.  Per kernel: CUDA profiler
device times, the mean of 20 back-to-back calls after 3 warm-up calls
(under programmatic dependent launch a pass's time includes its wait for
the one before); per call: device time of 20 calls captured in a CUDA
graph and replayed 10 times.  Inputs stay in the 50 MB L2 between calls.

``--bwd``: the backward at the rwkv6-7b training shape (8, 512, 64, 64)
and phase 18 (a)'s (1, 64, 64, 64): each pass's device time, under
programmatic dependent launch and, from a copy of the source built without
it, alone; with ``--against``, the checkout's and the other source's
backward timed in turns (other, checkout, checkout, other, three times,
each a CUDA graph of 20 calls replayed 10 times between CUDA events; the
medians of six and their ratio) and both versions' errors against the
plain backward ``wkv6_bwd_ref`` (max abs error over max|plain| of each
gradient, beside ``chip_smoke.py``'s limits).

``--fwd-against``: the forward at ``chip_smoke.py`` phase 3's forward shapes
under the checkout and the other ``csrc/wkv6.cu``, and whether y and the
final state are bit-identical.

``--step``: one rwkv6-7b training step at phase 18's depth and batch (2
layers, (8, 512)) after two warm-up steps, under the CUDA profiler: the
step's device time and the WKV-6 backward's share.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.probe import _in_turns, launch_ms
from repro_torch.kernels.moe_gmm.probe import step_profile
from repro_torch.kernels.rwkv6 import kernel
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref

SHAPES = {"prefill": (1, 512, 64, 64), "decode": (4, 1, 64, 64)}
BWD_SHAPES = {"train": (8, 512, 64, 64), "train_a": (1, 64, 64, 64)}
#: chip_smoke.py phase 3's forward cases (B, T, H, n, log decay)
FWD_SHAPES = [(1, 512, 64, 64, None), (4, 1, 64, 64, None),
              (2, 37, 8, 64, None), (2, 128, 2, 32, None),
              (1, 96, 4, 64, None), (2, 100, 2, 16, None),
              (1, 33, 1, 64, None), (1, 63, 4, 64, None),
              (1, 64, 4, 64, None), (2, 65, 3, 32, None),
              (1, 129, 2, 16, None), (1, 2048, 8, 64, None),
              (5, 300, 3, 32, None), (4, 1, 8, 64, "strong"),
              (2, 200, 4, 64, "strong"), (1, 40, 4, 64, "weak"),
              (1, 2048, 8, 64, "weak")]
#: chip_smoke.py's limits on the backward (x max|plain|)
BWD_TOL = {"dr": 1e-2, "dk": 1e-2, "dv": 1e-2, "dlogw": 1e-3, "du": 1e-3}
PROBE_DIR = "wkv6-probe"
#: phase 18's rwkv6-7b
STEP_LAYERS = 2


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


def _build_sources(sources: dict) -> dict:
    """Build each {name: source text} into its own library at once (the
    helpers of ``csrc/`` on the include path) and load them."""
    out = build.build_root() / PROBE_DIR
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc()] + build.NVCC_FLAGS
            + ["-I", str(build.CSRC), "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"probe source {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def _fwd_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.repro_wkv6_fwd.argtypes = kernel._ARGTYPES
    lib.repro_wkv6_fwd_chunked.argtypes = kernel._CHUNKED_ARGTYPES
    lib.repro_wkv6_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_wkv6_scratch_bytes.restype = ctypes.c_longlong
    lib.repro_wkv6_chunked_min_t.restype = ctypes.c_int
    return lib


def _per_kernel_us(fn) -> dict:
    return {name.split("wkv6_")[-1].split("<")[0]: round(ms * 1e3, 2)
            for name, ms in launch_ms(fn).items() if "wkv6_" in name}


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


def _inputs(B, T, H, n, gen, decay=None):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, v = rn(B, T, H, n).bfloat16(), rn(B, T, H, n).bfloat16()
    k = (rn(B, T, H, n) * 0.5).bfloat16()
    if decay is None:
        logw = -torch.exp(rn(B, T, H, n) * 0.5)
    else:
        lo, hi = {"strong": (1.0, 3.0), "weak": (-9.0, -7.0)}[decay]
        logw = -torch.exp(lo + (hi - lo) * torch.rand(
            (B, T, H, n), generator=gen, device="cuda"))
    return r, k, v, logw, rn(H, n) * 0.3


def _forward() -> None:
    # the shared helpers inlined, so that the edits reach the products
    header = '#include "wkv6_common.cuh"'
    src = build.source("wkv6").read_text().replace(
        header, (build.CSRC / "wkv6_common.cuh").read_text())
    libs = {name: _fwd_lib(lib) for name, lib in _build_sources(
        {f"wkv6_{name}": edit(src) for name, edit in VARIANTS.items()}).items()}
    g = torch.Generator("cuda").manual_seed(3)
    for shape_name, (B, T, H, n) in SHAPES.items():
        r, k, v = (torch.randn((B, T, H, n), generator=g, device="cuda")
                   .bfloat16() for _ in range(3))
        logw = -torch.exp(torch.randn((B, T, H, n), generator=g,
                                      device="cuda") * 0.5)
        u = torch.randn((H, n), generator=g, device="cuda") * 0.3
        S0 = torch.randn((B, H, n, n), generator=g, device="cuda") * 0.1
        y, S = torch.empty(r.shape, device="cuda"), torch.empty_like(S0)

        def base():
            kernel.wkv6_fwd(r, k, v, logw, u, S0, y, S)
        print(f"{shape_name} {(B, T, H, n)} kernel: {_call_us(base)} us a call, "
              f"{_per_kernel_us(base)}", flush=True)
        if T < kernel.CHUNKED_MIN_T:
            continue
        scratch = torch.empty(kernel.library().repro_wkv6_scratch_bytes(
            B, T, H, n), dtype=torch.uint8, device="cuda")
        for name in VARIANTS:
            def call(lib=libs[f"wkv6_{name}"]):
                lib.repro_wkv6_fwd_chunked(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                    u.data_ptr(), S0.data_ptr(), y.data_ptr(), S.data_ptr(),
                    scratch.data_ptr(), B, T, H, n,
                    torch.cuda.current_stream().cuda_stream)
            print(f"{shape_name} {(B, T, H, n)} {name}: {_call_us(call)} us a "
                  f"call, {_per_kernel_us(call)}", flush=True)


def _forward_bits(against: Path) -> None:
    other = _fwd_lib(_build_sources({"wkv6_other": against.read_text()})
                     ["wkv6_other"])
    g = torch.Generator("cuda").manual_seed(5)
    same_all = True
    for B, T, H, n, decay in FWD_SHAPES:
        r, k, v, logw, u = _inputs(B, T, H, n, g, decay)
        S0 = torch.randn((B, H, n, n), generator=g, device="cuda") * 0.1
        outs = [(torch.empty(r.shape, device="cuda"), torch.empty_like(S0))
                for _ in range(2)]
        kernel.wkv6_fwd(r, k, v, logw, u, S0, *outs[0])
        ptrs = [t.data_ptr() for t in (r, k, v, logw, u, S0, *outs[1])]
        stream = torch.cuda.current_stream().cuda_stream
        if T >= other.repro_wkv6_chunked_min_t():
            scratch = torch.empty(other.repro_wkv6_scratch_bytes(B, T, H, n),
                                  dtype=torch.uint8, device="cuda")
            err = other.repro_wkv6_fwd_chunked(*ptrs, scratch.data_ptr(), B,
                                               T, H, n, stream)
        else:
            err = other.repro_wkv6_fwd(*ptrs, B, T, H, n, stream)
        assert err == 0, err
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        same_all &= same
        print(f"wkv6 forward {(B, T, H, n)}{' ' + decay if decay else ''}: "
              f"y and S bit-identical under both sources: {same}", flush=True)
    print(f"wkv6 forward: bit-identical at all {len(FWD_SHAPES)} shapes: "
          f"{same_all}", flush=True)


def _bwd_entry(lib: ctypes.CDLL):
    """A call of ``lib``'s backward on the given tensors: its scratch as
    the library sizes it (an older source takes du's B x H x n parts)."""
    fn = lib.repro_wkv6_bwd
    fn.argtypes = kernel._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    sized = getattr(lib, "repro_wkv6_bwd_scratch_bytes", None)
    if sized is not None:
        sized.argtypes = [ctypes.c_int] * 4
        sized.restype = ctypes.c_longlong

    def bind(ins, outs):
        B, T, H, n = ins[0].shape
        nbytes = sized(B, T, H, n) if sized is not None else 4 * B * H * n
        scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        ptrs = ([t.data_ptr() for t in ins[:5]] + [None, ins[5].data_ptr(),
                                                   None]
                + [t.data_ptr() for t in outs] + [None, scratch.data_ptr()])

        def call(keep=(ins, outs, scratch)):      # the tensors stay alive
            err = fn(*ptrs, B, T, H, n, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return call
    return bind


def _backward(against) -> None:
    src = build.source("wkv6_bwd").read_text()
    sources = {"wkv6_bwd_no_pdl": _no_pdl(src)}
    if against is not None:
        sources["wkv6_bwd_other"] = against.read_text()
    libs = _build_sources(sources)
    mine = _bwd_entry(kernel.bwd_library())
    alone = _bwd_entry(libs["wkv6_bwd_no_pdl"])
    other = _bwd_entry(libs["wkv6_bwd_other"]) if against is not None \
        else None
    g = torch.Generator("cuda").manual_seed(11)
    for name, (B, T, H, n) in BWD_SHAPES.items():
        r, k, v, logw, u = _inputs(B, T, H, n, g)
        dy = torch.randn((B, T, H, n), generator=g, device="cuda")
        ins = (r, k, v, logw, u, dy)

        def outputs():
            return [torch.empty_like(r), torch.empty_like(k),
                    torch.empty_like(v), torch.empty_like(logw),
                    torch.empty_like(u)]

        runs = {"checkout": mine(ins, outputs())}
        if other is not None:
            runs["other"] = other(ins, outputs())
        runs["checkout"]()
        torch.cuda.synchronize()
        config = kernel.last_bwd_launch()
        print(f"wkv6 backward {name} {(B, T, H, n)}: per pass under "
              f"programmatic dependent launch {_per_kernel_us(runs['checkout'])}"
              f" us, alone {_per_kernel_us(alone(ins, outputs()))} us; main "
              f"pass {config[0]} threads, chunk {config[1]}, {config[2]} B "
              f"dynamic shared memory, {config[3]} blocks", flush=True)
        if other is None:
            continue
        want = wkv6_bwd_ref(r, k, v, logw, u, None, dy, None)
        got = {}
        for version in ("other", "checkout"):
            outs = outputs()
            other_or_mine = other if version == "other" else mine
            other_or_mine(ins, outs)()
            torch.cuda.synchronize()
            got[version] = {w: float((o.float() - ref).abs().max()
                                     / ref.abs().max())
                            for w, o, ref in zip(BWD_TOL, outs, want)}
        med, times = _in_turns(runs["other"], runs["checkout"])
        print(f"wkv6 backward {name} {(B, T, H, n)}: checkout "
              f"{med['checkout']:.5f} ms, {against} {med['other']:.5f} ms "
              f"(medians of 6 in turns; checkout/other "
              f"{med['checkout'] / med['other']:.3f}); err/max|plain| "
              f"checkout {got['checkout']}, other {got['other']} (limits "
              f"{BWD_TOL}); samples {times}", flush=True)
        for version, errs in got.items():
            assert all(errs[w] <= BWD_TOL[w] for w in BWD_TOL), (version, errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true",
                    help="probe the backward (csrc/wkv6_bwd.cu)")
    ap.add_argument("--against", type=Path,
                    help="with --bwd: another csrc/wkv6_bwd.cu, timed in "
                         "turns with the checkout's")
    ap.add_argument("--fwd-against", type=Path,
                    help="another csrc/wkv6.cu: the forward's bits compared")
    ap.add_argument("--step", action="store_true",
                    help="profile one rwkv6-7b training step")
    args = ap.parse_args(argv)
    if args.against is not None and not args.bwd:
        ap.error("--against goes with --bwd")
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not (args.bwd or args.fwd_against or args.step):
        _forward()
    if args.bwd:
        _backward(args.against)
    if args.fwd_against is not None:
        _forward_bits(args.fwd_against)
    if args.step:
        step_profile("rwkv6-7b", STEP_LAYERS, r"wkv6_bwd_\w*kernel",
                     "WKV-6 backward kernels")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
