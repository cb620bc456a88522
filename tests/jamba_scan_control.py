"""Whether phase 19 (a) of ``chip_smoke.py`` sees a faulty scan backward.

Not a test (pytest does not collect it): it needs the card and runs
jamba-1.5-large-398b at full width with 1 layer, as phase 19 (a) does:
the same weights (``torch.Generator("cuda")`` seeded 0), the same (1, 64)
batch at ``ssm_chunk`` 48 (2 chunks, the second ragged) and the same
reference, the port on the CPU in fp32.  It reads the loss, the global
grad norm and the grad norm of ``JAMBA_SCAN_LEAVES`` on the card three
times: with the backward kernel as built, with the cotangent of each
chunk's final h dropped (the gradient that crosses the chunk boundary),
and with dC zeroed.  The last two are controls: they break the backward
at run time by wrapping ``SelectiveScan.backward``; no file changes.
Each reading is printed with its distance from the CPU's fp32 beside
phase 19's bound (``TOL``, 2e-2 relative), and the script exits 1 if
the intact kernel misses the bound or a control meets it on every
reading:

    PYTHONPATH=src python tests/jamba_scan_control.py
"""
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mamba import ops  # noqa: E402
from repro_torch.launch.serve import set_determinism  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402


def drop_dh(backward):
    """The backward with the cotangent of the final h taken as zero."""
    return lambda ctx, dy, dh: backward(ctx, dy, None)


def zero_dC(backward):
    """The backward with dC set to zero."""
    def bwd(ctx, dy, dh):
        grads = list(backward(ctx, dy, dh))
        if grads[2] is not None:
            grads[2] = torch.zeros_like(grads[2])
        return tuple(grads)
    return bwd


VARIANTS = {"as built": None, "dh dropped": drop_dh, "dC zeroed": zero_dC}


def main() -> int:
    if not torch.cuda.is_available():
        print("jamba_scan_control: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    set_determinism()
    print(cs.card_line(), flush=True)
    cfg = get_config("jamba-1.5-large-398b").with_(
        n_layers=cs.JAMBA_TRAIN_LAYERS)
    a_cfg = cfg.with_(ssm_chunk=cs.JAMBA_A_CHUNK)
    params = build(cfg, device="cuda").init_params(
        torch.Generator("cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (1, 65),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    held = cs.JAMBA_SCAN_LEAVES
    t0 = time.perf_counter()
    plain = cs._loss_and_grad_norm(
        torch, build(a_cfg.with_(param_dtype="float32",
                                 compute_dtype="float32"), device="cpu"),
        tree_map(lambda x: x.float().cpu(), params), batch, held)
    print(f"CPU fp32 ({time.perf_counter() - t0:.1f} s): loss {plain[0]!r} "
          f"grad norm {plain[1]!r} {'/'.join(held)} {plain[2]!r}",
          flush=True)
    bundle = build(a_cfg, device="cuda")
    on_card = {k: v.cuda() for k, v in batch.items()}
    built = ops.SelectiveScan.__dict__["backward"]
    backward = ops.SelectiveScan.backward
    misses = {}
    for name, wrap in VARIANTS.items():
        ops.SelectiveScan.backward = (built if wrap is None
                                      else staticmethod(wrap(backward)))
        ops.BWD_LAUNCHES = 0
        try:
            card = cs._loss_and_grad_norm(torch, bundle, params, on_card,
                                          held)
        finally:
            ops.SelectiveScan.backward = built
        rel = [abs(c - p) / abs(p) for c, p in zip(card, plain)]
        misses[name] = [r > cs.TOL for r in rel]
        print(f"{name}: loss {card[0]!r} grad norm {card[1]!r} "
              f"{'/'.join(held)} {card[2]!r}; rel to the CPU's fp32 "
              f"{rel[0]:.3e} / {rel[1]:.3e} / {rel[2]:.3e} (bound "
              f"{cs.TOL}); over the bound {misses[name]}; backward "
              f"launches {ops.BWD_LAUNCHES}", flush=True)
    seen = (not any(misses["as built"])
            and all(any(m) for n, m in misses.items() if n != "as built"))
    print(f"phase 19 (a) tells the controls from the kernel: {seen}",
          flush=True)
    return 0 if seen else 1


if __name__ == "__main__":
    sys.exit(main())
