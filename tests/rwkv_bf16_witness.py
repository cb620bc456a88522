"""How far rwkv6-7b's bf16 gradient lies from its fp32 one, in the JAX
reference and in the port, on the same weights and the same batch.

Not a test (pytest does not collect it): a full-width reading, too large
for the CPU suite.  One (1, 64) batch, as phase 18 (a) of ``chip_smoke.py``
takes it, through rwkv6-7b at full width with 2 layers.  The weights are
drawn by the port (``init_params``, fp32, seed ``--seed``) and rounded to
bf16 once, so the fp32 and bf16 runs see the same values.  Both packages
run on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rwkv_bf16_witness.py \
        --seed 1

It prints the loss and the global grad norm of the four runs: the port
and the reference, each in fp32 and bf16.  Per leaf it prints the norms
and the relative distance ||a - b|| / ||b|| of port bf16 to port fp32,
reference bf16 to reference fp32, port bf16 to reference bf16, and port
fp32 to reference fp32.  It also prints the smallest variance over a
head's channels of the WKV output that the group norm normalises, and
where that variance lies.  ``--eps E`` reruns the port with the group
norm's eps set to E.  ``--port-only --device cuda`` draws the weights on
the card, as phase 18 does (``torch.Generator("cuda")``), and runs only
the port (on the CPU); it imports no JAX.  Peak host memory at full width
is about 23 GB.
"""
import argparse
import gc

import numpy as np
import torch

import repro_torch.models.rwkv as rwkv_model
from repro_torch.configs import get_config
from repro_torch.models.registry import build
from repro_torch.utils.tree import tree_flatten

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def smallest_group_norm_variance(seen):
    """(variance, layer, t, head) of the smallest per-head variance of the
    WKV output over all layers and tokens of one forward."""
    best = None
    for layer, var in enumerate(seen):
        i = int(var.argmin())
        t, h = divmod(i, var.shape[-1])
        if best is None or float(var.min()) < best[0]:
            best = (float(var.min()), layer, t, h)
    return best


def port_grads(cfg, leaves, treedef, dt, batch):
    """Loss, grads (in ``dt``) and the smallest group-norm variance of
    the port in ``dt`` on the CPU."""
    name = {"fp32": "float32", "bf16": "bfloat16"}[dt]
    bundle = build(cfg.with_(param_dtype=name, compute_dtype=name),
                   device="cpu")
    seen = []
    group_norm = rwkv_model._group_norm

    def spy(p, y):
        yd = y.detach()
        seen.append(((yd - yd.mean(-1, keepdim=True)) ** 2).mean(-1)[0])
        return group_norm(p, y)

    live = [x.detach().to(DTYPES[dt]).requires_grad_(True)
            if x.is_floating_point() else x for x in leaves]
    rwkv_model._group_norm = spy
    try:
        loss, _ = bundle.loss(treedef.unflatten(live), batch,
                              with_remat=False)
    finally:
        rwkv_model._group_norm = group_norm
    grads = torch.autograd.grad(loss, live)
    return float(loss), list(grads), smallest_group_norm_variance(seen)


def ref_grads(cfg_ref, leaves, dt, batch):
    """Loss and grads (torch, in ``dt``) of the JAX reference in ``dt``."""
    import jax
    import jax.numpy as jnp
    from repro.models.registry import build as ref_build
    name = {"fp32": "float32", "bf16": "bfloat16"}[dt]
    bundle = ref_build(cfg_ref.with_(param_dtype=name, compute_dtype=name))
    shape = jax.eval_shape(bundle.init_params, jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(shape)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(x.numpy()).astype(jnp.bfloat16 if dt == "bf16"
                                      else jnp.float32)
        for x in leaves])
    rb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: bundle.loss(p, rb)[0]))(params)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(shape)[0]]
    out = [torch.from_numpy(np.asarray(g, np.float32)).to(DTYPES[dt])
           for g in jax.tree_util.tree_leaves(grads)]
    return float(loss), out, paths


def nrm(g) -> float:
    return float(g.double().norm())


def norm(gs) -> float:
    return float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))


def rel(a, b) -> float:
    return nrm(a.double() - b.double()) / max(nrm(b), 1e-30)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default="cpu",
                    help="where the weights are drawn (cuda: as phase 18)")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--eps", type=float, default=None,
                    help="also run the port with this group-norm eps")
    args = ap.parse_args()
    cfg = get_config("rwkv6-7b").with_(n_layers=args.layers)
    draw = build(cfg.with_(param_dtype="float32", compute_dtype="float32"),
                 device=args.device)
    params = draw.init_params(
        torch.Generator(args.device).manual_seed(args.seed))
    leaves, treedef = tree_flatten(params)
    leaves = [x.to(torch.bfloat16).float().cpu() for x in leaves]
    del params, draw
    gc.collect()
    tok = torch.randint(0, cfg.vocab_size, (1, 65),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    print(f"rwkv6-7b d_model {cfg.d_model}, {cfg.n_layers} layers, weights "
          f"drawn on {args.device} with seed {args.seed}", flush=True)

    loss, grads, var = {}, {}, {}
    for dt in DTYPES:
        loss[f"port {dt}"], grads[f"port {dt}"], var[dt] = port_grads(
            cfg, leaves, treedef, dt, batch)
        v, layer, t, h = var[dt]
        print(f"port {dt}: loss {loss[f'port {dt}']:.6f} grad norm "
              f"{norm(grads[f'port {dt}']):.6f}; smallest group-norm "
              f"variance {v:.4e} (eps {rwkv_model.GN_EPS:.0e}) at layer "
              f"{layer}, t {t}, head {h}", flush=True)
    if args.eps is not None:
        kept, rwkv_model.GN_EPS = rwkv_model.GN_EPS, args.eps
        at = {}
        for dt in DTYPES:
            at[dt], g, _ = port_grads(cfg, leaves, treedef, dt, batch)
            at[dt] = (at[dt], norm(g))
        rwkv_model.GN_EPS = kept
        print(f"port with group-norm eps {args.eps:.0e}: grad norm fp32 "
              f"{at['fp32'][1]:.6f} bf16 {at['bf16'][1]:.6f}, rel "
              f"{abs(at['bf16'][1] - at['fp32'][1]) / at['fp32'][1]:.3e}",
              flush=True)
    a, b = norm(grads["port fp32"]), norm(grads["port bf16"])
    print(f"port: grad norm bf16 vs fp32 rel {abs(b - a) / a:.3e}",
          flush=True)
    if args.port_only:
        return
    from repro.configs import get_config as ref_get_config
    cfg_ref = ref_get_config("rwkv6-7b").with_(n_layers=args.layers)
    # rows[i]: the norms and distances of leaf i, filled as the runs end
    # (the port's fp32 gradient is dropped once the reference's is in)
    p32, p16 = grads.pop("port fp32"), grads.pop("port bf16")
    rows = [[nrm(a), 0.0, nrm(b), 0.0, rel(b, a), 0.0,
             0.0, 0.0] for a, b in zip(p32, p16)]
    norms = {"port fp32": norm(p32), "port bf16": norm(p16)}
    loss["ref fp32"], q32, paths = ref_grads(cfg_ref, leaves, "fp32", batch)
    norms["ref fp32"] = norm(q32)
    for row, a, q in zip(rows, p32, q32):
        row[1], row[7] = nrm(q), rel(a, q)
    del p32
    gc.collect()
    loss["ref bf16"], q16, _ = ref_grads(cfg_ref, leaves, "bf16", batch)
    norms["ref bf16"] = norm(q16)
    for row, b, q, r in zip(rows, p16, q16, q32):
        row[3], row[5], row[6] = nrm(q), rel(q, r), rel(b, q)
    for k in ("ref fp32", "ref bf16"):
        print(f"{k}: loss {loss[k]:.6f} grad norm {norms[k]:.6f}")
    a, b = norms["ref fp32"], norms["ref bf16"]
    print(f"ref: grad norm bf16 vs fp32 rel {abs(b - a) / a:.3e}")
    print("leaf: norm port fp32, ref fp32, port bf16, ref bf16 | rel port "
          "bf16-fp32, ref bf16-fp32, port-ref bf16, port-ref fp32")
    for path, row in zip(paths, rows):
        print(f"{path:48s} " + " ".join(f"{x:.4e}" for x in row[:4])
              + " | " + " ".join(f"{x:.3e}" for x in row[4:]), flush=True)


if __name__ == "__main__":
    main()
