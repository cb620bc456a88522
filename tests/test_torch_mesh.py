"""The port's meshes and logical-axis sharding rules against the
reference's (``repro.launch.mesh``, ``repro.parallel.sharding``), on the
CPU.

* ``spec_for`` through ``param_specs`` gives, entry for entry, the
  reference's ``PartitionSpec`` for every parameter of all ten
  architectures' published configs, on a 2x4 (data, model) mesh and on
  the production (16, 16) and (2, 16, 16) meshes (abstract on both sides:
  ``make_production_mesh`` and ``jax.sharding.AbstractMesh``), under the
  default "tp" and the "dp_only" strategies, and ``batch_spec`` too;
* ``parse_mesh`` gives the reference's shapes and axis names and its
  ``ValueError`` on a bad spec; a mesh's places go over the devices torch
  sees (all on the host here) and a place's coordinates follow row-major
  mesh order;
* a ``NamedSharding`` cuts a shape into the blocks and replica ids
  ``jax.device_put`` gives on the reference's 8 forced host devices, and
  ``place`` / ``full`` / ``place_like`` round-trip a tensor through them.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.models.registry import build as ref_build
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.registry import build
from repro_torch.parallel import sharding
from repro_torch.utils.tree import tree_leaves

MESHES = {  # name -> (shape, axis names)
    "2x4": ((2, 4), ("data", "model")),
    "pod16x16": ((16, 16), ("data", "model")),
    "multipod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _port_mesh(name):
    shape, axes = MESHES[name]
    if name == "2x4":
        return mesh_mod.parse_mesh("2x4", device="cpu")
    return mesh_mod.make_production_mesh(multi_pod=len(shape) == 3)


@pytest.mark.parametrize("strategy", ["tp", "dp_only"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_name, strategy):
    shape, axes = MESHES[mesh_name]
    ref_ctx = ref_sharding.ctx_for_mesh(AbstractMesh(shape, axes),
                                        strategy=strategy)
    ctx = sharding.ctx_for_mesh(_port_mesh(mesh_name), strategy=strategy)
    assert (ctx.tp_size, ctx.dp_size, ctx.fsdp_size) == \
        (ref_ctx.tp_size, ref_ctx.dp_size, ref_ctx.fsdp_size)
    ref_specs = jax.tree_util.tree_leaves(
        ref_sharding.param_specs(ref_ctx, ref_build(ref_get_config(arch))
                                 .descs),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    specs = tree_leaves(
        sharding.param_specs(ctx, build(get_config(arch),
                                        device="cpu").descs),
        is_leaf=lambda x: isinstance(x, sharding.PartitionSpec))
    assert len(specs) == len(ref_specs) > 0
    for got, want in zip(specs, ref_specs):
        assert tuple(got) == tuple(want), (got, want)
    assert tuple(sharding.batch_spec(ctx, 2)) == \
        tuple(ref_sharding.batch_spec(ref_ctx, 2))


def test_no_mesh_gives_unsharded_specs():
    ctx = sharding.ctx_for_mesh(None)
    ref_ctx = ref_sharding.ctx_for_mesh(None)
    descs = build(get_config("olmo-1b"), device="cpu").descs
    ref_descs = ref_build(ref_get_config("olmo-1b")).descs
    got = tree_leaves(sharding.param_specs(ctx, descs),
                      is_leaf=lambda x: isinstance(x,
                                                   sharding.PartitionSpec))
    want = jax.tree_util.tree_leaves(
        ref_sharding.param_specs(ref_ctx, ref_descs),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(g) for g in got] == [tuple(w) for w in want]
    assert all(e is None for g in got for e in g)


@pytest.mark.parametrize("spec,shape,axes", [
    ("2x4", (2, 4), ("data", "model")),
    ("1x8", (1, 8), ("data", "model")),
    ("2x2x2", (2, 2, 2), ("pod", "data", "model")),
    ("4X2", (4, 2), ("data", "model")),
])
def test_parse_mesh_shapes(spec, shape, axes, host_devices_8):
    from repro.launch.mesh import parse_mesh as ref_parse_mesh
    ref = ref_parse_mesh(spec)
    got = mesh_mod.parse_mesh(spec, device="cpu")
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names) == axes
    assert got.axis_sizes == shape and got.size == int(np.prod(shape))
    assert got.devices == (torch.device("cpu"),) * got.size


@pytest.mark.parametrize("spec", ["8", "2x2x2x2", "2xa", ""])
def test_parse_mesh_errors(spec):
    with pytest.raises(ValueError):
        mesh_mod.parse_mesh(spec, device="cpu")


def test_meshes_and_places():
    prod = mesh_mod.make_production_mesh()
    assert prod.devices is None and prod.shape == {"data": 16, "model": 16}
    assert mesh_mod.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="abstract"):
        prod.device_of(0)
    dbg = mesh_mod.make_debug_mesh(8, model=2, device="cpu")
    assert dbg.shape == {"data": 4, "model": 2}
    assert mesh_mod.make_debug_mesh(device="cpu").shape == \
        {"data": 1, "model": 1}
    m = mesh_mod.parse_mesh("2x4", device="cpu")
    assert [m.coords(p) for p in (0, 3, 4, 7)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 3},
        {"data": 1, "model": 0}, {"data": 1, "model": 3}]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no such device"):
            mesh_mod.parse_mesh("2x4", device="cuda")


@pytest.mark.parametrize("pspec,shape", [
    (("data", "model"), (8, 12)),
    (("model", None), (8, 3)),
    ((None, "data"), (5, 4)),
    ((), (6,)),
    ((("data", "model"),), (16, 2)),
])
def test_blocks_and_replicas_equal_device_put(pspec, shape, host_devices_8):
    rmesh = jax.make_mesh((2, 4), ("data", "model"))
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    arr = jax.device_put(x, jax.sharding.NamedSharding(
        rmesh, jax.sharding.PartitionSpec(*pspec)))
    flat = list(rmesh.devices.flat)
    want = sorted((flat.index(s.device),
                   tuple((sl.start, sl.stop) for sl in s.index),
                   s.replica_id) for s in arr.addressable_shards)
    m = mesh_mod.parse_mesh("2x4", device="cpu")
    st = sharding.place(torch.from_numpy(x),
                        sharding.NamedSharding(m, sharding.P(*pspec)))
    got = sorted((s.place, tuple((sl.start, sl.stop) for sl in s.index),
                  s.replica_id) for s in st.addressable_shards)
    norm = lambda rows: [(p, tuple((a or 0, b if b is not None else n)
                                   for (a, b), n in zip(idx, shape)), r)
                         for p, idx, r in rows]
    assert norm(got) == norm(want)
    for s in st.addressable_shards:
        assert torch.equal(s.data, torch.from_numpy(x)[s.index])
    assert st.nbytes == x.nbytes and torch.equal(st.full(),
                                                 torch.from_numpy(x))


def test_place_like_and_unshard_round_trip():
    m = mesh_mod.parse_mesh("2x4", device="cpu")
    sh = sharding.NamedSharding(m, sharding.P("data", "model"))
    t = torch.arange(64.0).reshape(8, 8)
    tree = {"a": sharding.place(t, sh), "b": np.int64(3)}
    full = sharding.unshard(tree)
    # one device: the blocks view the tensor placed, nothing is copied
    assert full["a"] is t and full["b"] == 3
    assert all(s.data.untyped_storage().data_ptr()
               == t.untyped_storage().data_ptr()
               for s in tree["a"].addressable_shards)
    back = sharding.place_like({"a": full["a"] * 2, "b": np.int64(4)}, tree)
    assert isinstance(back["a"], sharding.ShardedTensor)
    assert back["a"].sharding == sh and torch.equal(back["a"].full(), t * 2)
    assert torch.equal(sharding.place(back["a"], sh).full(), t * 2)
    with pytest.raises(ValueError, match="does not split"):
        sharding.place(torch.zeros(3, 8), sh)
    with pytest.raises(ValueError, match="no mesh axis"):
        sharding.place(t, sharding.NamedSharding(m, sharding.P("pod")))
