"""The tensor twin of the LTS (``repro_torch.core.semantics_torch``) on the
CPU, against the JAX twin (``repro.core.semantics_jax``) and the Python
LTS on the same actions.  The semantics are integer-only, so ``C``, ``M``
and ``obs`` must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import semantics_jax as sj
from repro_torch.core import semantics_torch as ts

SYSTEMS = {
    # the model_fuzz bench's system, and a 4-machine, 8-location one
    "2m4l": ((0, 0, 1, 1), (False, True), 2),
    "4m8l": ((0, 0, 1, 1, 2, 2, 3, 3), (False, True, False, True), 4),
    # the JAX twin's own tests' system
    "2m3l": ((0, 0, 1), (False, True), 2),
}
ACT, FLAVOR = ts.ACT, ts.FLAVOR


def _systems(name):
    owner, volatile, n = SYSTEMS[name]
    return (ts.TorchSystem(owner=owner, volatile=volatile, n_machines=n),
            sj.JaxSystem(owner=owner, volatile=volatile, n_machines=n))


def _numpy_actions(rng, tsys, B, T, kinds=(0, 11), vals=(0, 4),
                   flavors=(0, 1)):
    return np.stack([
        rng.integers(*kinds, (B, T)), rng.integers(0, tsys.n_machines, (B, T)),
        rng.integers(0, tsys.n_locs, (B, T)), rng.integers(*vals, (B, T)),
        rng.integers(*flavors, (B, T))], -1).astype(np.int32)


def _assert_equal_runs(tsys, jsys, actions):
    C, M, obs = ts.run_schedules(tsys, torch.from_numpy(actions))
    Cj, Mj, obsj = sj.run_schedules(jsys, jnp.asarray(actions))
    np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))
    np.testing.assert_array_equal(M.numpy(), np.asarray(Mj))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(obsj))
    return C, M, obs


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_run_schedules_equals_jax_twin(name):
    tsys, jsys = _systems(name)
    acts = _numpy_actions(np.random.default_rng(0), tsys, 512, 64,
                          flavors=(0, 3))
    C, M, obs = _assert_equal_runs(tsys, jsys, acts)
    assert C.shape == (512, tsys.n_machines, tsys.n_locs)
    assert (M.shape, obs.shape) == ((512, tsys.n_locs), (512, 64))
    assert C.dtype == M.dtype == obs.dtype == torch.int32


def test_out_of_band_kinds_values_and_flavors_equal_jax_twin():
    """Kinds below 0 / above 10 clamp (noop / FAA), negative values and
    flavors other than l / r (an m-FAA), as in the reference."""
    tsys, jsys = _systems("2m4l")
    acts = _numpy_actions(np.random.default_rng(1), tsys, 256, 48,
                          kinds=(-3, 14), vals=(-5, 6), flavors=(-1, 5))
    _assert_equal_runs(tsys, jsys, acts)


@pytest.mark.parametrize("name", ["2m4l", "4m8l"])
def test_random_schedules_equal_the_python_lts(name):
    tsys, _ = _systems(name)
    acts = ts.random_schedules(tsys, torch.Generator().manual_seed(3),
                               batch=128, length=64, p_crash=0.05)
    C, M, obs = ts.run_schedules(tsys, acts)
    cfg = tsys.config()
    for b in range(acts.shape[0]):
        Cp, Mp, op = ts.lts_run(cfg, acts[b].tolist())
        np.testing.assert_array_equal(C[b].numpy(), Cp)
        np.testing.assert_array_equal(M[b].numpy(), Mp)
        np.testing.assert_array_equal(obs[b].numpy(), op)
    assert int(ts.invariant_violations(C)) == 0


_T_PAD = 25          # hypothesis schedules padded with no-ops to one shape


@settings(max_examples=60, deadline=None)
@given(st.lists(
    st.tuples(st.integers(0, 10), st.integers(0, 1), st.integers(0, 2),
              st.integers(0, 3), st.integers(0, 2)),
    min_size=1, max_size=_T_PAD))
def test_hypothesis_schedules_equal_jax_twin_and_lts(schedule):
    tsys, jsys = _systems("2m3l")
    acts = np.zeros((1, _T_PAD, 5), np.int32)
    acts[0, :len(schedule)] = schedule
    C, M, obs = _assert_equal_runs(tsys, jsys, acts)
    Cp, Mp, op = ts.lts_run(tsys.config(), acts[0])
    np.testing.assert_array_equal(C[0].numpy(), Cp)
    np.testing.assert_array_equal(M[0].numpy(), Mp)
    np.testing.assert_array_equal(obs[0].numpy(), op)


# ---------------------------------------------------------------------------
# one case per branch, from a hand-made state (2 machines; locations 0, 1
# owned by machine 0 and 2, 3 by machine 1, which is volatile)
# ---------------------------------------------------------------------------

#: C rows are machines; loc 2 is cached on both machines with DIFFERENT
#: values (a state no schedule reaches) so the load takes the max
C0 = [[5, -1, 7, 2],
      [-1, 3, 9, -1]]
M0 = [1, 2, 3, 4]


def _act(kind, i, x, v=0, fl=0):
    return [ACT[kind], i, x, v, fl]


BRANCHES = {
    "noop": (_act("noop", 1, 3), None),
    "lstore": (_act("lstore", 1, 0, 6), ([[-1, -1, 7, 2], [6, 3, 9, -1]],
                                         M0, -1)),
    "rstore_nonowner": (_act("rstore", 1, 0, 6),
                        ([[6, -1, 7, 2], [-1, 3, 9, -1]], M0, -1)),
    "mstore": (_act("mstore", 0, 2, 8), ([[5, -1, -1, 2], [-1, 3, -1, -1]],
                                         [1, 2, 8, 4], -1)),
    "load_max_of_cached": (_act("load", 0, 2),
                           ([[5, -1, 9, 2], [-1, 3, 9, -1]], M0, 9)),
    "load_copies_into_own_cache": (_act("load", 0, 1),
                                   ([[5, 3, 7, 2], [-1, 3, 9, -1]], M0, 3)),
    "load_own_hit": (_act("load", 0, 3), (C0, M0, 2)),
    "lflush_nonowner": (_act("lflush", 0, 3),
                        ([[5, -1, 7, -1], [-1, 3, 9, 2]], M0, -1)),
    "lflush_owner": (_act("lflush", 0, 0),
                     ([[-1, -1, 7, 2], [-1, 3, 9, -1]], [5, 2, 3, 4], -1)),
    "lflush_empty": (_act("lflush", 1, 0), None),
    "rflush": (_act("rflush", 0, 2), ([[5, -1, -1, 2], [-1, 3, -1, -1]],
                                      [1, 2, 9, 4], -1)),
    "tau_cc": (_act("tau_cc", 1, 1),
               ([[5, 3, 7, 2], [-1, -1, 9, -1]], M0, -1)),
    "tau_cc_owner_noop": (_act("tau_cc", 0, 0), None),
    "tau_cm": (_act("tau_cm", 0, 1),
               None),                        # owner 0 holds nothing at 1
    "tau_cm_owner_holds": (_act("tau_cm", 1, 0),
                           ([[-1, -1, 7, 2], [-1, 3, 9, -1]],
                            [5, 2, 3, 4], -1)),
    "crash_volatile": (_act("crash", 1, 0),
                       ([[5, -1, 7, 2], [-1, -1, -1, -1]], [1, 2, 0, 0], -1)),
    "crash_nonvolatile": (_act("crash", 0, 3),
                          ([[-1, -1, -1, -1], [-1, 3, 9, -1]], M0, -1)),
    "faa_l": (_act("faa", 1, 3, 10, FLAVOR["l"]),
              ([[5, -1, 7, -1], [-1, 3, 9, 12]], M0, 2)),
    "faa_r": (_act("faa", 0, 3, 10, FLAVOR["r"]),
              ([[5, -1, 7, -1], [-1, 3, 9, 12]], M0, 2)),
    "faa_m": (_act("faa", 0, 2, 10, FLAVOR["m"]),
              ([[5, -1, -1, 2], [-1, 3, -1, -1]], [1, 2, 19, 4], 9)),
}


@pytest.mark.parametrize("case", list(BRANCHES))
def test_each_branch_equals_jax_step(case):
    action, want = BRANCHES[case]
    tsys, jsys = _systems("2m4l")
    C = torch.tensor([C0], dtype=torch.int32)
    M = torch.tensor([M0], dtype=torch.int32)
    C2, M2, obs = ts.step(tsys, C, M, torch.tensor([action], dtype=torch.int32))
    Cj, Mj, obsj = sj.step(jsys, jnp.asarray(C0, jnp.int32),
                           jnp.asarray(M0, jnp.int32),
                           jnp.asarray(action, jnp.int32))
    np.testing.assert_array_equal(C2[0].numpy(), np.asarray(Cj))
    np.testing.assert_array_equal(M2[0].numpy(), np.asarray(Mj))
    assert int(obs[0]) == int(obsj)
    if want is None:                   # the branch leaves the state as it is
        want = (C0, M0, -1)
    assert C2[0].tolist() == want[0] and M2[0].tolist() == want[1]
    assert int(obs[0]) == want[2]


def test_load_from_memory_observes_m():
    tsys, _ = _systems("2m4l")
    C, M = ts.initial_tensors(tsys, 1)
    M[0, 3] = 4
    _, _, obs = ts.step(tsys, C, M, torch.tensor([_act("load", 0, 3)],
                                                 dtype=torch.int32))
    assert int(obs[0]) == 4


def test_random_schedules_kind_frequencies_match_the_weights():
    tsys, _ = _systems("2m4l")
    p_crash = 0.02
    acts = ts.random_schedules(tsys, torch.Generator().manual_seed(0),
                               batch=2048, length=64, p_crash=p_crash)
    assert acts.shape == (2048, 64, 5) and acts.dtype == torch.int32
    freq = torch.bincount(acts[..., 0].flatten(), minlength=11).double() \
        / acts[..., 0].numel()
    want = torch.zeros(11, dtype=torch.float64)
    for kind, w in ts.KIND_WEIGHTS:
        want[kind] = w * (1 - p_crash)
    want[ACT["crash"]] = p_crash
    assert float((freq - want).abs().max()) < 0.01, freq
    for col, n in ((1, tsys.n_machines), (2, tsys.n_locs), (3, 4)):
        assert int(acts[..., col].min()) == 0
        assert int(acts[..., col].max()) == n - 1
    assert int(acts[..., 4].abs().max()) == 0         # flavor l


def test_random_schedules_are_reproducible_from_the_generator():
    tsys, _ = _systems("4m8l")
    a = ts.random_schedules(tsys, torch.Generator().manual_seed(5), 64, 16)
    b = ts.random_schedules(tsys, torch.Generator().manual_seed(5), 64, 16)
    assert torch.equal(a, b)


@pytest.mark.parametrize("col,what,bad", [(1, "machine", 2),
                                          (1, "machine", -1),
                                          (2, "loc", 4), (2, "loc", -1)])
def test_out_of_range_machine_or_loc_raises(col, what, bad):
    tsys, _ = _systems("2m4l")
    acts = torch.zeros((3, 5, 5), dtype=torch.int32)
    acts[1, 2, col] = bad
    with pytest.raises(ValueError, match=what):
        ts.run_schedules(tsys, acts)


def test_invariant_violations_counts_distinct_values_per_location():
    C = torch.tensor([C0, [[1, -1, 1, -1], [1, -1, -1, -1]]],
                     dtype=torch.int32)
    # row 0: loc 2 holds 7 and 9 -> one violation; row 1: equal values
    assert int(ts.invariant_violations(C)) == 1
    assert int(ts.invariant_violations(torch.full((4, 3, 5), -1,
                                                  dtype=torch.int32))) == 0
