"""The model-sharded annual and multi-scenario steps of the port
(``parallel/step.py`` on ``parallel/mesh.py``), on 2 and 4 gloo ranks on the
CPU, in float64: against the JAX package's sharded functions on meshes of
the same shape (of the virtual CPU devices) and against the port's own
unsharded functions, on the same numpy inputs made from a seed.

Each world size is one spawn (``parallel.mesh.run_local``, a module
fixture) that computes every case and records its collective counts; the
ranks import this module but no JAX (the JAX package is imported inside the
test functions only).  Tolerance: 1e-8 on moments and weights, since XLA and
gloo sum the psums in different orders.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu_torch import reset_launch_counts
from bayesian_ensembling_tpu_torch.parallel import mesh as tmesh
from bayesian_ensembling_tpu_torch.parallel import step as tstep

TOL = 1e-8
WORLDS = (2, 4)
# The small sizes of __graft_entry__._toy_inputs: R = 3, T = 24 / 12, five
# observation members, a ragged realisation mask; M = 8 models.
M, R, T_HIST, T_SSP, R_OBS, S = 8, 3, 24, 12, 5, 2
FIT = dict(n_optim_nits=5, dba_iterations=2)
RAW_KINDS = tstep.WEIGHT_KINDS
ANNUAL = (("crps", "w2"), ("crps", "mixture"), ("loglik", "w2"), ("similarity", "w2"))
MULTI = (("1d", "crps", "w2"), ("2d", "crps", "w2"), ("1d", "loglik", "mixture"),
         ("2d", "similarity_single", "w2"))
CASES = ([("raw", k) for k in RAW_KINDS] + [("annual",) + a for a in ANNUAL]
         + [("multi",) + c for c in MULTI])
# optimizer="lbfgs": each rank's fit runs its own line search on its local
# models' summed objective, as under JAX's shard_map; the fit adds no
# collective.
LBFGS_CASES = (("lbfgs-annual", "crps", "w2"), ("lbfgs-multi", "2d", "crps", "w2"))
# The lowered counts of benchmarks/collective_audit.json.
AUDIT = {("annual", "crps", "w2"): {"all_reduce": 3, "all_gather": 0},
         ("annual", "crps", "mixture"): {"all_reduce": 3, "all_gather": 0},
         ("annual", "loglik", "w2"): {"all_reduce": 4, "all_gather": 0},
         ("annual", "similarity", "w2"): {"all_reduce": 3, "all_gather": 3},
         ("multi", "2d", "crps", "w2"): {"all_reduce": 3, "all_gather": 0}}


def _block(rng, shape, t):
    """Zero-padded realisations with ragged masks: model 0 drops its last
    realisation, as in __graft_entry__._toy_inputs."""
    block = np.cumsum(rng.normal(size=shape + (t,)), axis=-1) * 0.3
    mask = np.ones(shape, bool)
    mask[..., 0, -1] = False
    block[~mask] = 0.0
    return block, mask


def make_inputs(seed=0):
    rng = np.random.default_rng(seed)
    hb, hm = _block(rng, (M, R), T_HIST)
    sb, sm = _block(rng, (M, R), T_SSP)
    obs = np.cumsum(rng.normal(size=(R_OBS, T_HIST)), axis=-1) * 0.3
    # The last two models are padding (pad_models replicates model 0).
    hb, hm, mm = tstep.pad_models(hb[:6], hm[:6], M)
    sb, sm, _ = tstep.pad_models(sb[:6], sm[:6], M)
    hbs, hms = _block(rng, (S, M, R), T_HIST)
    sbs, sms = _block(rng, (S, M, R), T_SSP)
    mms = np.ones((S, M))
    mms[1, -3:] = 0.0
    raw = dict(mean=rng.normal(size=(M, T_HIST)), var=rng.uniform(0.05, 0.5, (M, T_HIST)))
    return dict(annual=(hb, hm, sb, sm, obs, mm), multi=(hbs, hms, sbs, sms, obs, mms),
                raw=(raw["mean"], raw["var"], obs, hb, hm, mm))


def _full(x):
    from torch.distributed.tensor import DTensor

    return (x.full_tensor() if isinstance(x, DTensor) else x).numpy()


def _fit(case):
    """The case's kind and fit keywords (``lbfgs-`` cases fit with lbfgs)."""
    if case[0].startswith("lbfgs-"):
        return (case[0][len("lbfgs-"):],) + case[1:], dict(FIT, optimizer="lbfgs")
    return case, FIT


def _port_sharded(case, meshes, inputs):
    case, fit = _fit(case)
    kind = case[0]
    if kind == "raw":
        spec = ("model",)
        fn = tmesh.shard_map(
            lambda *a: (tstep.fused_raw_weights(case[1], *a, model_axis="model"),),
            meshes["1d"], (spec, spec, (), spec, spec, spec), (spec,))
        return fn(*inputs["raw"])
    if kind == "annual":
        step = tstep.make_sharded_step(meshes["1d"], weight_kind=case[1], sigma_mode=case[2], **fit)
        return step(*inputs["annual"])
    mesh = meshes[case[1]]
    step = tstep.make_sharded_multi_scenario_step(
        mesh, scenario_axis="scenario" if case[1] == "2d" else None, weight_kind=case[2],
        sigma_mode=case[3], **fit)
    return step(*inputs["multi"])


def _rank_worker(rank, world, inputs):
    """Every case on this rank; rank 0's return value reaches the test."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    meshes = {"1d": init_device_mesh("cpu", (world,), mesh_dim_names=("model",)),
              "2d": init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("scenario", "model"))}
    out = {}
    for case in CASES + list(LBFGS_CASES):
        reset_launch_counts()
        got = _port_sharded(case, meshes, inputs)
        counts = tmesh.collective_counts()
        out[case] = dict(values=[_full(g) for g in got], counts=counts,
                         types=[type(g).__name__ for g in got])
    errors = {}
    hb, hm, sb, sm, obs, mm = inputs["annual"]
    step = tstep.make_sharded_step(meshes["1d"], **FIT)
    try:
        step(hb[:7], hm[:7], sb[:7], sm[:7], obs, mm[:7])
    except ValueError as e:
        errors["models"] = str(e)
    hbs, hms, sbs, sms, _, mms = inputs["multi"]
    multi = tstep.make_sharded_multi_scenario_step(meshes["2d"], scenario_axis="scenario", **FIT)
    try:
        multi(*(np.concatenate([a, a[:1]]) for a in (hbs, hms, sbs, sms)), obs,
              np.concatenate([mms, mms[:1]]))
    except ValueError as e:
        errors["scenarios"] = str(e)
    try:
        tstep.make_sharded_step(meshes["1d"], model_axis="cells", **FIT)
    except ValueError as e:
        errors["axis"] = str(e)
    out["errors"] = errors
    return out


def _spawn_worlds(*args):
    """``_rank_worker`` on every world size, the spawns side by side; a
    world that has not finished in 300 s fails the tests."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(tmesh.run_local, _rank_worker, w, *args) for w in WORLDS}
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def sharded(inputs):
    return _spawn_worlds(inputs)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port_unsharded(case, inputs, **fit):
    fit = dict(FIT, **fit)
    if case[0] == "raw":
        return (tstep.fused_raw_weights(case[1], *_torch(inputs["raw"])),)
    if case[0] == "annual":
        return tstep.ensemble_scenario_step(*_torch(inputs["annual"]), weight_kind=case[1],
                                            sigma_mode=case[2], **fit)
    return tstep.ensemble_multi_scenario_step(*_torch(inputs["multi"]), weight_kind=case[2],
                                              sigma_mode=case[3], **fit)


def _jax_sharded(case, world, inputs):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from bayesian_ensembling_tpu.parallel import step as jstep

    case, fit = _fit(case)
    devices = np.array(jax.devices()[:world])
    mesh1d = Mesh(devices, ("model",))
    if case[0] == "raw":
        p = P("model")
        fn = shard_map(functools.partial(jstep.fused_raw_weights, case[1], model_axis="model"),
                       mesh=mesh1d, in_specs=(p, p, P(), p, p, p), out_specs=p, check_vma=False)
        return (jax.jit(fn)(*(jnp.asarray(a) for a in inputs["raw"])),)
    if case[0] == "annual":
        step = jstep.make_sharded_step(mesh1d, weight_kind=case[1], sigma_mode=case[2], **fit)
        return step(*(jnp.asarray(a) for a in inputs["annual"]))
    if case[1] == "2d":
        step = jstep.make_sharded_multi_scenario_step(
            Mesh(devices.reshape(2, world // 2), ("scenario", "model")), scenario_axis="scenario",
            weight_kind=case[2], sigma_mode=case[3], **fit)
    else:
        step = jstep.make_sharded_multi_scenario_step(mesh1d, weight_kind=case[2],
                                                      sigma_mode=case[3], **fit)
    return step(*(jnp.asarray(a) for a in inputs["multi"]))


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", CASES, ids="-".join)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax_sharded(sharded, inputs, world, case):
    _close(sharded[world][case]["values"], _jax_sharded(case, world, inputs))


@pytest.mark.parametrize("case", LBFGS_CASES, ids="-".join)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lbfgs_matches_jax_sharded(sharded, inputs, world, case):
    """Per-shard line searches, as the JAX mesh program runs them (1e-8);
    the fit issues no collective, so the step's counts are Adam's."""
    _close(sharded[world][case]["values"], _jax_sharded(case, world, inputs))
    assert sharded[world][case]["counts"] == {"all_reduce": 3, "all_gather": 0}


@pytest.mark.parametrize("case", LBFGS_CASES, ids="-".join)
def test_sharded_lbfgs_is_not_the_unsharded_fit(sharded, inputs, case):
    """Each rank's step size serves only its local models, so the sharded
    lbfgs step is not the unsharded one (whose one line search sees every
    model); nothing all-reduces the objective."""
    plain, _ = _fit(case)
    want = _port_unsharded(plain, inputs, optimizer="lbfgs")
    got = sharded[2][case]["values"]
    assert max(np.max(np.abs(g - w.detach().numpy())) for g, w in zip(got, want)) > 1e-6


@pytest.mark.parametrize("case", CASES, ids="-".join)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_port_unsharded(sharded, inputs, world, case):
    want = [w.detach().numpy() for w in _port_unsharded(case, inputs)]
    _close(sharded[world][case]["values"], want)


@pytest.mark.parametrize("case", CASES, ids="-".join)
@pytest.mark.parametrize("world", WORLDS)
def test_collective_counts(sharded, world, case):
    """The audit's lowered counts where it has the surface; else a psum per
    coupling of the JAX code: 3 a step (4 for loglik, and 3 gathers for the
    similarity kinds, whatever the number of scenarios); fused_raw_weights
    alone issues only the pmax or the gathers."""
    got = sharded[world][case]["counts"]
    kind = case[1] if case[0] == "raw" else case[-2]
    base = 0 if case[0] == "raw" else 3
    want = {"all_reduce": base + (kind == "loglik"),
            "all_gather": 3 * (kind in ("similarity", "similarity_single"))}
    assert got == want
    if case in AUDIT:
        assert got == AUDIT[case]


def test_audit_table_is_the_json():
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmarks", "collective_audit.json")) as f:
        lowered = {s["surface"]: s["lowered"] for s in json.load(f)["surfaces"]}
    names = {("annual", "crps", "w2"): "annual_1d_crps_w2",
             ("annual", "crps", "mixture"): "annual_1d_crps_mixture",
             ("annual", "loglik", "w2"): "annual_1d_loglik_w2",
             ("annual", "similarity", "w2"): "annual_1d_similarity_w2",
             ("multi", "2d", "crps", "w2"): "multi_scenario_2d_crps_w2"}
    for case, name in names.items():
        assert {k: v for k, v in AUDIT[case].items() if v} == lowered[name]


@pytest.mark.parametrize("world", WORLDS)
def test_outputs_are_dtensors_where_sharded(sharded, world):
    """Replicated moments come back as plain tensors; what JAX leaves
    sharded comes back as a DTensor."""
    res = sharded[world]
    assert res[("annual", "crps", "w2")]["types"] == ["Tensor", "Tensor", "DTensor"]
    assert res[("multi", "1d", "crps", "w2")]["types"] == ["Tensor", "Tensor", "DTensor"]
    assert res[("multi", "2d", "crps", "w2")]["types"] == ["DTensor", "DTensor", "DTensor"]
    assert res[("raw", "crps")]["types"] == ["DTensor"]


@pytest.mark.parametrize("world", WORLDS)
def test_undivided_axes_raise_naming_the_padding(sharded, world):
    errors = sharded[world]["errors"]
    assert "pad_models" in errors["models"] and "'model'" in errors["models"]
    assert "'scenario'" in errors["scenarios"] and "multiple of 2" in errors["scenarios"]
    assert "no axis 'cells'" in errors["axis"]


def test_model_axis_without_a_mesh_raises_as_jax_does(inputs):
    import jax.numpy as jnp

    from bayesian_ensembling_tpu.parallel import step as jstep

    raw = inputs["raw"]
    with pytest.raises(NameError, match="unbound axis name"):
        jstep.fused_raw_weights("loglik", *(jnp.asarray(a) for a in raw), model_axis="model")
    for kind in ("crps", "loglik", "similarity"):
        with pytest.raises(NameError, match="unbound axis name: 'model'"):
            tstep.fused_raw_weights(kind, *_torch(raw), model_axis="model")
    hb, hm, sb, sm, obs, mm = _torch(inputs["annual"])
    with pytest.raises(NameError, match="no mesh is current"):
        tstep.ensemble_scenario_step(hb, hm, sb, sm, obs, mm, model_axis="model", **FIT)
    hbs, hms, sbs, sms, obs, mms = _torch(inputs["multi"])
    with pytest.raises(NameError, match="no mesh is current"):
        tstep.ensemble_multi_scenario_step(hbs, hms, sbs, sms, obs, mms, model_axis="model", **FIT)
    means = torch.zeros(S, M, T_SSP, dtype=torch.float64)
    with pytest.raises(NameError, match="no mesh is current"):
        tstep.multi_scenario_tail(means, means + 1, means, means + 1, obs, hbs, hms, mms,
                                  model_axis="model")


def test_sharded_builders_refuse_the_compat_sigma_mode_as_jax_does():
    from bayesian_ensembling_tpu.parallel import step as jstep

    with pytest.raises(ValueError, match="sigma_mode"):
        jstep.make_sharded_step(None, sigma_mode="compat")
    for build in (tstep.make_sharded_step, tstep.make_sharded_multi_scenario_step):
        with pytest.raises(ValueError, match="sigma_mode"):
            build(None, sigma_mode="compat")


def test_chip_smoke_phase12_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 12 at a tiny size with the plain versions: a
    one-rank gloo group in place of NCCL, the earlier phases' float32 runs
    (the step, the campaign, the gridded step) made here unsharded, each
    sharded surface equal to them bit for bit with its counts, and the
    two-rank annual step against one rank."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke as cs

    import bayesian_ensembling_tpu_torch as bt

    for name, value in dict(PARITY_NITS=3, MONTHLY_NITS=3, GRID_NITS=3, HIST_CHUNK=2,
                            GRID_LAT=2, GRID_LON=3).items():
        monkeypatch.setattr(cs, name, value)
    for name, value in dict(M=2, R=3, T=10, R_OBS=4).items():
        monkeypatch.setattr(cs._gridded_common(), name, value)
    cpu = torch.device("cpu")
    inputs = cs.synthetic_flagship(0, scenarios=2, models=4, min_real_models=3, realisations=3,
                                   t_hist=16, t_ssp=8, obs_members=5)

    def counted(fn):
        bt.reset_launch_counts()
        out = fn()
        return out, bt.launch_counts(), bt.route_counts()

    out, launches, routes = counted(lambda: cs.run_slice(torch, bt, inputs, cpu, torch.float32,
                                                         cs.PARITY_NITS))
    annual = dict(out=out, launches=launches, routes=routes)
    pack, obs = cs.monthly_campaign(0, scenarios=2, hist_models=5, ssp_models=[3, 2], models=3,
                                    realisations=4, t_hist=20, t_ssp=10, obs_members=5)
    out, launches, routes = counted(lambda: cs._campaign(bt, pack, obs, cpu, torch.float32))
    report = {"monthly_f32": dict(pack=pack, obs=obs, out=out, launches=launches, routes=routes)}
    block, gobs = cs._gridded_common().make_workload_cells(np.arange(cs.GRID_LAT * cs.GRID_LON))
    blk, ob = torch.from_numpy(block), torch.from_numpy(gobs)
    mk = torch.ones(blk.shape[:3], dtype=torch.bool)
    out, launches, routes = counted(lambda: bt.gridded_ensemble_step(
        blk, ob, mk, n_optim_nits=cs.GRID_NITS, return_fit=True, **cs.GRID_KW))
    report["gridded_f32"] = dict(blk=blk, ob=ob, mk=mk, out=out[:3], launches=launches,
                                 routes=routes)
    assert cs.run_sharded(torch, bt, cpu, inputs, annual, report, backend="gloo")
    assert set(report) == {"launches"}  # both earlier runs taken up
    assert set(report["launches"]["sharded"]) == set(bt.launch_counts())
    assert not torch.distributed.is_initialized()
