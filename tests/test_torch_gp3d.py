"""The port's ``GPDTW3D`` (``models/gp_3d.py``) and ``run_gridded_scenario``
against the JAX package, in float64, on a 3 x 4 grid (R = 3, T = 12).

Tolerances: the features are the same numpy code (exact); the batched mode
is ``emulate_marginals`` per model, held to ``tests/test_torch_step.py``'s
TOL = 1e-8; the float64 refinement to 1e-10 (``tests/test_torch_weights.py``);
the svgp mode's inputs to the SVGP (features, targets, noise) to 1e-12 and
its moments after one epoch (two steps) on JAX's own minibatches to 1e-6
(``tests/test_torch_svgp.py`` says why Adam's normalised steps keep a fit
from 1e-8; here the known noise is about 0.01, the negative ELBO O(1e4),
and the gap grows with the steps: 9e-7 after 6, 1e-5 after more); the
pipeline's weights and barycentre follow the fit (1e-8).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesian_ensembling_tpu_torch as tbet
from bayesian_ensembling_tpu import coords as jcoords
from bayesian_ensembling_tpu import data as jdata
from bayesian_ensembling_tpu import pipeline as jpipeline
from bayesian_ensembling_tpu import weights as jweights
from bayesian_ensembling_tpu.models import gp_3d as jgp3d
from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch.models import gp_3d as tgp3d
from bayesian_ensembling_tpu_torch.parallel import step as tstep

from test_torch_dtw_subgradient import jax_orders  # noqa: F401  (fixture)
from test_torch_svgp import jax_minibatches  # noqa: F401  (fixture)

torch.set_num_threads(1)

TOL = 1e-8
REFINED_TOL = 1e-10
SVGP_TOL = 1e-6
KW = dict(n_optim_nits=6, dba_iterations=2)


def gridded_values(seed, r=3, t=12, la=3, lo=4, offset=0.0):
    rng = np.random.default_rng(seed)
    base = np.sin(np.linspace(0, 2, t))[None, :, None, None]
    return base + offset + 0.1 * rng.normal(size=(r, t, la, lo))


def _coords(t, la, lo):
    time = (np.datetime64("2000-01", "M") + np.arange(t)).astype("datetime64[ns]")
    return {"time": time, "latitude": np.linspace(-60, 60, la), "longitude": np.linspace(0, 270, lo)}


def models(pkg, seeds=(0, 1), **kw):
    """One gridded ``ProcessModel`` per seed, in the JAX package or the port."""
    coords_mod, data_mod = (jcoords, jdata) if pkg == "jax" else (tbet.coords, tbet.data)
    out = []
    for i, seed in enumerate(seeds):
        vals = gridded_values(seed, offset=0.05 * i, **kw)
        da = coords_mod.DimArray(vals, ("realisation", "time", "latitude", "longitude"),
                                 _coords(*vals.shape[1:]), name="tas")
        out.append(data_mod.ProcessModel(da, f"m{i}"))
    return out


def observations(pkg, seed=9, r=4, **kw):
    return models(pkg, seeds=(seed,), r=r, **kw)[0]


def _moments(post):
    g = post.gaussian
    return np.asarray(g.mean), np.asarray(g.var)


@pytest.mark.parametrize("lat,lon,n_time", [([0.0, 90.0], [0.0, 180.0], 3),
                                            (np.linspace(-87.5, 87.5, 36), np.linspace(2.5, 357.5, 72), 4),
                                            ([10.0], [20.0], 1)])
def test_spherical_time_features_match_jax(lat, lon, n_time):
    got = tgp3d.spherical_time_features(np.asarray(lat), np.asarray(lon), n_time)
    want = jgp3d.spherical_time_features(np.asarray(lat), np.asarray(lon), n_time)
    np.testing.assert_array_equal(got, want)


def test_requires_four_dims_in_order():
    from test_torch_library_api import scenario

    one_d = scenario("torch", 1)[0][0]
    with pytest.raises(NotImplementedError, match="latitude"):
        tgp3d.GPDTW3D().fit(one_d, device="cpu")
    vals = gridded_values(0)
    bad = tbet.DimArray(vals, ("realisation", "time", "longitude", "latitude"), {})
    with pytest.raises(IndexError, match="Coordinate order"):
        tgp3d.GPDTW3D().fit(tbet.ProcessModel(bad, "bad"), device="cpu")


@pytest.mark.parametrize("dba_method", ["classic", "subgradient"])
def test_batched_mode_matches_jax(jax_orders, dba_method):  # noqa: F811
    jm, tm = models("jax"), models("torch")
    jposts = jgp3d.GPDTW3D(dtype=jnp.float64).fit_collection(
        jdata.ModelCollection(jm), dba_method=dba_method, **KW)
    tposts = tgp3d.GPDTW3D(dtype=torch.float64).fit_collection(
        tbet.ModelCollection(tm), dba_method=dba_method, device="cpu", **KW)
    for jp, tp_ in zip(jposts, tposts):
        assert tp_.mean.dims == ("time", "latitude", "longitude")
        assert tp_.gaussian.mean.shape == (12 * 3 * 4,)
        for g, w in zip(_moments(tp_), _moments(jp)):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_batched_mode_is_the_1d_emulation_cell_by_cell():
    """Each cell of the batched fit is ``emulate_marginals`` of that cell's
    realisations alone (the JAX package's own check, tests/test_gp3d.py)."""
    pm = models("torch", seeds=(3,), r=2, t=10, la=2, lo=2)[0]
    post = tgp3d.GPDTW3D(dtype=torch.float64).fit(pm, n_optim_nits=10, dba_iterations=2,
                                                  device="cpu")
    vals = pm.data.values
    for i, j in ((1, 0), (0, 1)):
        cell = torch.from_numpy(np.ascontiguousarray(vals[:, :, i, j]))[None]
        mean_c, var_c = tstep.emulate_marginals(cell, torch.ones((1, 2), dtype=torch.bool),
                                                n_optim_nits=10, dba_iterations=2)
        np.testing.assert_allclose(post.mean.values[:, i, j], mean_c[0].numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(post.variance.values[:, i, j], var_c[0].numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("chunk", [None, 5])
def test_batched_refine_f64_matches_jax(chunk):
    jm, tm = models("jax"), models("torch")
    kw = dict(KW, refine_f64=True, refine_cell_chunk=chunk)
    jposts = jgp3d.GPDTW3D().fit_collection(jdata.ModelCollection(jm), refine_device="cpu", **kw)
    tposts = tgp3d.GPDTW3D().fit_collection(tbet.ModelCollection(tm), device="cpu", **kw)
    plain = tgp3d.GPDTW3D().fit_collection(tbet.ModelCollection(tm), device="cpu", **KW)
    for jp, tp_, p32 in zip(jposts, tposts, plain):
        assert tp_.gaussian.mean.dtype == torch.float64
        assert p32.gaussian.mean.dtype == torch.float32
        # The two float32 fits differ in round-off; the refinement is then
        # a float64 recompute at each side's own float32 hyperparameters.
        for g, w in zip(_moments(tp_), _moments(jp)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        np.testing.assert_allclose(_moments(tp_)[0], _moments(p32)[0], rtol=0, atol=1e-4)


def test_refine_f64_at_fixed_fit_matches_jax():
    """The refinement step alone, fed the same float32 fit on both sides."""
    from bayesian_ensembling_tpu.parallel import gridded as jg
    from bayesian_ensembling_tpu_torch.parallel import gridded as tg

    pm = models("torch")[0]
    r, t, la, lo = pm.data.shape
    block = np.transpose(pm.data.values.reshape(r, t, la * lo), (2, 0, 1)).astype(np.float32)
    mask = np.ones(block.shape[:2], bool)
    out = tstep.emulate_marginals(torch.from_numpy(block), torch.from_numpy(mask),
                                  return_params=True, return_targets=True, **KW)
    targets = (out[3].numpy(), out[4].numpy())
    got = tg.refine_marginals_f64(block, mask, out[2], targets, device="cpu", chunk=5)
    jparams = jg.gp_ops.GPParams(**convert.gp_params_to_numpy(out[2]))
    want = jg.refine_marginals_f64(block, mask, jparams, targets, chunk=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REFINED_TOL)


def test_svgp_mode_matches_jax(jax_minibatches, monkeypatch):  # noqa: F811
    """The SVGP's inputs (features, DBA targets, noise) equal JAX's, and so do
    the moments after one epoch (two steps)."""
    from bayesian_ensembling_tpu.ops import svgp as jsvgp
    from bayesian_ensembling_tpu_torch.ops import svgp as tsvgp

    seen = {"jax": [], "torch": []}

    def recording(pkg, fit):
        def wrapped(x, y, noise, **kw):
            seen[pkg].append((np.asarray(x), np.asarray(y), np.asarray(noise), kw))
            return fit(x, y, noise, **kw)
        return wrapped

    monkeypatch.setattr(jsvgp, "fit_predict_svgp", recording("jax", jsvgp.fit_predict_svgp))
    monkeypatch.setattr(tsvgp, "fit_predict_svgp", recording("torch", tsvgp.fit_predict_svgp))
    kw = dict(n_optim_nits=1, dba_iterations=2, n_inducing=16, minibatch_size=24)
    shape = dict(r=4, t=8, la=2, lo=3)
    with pytest.warns(UserWarning, match="svgp"):
        jem = jgp3d.GPDTW3D(mode="svgp", dtype=jnp.float64)
    with pytest.warns(UserWarning, match="svgp"):
        tem = tgp3d.GPDTW3D(mode="svgp", dtype=torch.float64)
    jposts = jem.fit_collection(jdata.ModelCollection(models("jax", **shape)), **kw)
    tposts = tem.fit_collection(tbet.ModelCollection(models("torch", **shape)), device="cpu", **kw)
    for (jx, jy, jn, jkw), (tx, ty, tn, tkw) in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tn, jn, rtol=1e-12)
        assert tkw == jkw and tkw["n_optim_nits"] == 2
    for jp, tp_ in zip(jposts, tposts):
        assert tp_.gaussian.mean.shape == (8 * 2 * 3,)
        for g, w in zip(_moments(tp_), _moments(jp)):
            np.testing.assert_allclose(g, w, rtol=0, atol=SVGP_TOL)


def test_svgp_mode_subgradient_dba_runs_and_refine_is_refused():
    shape = dict(r=2, t=8, la=2, lo=2)
    with pytest.warns(UserWarning, match="svgp"):
        em = tgp3d.GPDTW3D(mode="svgp", dtype=torch.float64)
    post = em.fit(models("torch", seeds=(4,), **shape)[0], n_optim_nits=2, dba_iterations=3,
                  dba_method="subgradient", n_inducing=8, minibatch_size=16, device="cpu")
    assert np.isfinite(post.gaussian.mean.numpy()).all()
    with pytest.raises(ValueError, match="batched mode only"):
        em.fit(models("torch", seeds=(4,), **shape)[0], refine_f64=True, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        tgp3d.GPDTW3D(mode="nope").fit(models("torch", seeds=(4,), **shape)[0], device="cpu")


@pytest.mark.parametrize("weighter,sigma_mode", [("CRPSWeight", "w2"),
                                                 ("LogLikelihoodWeight", "w2"),
                                                 ("CRPSWeight", "mixture")])
def test_run_gridded_scenario_matches_jax(weighter, sigma_mode):
    kw = dict(n_optim_nits=5, dba_iterations=2, sigma_mode=sigma_mode)
    jw, jb = jpipeline.run_gridded_scenario(
        jdata.ModelCollection(models("jax")), observations("jax"),
        weighter=getattr(jweights, weighter)(), emulator=jgp3d.GPDTW3D(dtype=jnp.float64), **kw)
    tw, tb = tbet.run_gridded_scenario(
        tbet.ModelCollection(models("torch")), observations("torch"),
        weighter=getattr(tbet, weighter)(), emulator=tgp3d.GPDTW3D(dtype=torch.float64),
        device="cpu", **kw)
    assert tw.dims == ("model", "time", "latitude", "longitude")
    np.testing.assert_allclose(tw.values, np.asarray(jw.values), rtol=0, atol=TOL)
    assert tb.mean.dims == ("time", "latitude", "longitude")
    np.testing.assert_allclose(tb.mean.values, np.asarray(jb.mean.values), rtol=0, atol=TOL)
    np.testing.assert_allclose(tb.stddev.values, np.asarray(jb.stddev.values), rtol=0, atol=TOL)


def test_run_gridded_scenario_refine_f64_matches_jax():
    """With ``refine_f64`` the float32 fit's moments are recomputed in
    float64 and the tail runs in float64: the same on both sides up to the
    round-off of the two float32 fits."""
    kw = dict(n_optim_nits=5, dba_iterations=2, refine_f64=True, refine_cell_chunk=7)
    jw, jb = jpipeline.run_gridded_scenario(jdata.ModelCollection(models("jax")),
                                            observations("jax"), refine_device="cpu", **kw)
    tmc = tbet.ModelCollection(models("torch"))
    tw, tb = tbet.run_gridded_scenario(tmc, observations("torch"), device="cpu", **kw)
    assert tmc[0].distribution.gaussian.mean.dtype == torch.float64
    assert tb.gaussian.mean.dtype == torch.float64
    np.testing.assert_allclose(tw.values, np.asarray(jw.values), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.mean.values, np.asarray(jb.mean.values), rtol=0, atol=1e-4)


def test_run_gridded_scenario_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbet.run_gridded_scenario(tbet.ModelCollection(models("torch")), observations("torch"))


def test_gridded_gp_params_carry():
    rng = np.random.default_rng(0)
    ls, var = rng.normal(size=(2, 5)), rng.normal(size=(2, 5))
    jp = jstep.gp_ops.GPParams(raw_lengthscale=jnp.asarray(ls), raw_variance=jnp.asarray(var))
    tp_ = convert.gridded_gp_params_from_jax(jp, "cpu", torch.float64)
    assert tp_.raw_lengthscale.shape == (2, 5)
    back = convert.gp_params_to_numpy(tp_)
    np.testing.assert_array_equal(back["raw_lengthscale"], ls)
    np.testing.assert_array_equal(back["raw_variance"], var)
    with pytest.raises(ValueError, match=r"\(M, C\)"):
        convert.gridded_gp_params_from_jax(
            jstep.gp_ops.GPParams(raw_lengthscale=jnp.asarray(ls[0]), raw_variance=jnp.asarray(var[0])),
            "cpu", torch.float64)


def test_svgp_params_carry():
    from bayesian_ensembling_tpu.ops import svgp as jsvgp

    params = jax.tree.map(np.asarray, jsvgp._svgp_init(jnp.asarray(np.eye(6)[:, :5]), 4))
    tp_ = convert.svgp_params_from_jax(params, "cpu", torch.float64)
    assert set(tp_) == {"raw_ls", "raw_var", "z", "m", "ls_flat"}
    for k in params:
        np.testing.assert_array_equal(tp_[k].numpy(), params[k])


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_load_model_collection_round_trips(tmp_path, saver):
    """``load_model_collection`` reads a fitted gridded collection saved by
    either package, posteriors included."""
    path = os.path.join(tmp_path, "mc.npz")
    if saver == "jax":
        mc = jdata.ModelCollection(models("jax"))
        mc.fit(jgp3d.GPDTW3D(dtype=jnp.float64), n_optim_nits=2, dba_iterations=1)
    else:
        mc = tbet.ModelCollection(models("torch"))
        mc.fit(tgp3d.GPDTW3D(dtype=torch.float64), n_optim_nits=2, dba_iterations=1, device="cpu")
    mc.save(path)
    got = tbet.load_model_collection(path, device="cpu")
    assert got.model_names == mc.model_names
    for a, b in zip(got, mc):
        np.testing.assert_array_equal(a.data.values, np.asarray(b.data.values))
        np.testing.assert_array_equal(a.distribution.gaussian.var.numpy(),
                                      np.asarray(b.distribution.gaussian.var))


def test_package_exports_match_the_jax_package():
    import bayesian_ensembling_tpu as jbet

    for name in ("GPDTW3D", "load_model_collection", "__version__"):
        assert name in tbet.__all__ and name in jbet.__all__
    assert tbet.__version__ == jbet.__version__
