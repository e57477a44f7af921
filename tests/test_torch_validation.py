"""The port's perfect-model test (``validation.py``) against the JAX package,
in float64 on the CPU, at a small size (M = 3-5 models, R = 2-4 ragged
realisations, T = 10-16).

Both packages get the same numpy inputs.  Prefit posteriors are fitted once
in the JAX package (``GPDTW1D``, 5 Adam steps) and carried across with
``convert.collection_from_jax``, so no fit sits between the two sides of the
prefit comparisons.

Tolerances: ``batched_pmt`` and the fold loop on shared posteriors 1e-9
relative to each column's largest value (the same arithmetic, another
summation order; the W2 goes through ``eigh``); the port's fold loop against
its own ``batched_pmt`` 1e-9 the same way; fresh fits at 0 Adam steps 1e-8
(the DBA target and the posterior solve of each side).  The end of the file
runs ``chip_smoke.py``'s phase-11 helpers at a tiny size on the CPU.
"""

import functools
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import bayesian_ensembling_tpu as jbet
import bayesian_ensembling_tpu_torch as tbet
from bayesian_ensembling_tpu import coords as jcoords
from bayesian_ensembling_tpu import validation as jvalidation
from bayesian_ensembling_tpu.models.gp_dtw import GPDTW1D as JGPDTW1D
from bayesian_ensembling_tpu.models.mean_field import MeanField as JMeanField
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch import coords as tcoords
from bayesian_ensembling_tpu_torch import validation as tvalidation

torch.set_num_threads(1)

KINDS = ("crps", "loglik", "ksd", "inverse_square", "uniform")
WEIGHTERS = ("ContinuousRankedProbabilityScoreWeight", "LogLikelihoodWeight",
             "KernelSteinDiscrepancyWeight", "InverseSquareWeight", "UniformWeight")
WEIGHTER_CLASS = {"ContinuousRankedProbabilityScoreWeight": "CRPSWeight",
                  "KernelSteinDiscrepancyWeight": "KSDWeight"}


def weighter(pkg, name):
    return getattr(jbet if pkg == "jax" else tbet, WEIGHTER_CLASS.get(name, name))


def close_rel(got, want, tol):
    """|got - want| <= tol x each column's largest |want| (at least 1e-12)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-12)
    gap = (np.abs(got - want) / scale).max()
    assert gap <= tol, gap


def frame_close(got, want, tol):
    assert list(got.columns) == list(want.columns)
    assert list(got.iloc[:, 0]) == list(want.iloc[:, 0])
    close_rel(got.iloc[:, 1:].to_numpy(float), want.iloc[:, 1:].to_numpy(float), tol)


# ------------------------------------------------------------------ inputs
def arrays(seed, n_models=4, counts=(2, 3, 4), t=14, start="2000-01"):
    """(values, time, name) triples: realisations around a per-model level."""
    rng = np.random.default_rng(seed)
    time = (np.datetime64(start, "M") + np.arange(t)).astype("datetime64[ns]") + np.timedelta64(
        14, "D")
    return [(rng.normal(size=(counts[i % len(counts)], t)) + 0.3 * i, time, f"model{i}")
            for i in range(n_models)]


def build(pkg, triples):
    mod, da = (jbet, jcoords.DimArray) if pkg == "jax" else (tbet, tcoords.DimArray)
    return mod.ModelCollection([
        mod.ProcessModel(da(v.copy(), ("realisation", "time"), {"time": tm.copy()}, name="tas"),
                         name)
        for v, tm, name in triples
    ])


@functools.lru_cache(maxsize=None)
def _jax_prefit(seed, n_models, t, mixed):
    hind, fore = build("jax", arrays(seed, n_models, t=t)), build("jax", arrays(seed + 1, n_models,
                                                                                t=t))
    for mc in (hind, fore):
        mc.fit(JGPDTW1D(dtype=np.float64), n_optim_nits=5, dba_iterations=2)
    if mixed:  # one diagonal member among full-covariance ones
        hind[1].distribution = JMeanField(dtype=np.float64).fit(hind[1], n_optim_nits=0)
    return hind._to_blobs(), fore._to_blobs()


def prefit(seed=0, n_models=4, t=14, mixed=False):
    """Fitted JAX collections and the port's copies of them."""
    from bayesian_ensembling_tpu.data import ModelCollection as JMC

    hb, fb = _jax_prefit(seed, n_models, t, mixed)
    jh, jf = (JMC._from_blobs(b, list(b)) for b in (hb, fb))
    th, tf = (convert.collection_from_jax(b, device="cpu") for b in (hb, fb))
    return jh, jf, th, tf


def pmt(pkg, hind, fore, name, ensemble="Barycentre", **kw):
    mod = jbet if pkg == "jax" else tbet
    return (jvalidation if pkg == "jax" else tvalidation).PerfectModelTest(
        hind, fore, None, weighter(pkg, name), getattr(mod, ensemble), "testssp", **kw)


# ------------------------------------------------------------- batched_pmt
@pytest.mark.parametrize("sigma", [{}, {"sigma_mode": "compat"}, {"sigma_mode": "mixture"},
                                   {"compat_fixed_point": True}], ids=["w2", "compat", "mixture",
                                                                       "compat_fixed_point"])
@pytest.mark.parametrize("kind", KINDS)
def test_batched_pmt_matches_jax(kind, sigma):
    jh, jf, th, tf = prefit()
    want = jvalidation.batched_pmt(jh, jf, kind, **sigma)
    got = tbet.batched_pmt(th, tf, kind, **sigma)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    close_rel(got, want, 1e-9)


@pytest.mark.parametrize("opts", [{"include_sim": True}, {"pad_shape": (6, 7)},
                                  {"include_sim": True, "pad_shape": (5, 6)}],
                         ids=["sim", "pad", "sim-pad"])
@pytest.mark.parametrize("kind", KINDS)
def test_batched_pmt_include_sim_and_pad_shape_match_jax(kind, opts):
    jh, jf, th, tf = prefit(seed=3, n_models=3, t=10)
    want = jvalidation.batched_pmt(jh, jf, kind, **opts)
    got = tbet.batched_pmt(th, tf, kind, **opts)
    close_rel(got, want, 1e-9)
    if "pad_shape" in opts:  # padding is invisible to the real folds
        close_rel(got, tbet.batched_pmt(th, tf, kind, include_sim=opts.get("include_sim", False)),
                  1e-12)


def test_batched_pmt_details_match_jax():
    jh, jf, th, tf = prefit(seed=5, n_models=3, t=10)
    jm, jd = jvalidation.batched_pmt(jh, jf, "loglik", pad_shape=(4, 5), return_details=True)
    tm, td = tbet.batched_pmt(th, tf, "loglik", pad_shape=(4, 5), return_details=True)
    close_rel(tm, jm, 1e-9)
    assert set(td) == set(jd)
    for key in jd:
        assert td[key].shape == jd[key].shape, key
        close_rel(td[key], jd[key], 1e-9)


@pytest.mark.parametrize("include_sim", [False, True])
@pytest.mark.parametrize("name", ["LogLikelihoodWeight", "ContinuousRankedProbabilityScoreWeight"])
def test_mixed_collections_match_jax(name, include_sim):
    """A collection mixing full-covariance and diagonal posteriors: each
    model is scored on its own log-likelihood branch, and include_sim picks
    full-covariance W2 per fold (the fold without the diagonal member)."""
    jh, jf, th, tf = prefit(seed=7, n_models=3, t=10, mixed=True)
    assert not th[1].distribution.is_full_cov and th[0].distribution.is_full_cov
    want = pmt("jax", jh, jf, name, include_sim=include_sim).run(use_prefit_models=True)
    tp = pmt("torch", th, tf, name, include_sim=include_sim)
    frame_close(tp.run(use_prefit_models=True), want, 1e-9)
    frame_close(tp.run_batched(), want, 1e-9)


# -------------------------------------------------------- PerfectModelTest
@pytest.mark.parametrize("name", WEIGHTERS)
def test_prefit_run_matches_jax_and_run_batched(name):
    jh, jf, th, tf = prefit()
    want = pmt("jax", jh, jf, name).run(use_prefit_models=True)
    tp = pmt("torch", th, tf, name)
    got = tp.run(use_prefit_models=True)
    frame_close(got, want, 1e-9)
    frame_close(tp.run_batched(), got, 1e-9)
    frame_close(tp.run_batched(pad_shape=(6, 6)), got, 1e-9)


@pytest.mark.parametrize("emulator", ["MeanField", "GPDTW1D"])
def test_fresh_fit_run_matches_jax_and_leaves_the_callers_collections_unfitted(emulator):
    """``run(n_optim_nits=0)``: every fold fits the remaining models and the
    pseudo truth afresh (on the CPU here, through ``device="cpu"``)."""
    triples_h, triples_f = arrays(11, 3, t=12), arrays(12, 3, t=12)
    jh, jf = build("jax", triples_h), build("jax", triples_f)
    th, tf = build("torch", triples_h), build("torch", triples_f)
    jem = getattr(jbet, emulator)
    tem = getattr(tbet, emulator)
    fit_kw = {"dba_iterations": 2} if emulator == "GPDTW1D" else {}
    want = jvalidation.PerfectModelTest(
        jh, jf, lambda: jem(dtype=np.float64), jbet.LogLikelihoodWeight, jbet.Barycentre, "s",
    ).run(n_optim_nits=0, **fit_kw)
    got = tvalidation.PerfectModelTest(
        th, tf, lambda: tem(dtype=torch.float64), tbet.LogLikelihoodWeight, tbet.Barycentre, "s",
    ).run(n_optim_nits=0, device="cpu", **fit_kw)
    frame_close(got, want, 1e-8)
    assert all(pm.distribution is None for mc in (th, tf) for pm in mc)
    assert np.isfinite(got.iloc[:, 1:].to_numpy(float)).all()


def test_fresh_fits_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    th, tf = build("torch", arrays(13, 3, t=10)), build("torch", arrays(14, 3, t=10))
    tp = tvalidation.PerfectModelTest(th, tf, tbet.MeanField, tbet.UniformWeight,
                                      tbet.Barycentre, "s")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.run(n_optim_nits=0)
    assert all(pm.distribution is None for pm in th)


def test_pmt_constructor_and_mismatched_collections(tmp_path):
    th, tf = build("torch", arrays(15, 3, t=10)), build("torch", arrays(16, 2, t=10))
    with pytest.raises(ValueError, match="must match"):
        tvalidation.PerfectModelTest(th, tf, None, tbet.UniformWeight, tbet.Barycentre, "s")
    tf = build("torch", arrays(16, 3, t=10))
    tvalidation.PerfectModelTest(th, tf, None, tbet.UniformWeight, tbet.Barycentre, "s",
                                 save_dir=str(tmp_path / "out"))
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["csvs", "figs"]
    assert sorted(p.name for p in (tmp_path / "out" / "figs").iterdir()) == ["projs", "weights"]


# ------------------------------------------------------------------ guards
def test_batched_pmt_errors_match_jax():
    jh, jf, th, tf = prefit(seed=3, n_models=3, t=10)
    for fn, h, f in ((jvalidation.batched_pmt, jh, jf), (tbet.batched_pmt, th, tf)):
        with pytest.raises(ValueError, match="pad_shape"):
            fn(h, f, "crps", pad_shape=(2, 6))
        with pytest.raises(ValueError, match="unknown weight_kind"):
            fn(h, f, "nope")
    j1h, j1f, t1h, t1f = prefit(seed=17, n_models=1, t=8)
    for fn, h, f in ((jvalidation.batched_pmt, j1h, j1f), (tbet.batched_pmt, t1h, t1f)):
        with pytest.raises(ValueError, match="at least 2 models"):
            fn(h, f, "crps")
    j2h, j2f, t2h, t2f = prefit(seed=19, n_models=2, t=8)
    for pkg, h, f in (("jax", j2h, j2f), ("torch", t2h, t2f)):
        with pytest.raises(ValueError, match="at least 3 models"):
            pmt(pkg, h, f, "ContinuousRankedProbabilityScoreWeight", include_sim=True).run_batched()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_run_batched_guards(pkg):
    jh, jf, th, tf = prefit(seed=3, n_models=3, t=10)
    h, f = (jh, jf) if pkg == "jax" else (th, tf)
    with pytest.raises(ValueError, match="Barycentre"):
        pmt(pkg, h, f, "ContinuousRankedProbabilityScoreWeight", "WeightedModelMean").run_batched()
    with pytest.raises(ValueError, match="no batched scoring path"):
        pmt(pkg, h, f, "ModelSimilarityWeight").run_batched()
    test = pmt(pkg, h, f, "ContinuousRankedProbabilityScoreWeight")
    with pytest.raises(ValueError, match="save_dir"):
        test.run_batched(figures=True)
    mod = jbet if pkg == "jax" else tbet
    test.ensemble_method = lambda: mod.Barycentre()
    with pytest.raises(ValueError, match="needs run"):
        test.run_batched()
    unfitted = build(pkg, arrays(21, 3, t=10))
    with pytest.raises(ValueError, match="PREFIT"):
        pmt(pkg, unfitted, build(pkg, arrays(22, 3, t=10)),
            "ContinuousRankedProbabilityScoreWeight").run_batched()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_compat_warns_when_the_fixed_point_hits_its_cap(pkg):
    """A NaN forecast variance never converges: both paths warn, counting
    the points that hit the cap, and the w2 mode does not."""
    from bayesian_ensembling_tpu.data import ModelCollection as JMC

    jh, jf = build("jax", arrays(23, 3, t=10)), build("jax", arrays(24, 3, t=10))
    for mc in (jh, jf):
        mc.fit(JMeanField(dtype=np.float64))
    blobs = jf._to_blobs()
    blobs["m0/post/var"] = blobs["m0/post/var"].copy()
    blobs["m0/post/var"][2] = np.nan
    if pkg == "jax":
        h, f, fn = jh, JMC._from_blobs(blobs, list(blobs)), jvalidation.batched_pmt
    else:
        h = convert.collection_from_jax(jh._to_blobs(), device="cpu")
        f, fn = convert.collection_from_jax(blobs, device="cpu"), tbet.batched_pmt
    with pytest.warns(UserWarning, match=r"not converged for 3 point\(s\) across folds"):
        fn(h, f, "uniform", compat_fixed_point=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn(h, f, "uniform")


# -------------------------------------------------------- CSVs and figures
@pytest.mark.parametrize("include_sim", [False, True])
def test_csv_paths_and_columns_match_jax(tmp_path, include_sim):
    import pandas as pd

    jh, jf, th, tf = prefit(seed=3, n_models=3, t=10)
    for pkg, h, f in (("jax", jh, jf), ("torch", th, tf)):
        test = pmt(pkg, h, f, "ContinuousRankedProbabilityScoreWeight",
                   include_sim=include_sim, save_dir=str(tmp_path / pkg))
        test.run_batched()
    names = {pkg: sorted(os.listdir(tmp_path / pkg / "csvs")) for pkg in ("jax", "torch")}
    assert names["torch"] == names["jax"] == [
        "perfect_model_test_results_ContinuousRankedProbabilityScoreWeight"
        + ("_plus_sim" if include_sim else "") + "_testssp.csv"]
    want = pd.read_csv(tmp_path / "jax" / "csvs" / names["jax"][0], index_col=0)
    got = pd.read_csv(tmp_path / "torch" / "csvs" / names["torch"][0], index_col=0)
    frame_close(got, want, 1e-9)


def test_figures_have_the_jax_file_names(tmp_path):
    jh, jf, th, tf = prefit(seed=3, n_models=3, t=10)
    files = {}
    for pkg, h, f in (("jax", jh, jf), ("torch", th, tf)):
        pmt(pkg, h, f, "LogLikelihoodWeight", save_dir=str(tmp_path / pkg / "batched")).run_batched(
            figures=True)
        pmt(pkg, h, f, "LogLikelihoodWeight", save_dir=str(tmp_path / pkg / "loop")).run(
            use_prefit_models=True)
        files[pkg] = sorted(
            os.path.relpath(os.path.join(d, n), tmp_path / pkg)
            for d, _, ns in os.walk(tmp_path / pkg) for n in ns)
    assert files["torch"] == files["jax"]
    assert sum(n.endswith(".png") for n in files["torch"]) == 4 * len(th)


# ------------------------------------------------ chip_smoke.py's helpers
def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def test_chip_smoke_validation_gates():
    cs = _chip_smoke()
    want = np.array([[2.0, 0.1, 1.5, 0.08, -0.5, 0.2, 3.0, 0.1],
                     [-4.0, 0.2, 2.5, 0.12, 0.3, 0.3, 4.0, 0.2]])
    assert cs.pmt_gaps(want, want) == (0.0, 0.0)
    got = want.copy()
    got[1, 2] += 2e-3  # w2, degC
    got[0, 0] += 4e-3  # nll: relative to the column's largest |value| (4)
    got[0, 4] += 4e-3  # nll_mmm: relative to max(1, 0.5)
    degc, nll = cs.pmt_gaps(got, want)
    assert degc == pytest.approx(2e-3) and nll == pytest.approx(4e-3)
    assert cs.col_rel_gap(got, want) == pytest.approx(4e-3 / 0.5)  # nll_mmm's largest is 0.5
    assert cs.pmt_launches("loglik") == {"dba_update": 0, "dba_update_split": 0, "chol_solve": 0,
                                          "tri_inv": 0, "chol": 1, "dtw_cost": 0, "solve_vec": 2,
                                          "gram_matern32": 0, "gram_matern32_grad": 0}
    assert cs.pmt_launches("crps", n_folds=16)["chol"] == 16
    fits = cs.fold_fit_launches(16, 500)
    assert (fits["dba_update"], fits["chol_solve"], fits["tri_inv"], fits["chol"],
            fits["solve_vec"]) == (480, 48 * 501, 48 * 500, 16, 32)
    assert set(fits) == set(tbet.launch_counts())


def test_chip_smoke_validation_on_tiny_library_collections():
    """Phase 11's inputs at a tiny size with the plain versions: the
    in-memory collections of phase 9, fitted in float32, ``batched_pmt``
    under the campaign bucket against float64 at the same posteriors, and
    the fold loop against the batched function."""
    cs = _chip_smoke()
    inputs = cs.synthetic_flagship(0, scenarios=2, models=4, min_real_models=3, realisations=4,
                                   t_hist=12, t_ssp=8, obs_members=6)
    built, obs = cs.library_scenarios(tbet, inputs)
    hist, ssp = built[0]
    for mc in (hist, ssp):
        mc.fit(tbet.GPDTW1D(dtype=torch.float32), n_optim_nits=5, dba_iterations=2, device="cpu")
    h64, s64 = cs._posteriors_f64_on_cpu(tbet, hist), cs._posteriors_f64_on_cpu(tbet, ssp)
    for kind in cs.PMT_KINDS:
        got = tbet.batched_pmt(hist, ssp, kind, pad_shape=cs.PMT_PAD)
        want = tbet.batched_pmt(h64, s64, kind, pad_shape=cs.PMT_PAD)
        degc, nll = cs.pmt_gaps(got, want)
        assert degc < cs.PMT_DEGC and nll < cs.PMT_NLL_REL, kind
    test = tbet.PerfectModelTest(hist, ssp, None, tbet.LogLikelihoodWeight, tbet.Barycentre, "s0")
    names, loop = test._fold_scores(use_prefit_models=True)
    assert names == hist.model_names and loop.shape == (len(hist), 8)
    assert cs.col_rel_gap(loop, tbet.batched_pmt(hist, ssp, "loglik")) < cs.PMT_LOOP_REL


def test_chip_smoke_serving_helpers(tmp_path):
    """Phase 11's serving checks at a tiny size on the CPU: the results'
    HTTP round trip and the gridded artifact against the posterior it was
    built from."""
    cs = _chip_smoke()
    inputs = cs.synthetic_flagship(1, scenarios=2, models=3, min_real_models=2, realisations=3,
                                   t_hist=10, t_ssp=6, obs_members=4)
    built, obs = cs.library_scenarios(tbet, inputs)
    results = {f"s{i}": tbet.run_scenario(h, s, obs, f"s{i}", emulator=tbet.MeanField(),
                                          device="cpu")
               for i, (h, s) in enumerate(built)}
    ok, lines = cs.serve_roundtrip(tbet.serve.ProjectionService, results, str(tmp_path / "gmst"))
    assert ok, lines
    svc_cls = tbet.serve.ProjectionService
    original = svc_cls.__dict__["from_gridded"]
    with cs.recorded_gridded_posteriors(svc_cls) as rec:
        tbet.serve.build_gridded_artifacts(str(tmp_path / "grid"), lat=2, lon=3, n_models=2,
                                           n_realisations=2, n_steps=6, n_optim_nits=2,
                                           device="cpu")
    assert svc_cls.__dict__["from_gridded"] is original
    loaded = svc_cls.load(str(tmp_path / "grid"))
    assert cs.gridded_serve_gap(loaded, "gridded", rec.posteriors["gridded"]) < 1e-12


def test_model_means_take_the_posteriors_device_and_dtype():
    """The fold loop's multi-model mean is scored against float32
    posteriors: its host moments (float64 data) are held in the posteriors'
    dtype, as the JAX package holds them in its default float dtype."""
    th = build("torch", arrays(25, 3, t=10))
    th.fit(tbet.MeanField(dtype=torch.float32), device="cpu")
    mmm = tbet.MultiModelMean()(th)
    assert mmm.gaussian.mean.dtype == mmm.gaussian.var.dtype == torch.float32
    pooled = np.concatenate([pm.data.values for pm in th])
    np.testing.assert_allclose(mmm.gaussian.mean.numpy(), pooled.mean(0), rtol=1e-6)
    assert tbet.metrics.w2_between_posteriors(mmm, th[0].distribution) > 0
