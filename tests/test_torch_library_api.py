"""The port's library API (containers -> emulators -> weighters -> schemes
-> ``run_scenario``) against the JAX package, in float64 on the CPU, at a
small size (M = 3-4 models, 2-5 ragged realisations, T = 12-24, 6
observation members).

Both packages get the same numpy inputs.  Weighters, schemes and metrics
are compared on the *same* posteriors, built once in the JAX package and
carried across with ``convert.collection_from_jax``, so no fit sits between
the two sides.

Tolerances (absolute, on O(1) anomalies and on weights that sum to one):
closed forms 1e-10; weights, schemes and metrics on shared posteriors 1e-9;
a 20-step mean-field refinement 1e-9; a 30-step GP fit with its full
covariance 1e-8 (round-off of different solvers, amplified mildly by the
fit); the whole of ``run_scenario`` 1e-7.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bayesian_ensembling_tpu as jbet
import bayesian_ensembling_tpu_torch as tbet
from bayesian_ensembling_tpu import coords as jcoords
from bayesian_ensembling_tpu import metrics as jmetrics
from bayesian_ensembling_tpu import pipeline as jpipeline
from bayesian_ensembling_tpu import schemes as jschemes
from bayesian_ensembling_tpu.io import timeutils as jtime
from bayesian_ensembling_tpu.models import gp_dtw as jgp_dtw
from bayesian_ensembling_tpu.models import mean_field as jmean_field
from bayesian_ensembling_tpu.ops import distributions as jd
from bayesian_ensembling_tpu.ops import gp as jgp
from bayesian_ensembling_tpu.utils import config as jconfig
from bayesian_ensembling_tpu.utils import profiles as jprofiles
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch import coords as tcoords
from bayesian_ensembling_tpu_torch import metrics as tmetrics
from bayesian_ensembling_tpu_torch import pipeline as tpipeline
from bayesian_ensembling_tpu_torch import schemes as tschemes
from bayesian_ensembling_tpu_torch.io import timeutils as ttime
from bayesian_ensembling_tpu_torch.models import gp_dtw as tgp_dtw
from bayesian_ensembling_tpu_torch.models import mean_field as tmean_field
from bayesian_ensembling_tpu_torch.ops import gp as tgp
from bayesian_ensembling_tpu_torch.parallel import step as tstep
from bayesian_ensembling_tpu_torch.utils import config as tconfig
from bayesian_ensembling_tpu_torch.utils import profiles as tprofiles

torch.set_num_threads(1)

PACKAGES = pytest.mark.parametrize("pkg", ["jax", "torch"])


def close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ------------------------------------------------------------------ inputs
def yearly(t, start=1850):
    return (np.datetime64(str(start), "Y") + np.arange(t)).astype("datetime64[ns]")


def monthly(n, start="1961-01"):
    return (np.datetime64(start, "M") + np.arange(n)).astype("datetime64[ns]") + np.timedelta64(14, "D")


def gmst_series(rng, shape, t, slope):
    """A trend plus AR(1) noise, like an annual GMST anomaly."""
    noise = np.zeros(shape + (t,))
    eps = 0.1 * rng.normal(size=shape + (t,))
    for k in range(t):
        noise[..., k] = (0.6 * noise[..., k - 1] if k else 0.0) + eps[..., k]
    return slope * np.linspace(0.0, 1.0, t) + noise


def model_arrays(seed, counts=(2, 5, 3), t=16, slope=1.0, start=1850):
    rng = np.random.default_rng(seed)
    time = yearly(t, start)
    return [(gmst_series(rng, (r,), t, slope) + 0.2 * rng.normal(), time, f"model{i}")
            for i, r in enumerate(counts)]


def build(pkg, arrays):
    """The same (values, time, name) triples as a collection of either package."""
    mod, da = (jbet, jcoords.DimArray) if pkg == "jax" else (tbet, tcoords.DimArray)
    return mod.ModelCollection([
        mod.ProcessModel(da(v.copy(), ("realisation", "time"), {"time": time.copy()}, name="tas"), name)
        for v, time, name in arrays
    ])


def build_obs(pkg, seed, t=16, r_obs=6):
    rng = np.random.default_rng(seed)
    arrays = [(gmst_series(rng, (r_obs,), t, 1.0), yearly(t), "Observations")]
    return build(pkg, arrays)[0]


def make_cov(rng, n):
    x = np.sort(rng.normal(size=n))
    d = np.abs(x[:, None] - x[None, :])
    return 0.05 * ((1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
                   + np.diag(rng.uniform(0.05, 0.2, n)))


def shared_posteriors(kind, seed=0, counts=(2, 5, 3, 4), t=16):
    """A JAX collection with synthetic posteriors (``full``, ``diag`` or
    ``mixed``) and the port's copy of it, carried across by ``convert``."""
    rng = np.random.default_rng(100 + seed)
    jmc = build("jax", model_arrays(seed, counts, t))
    for i, pm in enumerate(jmc):
        mean = gmst_series(rng, (), t, 1.0) + 0.1 * rng.normal()
        cov = make_cov(rng, t)
        if kind == "full" or (kind == "mixed" and i == 1):
            g = jd.FullCovGaussian(jnp.asarray(mean), jnp.asarray(cov))
        else:
            g = jd.DiagGaussian(jnp.asarray(mean), jnp.asarray(np.diag(cov).copy()))
        pm.distribution = jbet.Posterior(gaussian=g, template=pm.blank_template())
    tmc = convert.collection_from_jax(jmc._to_blobs(), device="cpu")
    return jmc, tmc


# ---------------------------------------------------- coords and timeutils
@PACKAGES
def test_dimarray_behaves_as_the_original(pkg):
    """The cases ``tests/test_data.py`` leans on, same answers from the copy."""
    da_cls = jcoords.DimArray if pkg == "jax" else tcoords.DimArray
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(3, 12, 2))
    da = da_cls(vals, ("realisation", "time", "cell"), {"time": monthly(12)}, name="tas")
    assert da.shape == (3, 12, 2) and da.sizes() == {"realisation": 3, "time": 12, "cell": 2}
    np.testing.assert_allclose(da.mean("realisation").values, vals.mean(0))
    assert da.mean("realisation").dims == ("time", "cell")
    np.testing.assert_allclose(da.std("time").values, vals.std(1))
    np.testing.assert_allclose(da.isel(realisation=1).values, vals[1])
    w = da_cls(np.arange(3.0), ("realisation",), {})
    np.testing.assert_allclose((w * da).values, vals * np.arange(3.0)[:, None, None])
    grown = w.expand_dims("time", size=12, coord=monthly(12), axis=1)
    assert grown.dims == ("realisation", "time") and grown.shape == (3, 12)
    assert da.transpose("time", "cell", "realisation").shape == (12, 2, 3)
    assert da.sel_time("1961-03-01", "1961-06-30").shape == (3, 4, 2)
    with pytest.raises(ValueError):
        da_cls(vals, ("a", "b"), {})


def test_dimarray_and_timeutils_copies_agree_with_the_originals():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(4, 60, 3))
    time = monthly(60)
    for fn in ("months_of", "years_of"):
        np.testing.assert_array_equal(getattr(ttime, fn)(time), getattr(jtime, fn)(time))
    window = ("1961-01-01", "1963-12-31")
    clim = ttime.monthly_climatology(vals, time, window)
    np.testing.assert_array_equal(clim, jtime.monthly_climatology(vals, time, window))
    np.testing.assert_array_equal(ttime.apply_climatology(vals, time, clim),
                                  jtime.apply_climatology(vals, time, clim))
    for freq in ("M", "Q", "Y"):
        got, got_t = ttime.resample_mean(vals, time, freq, time_axis=1)
        want, want_t = jtime.resample_mean(vals, time, freq, time_axis=1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_t, want_t)
    raw = np.array([0.0, 31.0, 59.5])
    np.testing.assert_array_equal(ttime.decode_cf_time(raw, "days since 1850-01-01"),
                                  jtime.decode_cf_time(raw, "days since 1850-01-01"))
    a = tcoords.DimArray(vals, ("realisation", "time", "cell"), {"time": time})
    b = jcoords.DimArray(vals, ("realisation", "time", "cell"), {"time": time})
    np.testing.assert_array_equal((a - a.mean("time")).values, (b - b.mean("time")).values)
    assert tconfig.GPRParameters().to_dict() == jconfig.GPRParameters().to_dict()
    with pytest.raises(ValueError):
        tconfig.GPRParameters(dba_method="medoid")


# ------------------------------------------------------------- containers
@pytest.mark.parametrize("spatial", [(), (3,)])
def test_process_model_and_anomaly_match_jax(spatial):
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(3, 48) + spatial)
    dims = ("realisation", "time") + tuple(f"dim{i}" for i in range(len(spatial)))
    time = monthly(48)
    jpm = jbet.ProcessModel(jcoords.DimArray(vals.copy(), dims, {"time": time}), "m")
    tpm = tbet.ProcessModel(tcoords.DimArray(vals.copy(), dims, {"time": time}), "m")
    assert tpm.n_realisations == 3 and tpm.ndim == jpm.ndim and len(tpm) == 3
    assert tpm.max_val == jpm.max_val and tpm.min_val == jpm.min_val
    np.testing.assert_array_equal(tpm.mean_across_realisations.values,
                                  jpm.mean_across_realisations.values)
    np.testing.assert_array_equal(tpm.std_across_realisations.values,
                                  jpm.std_across_realisations.values)
    assert np.isnan(tpm.blank_template().values).all()
    window = ("1961-01-01", "1963-12-31")
    for freq in (None, "Y"):
        ja = jpm.calculate_anomaly(climatology_dates=window, resample_freq=freq)
        ta = tpm.calculate_anomaly(climatology_dates=window, resample_freq=freq)
        np.testing.assert_array_equal(ta.data.values, ja.data.values)
        np.testing.assert_array_equal(ta.time, ja.time)
        np.testing.assert_array_equal(ta.climatology, ja.climatology)
        assert ta.name == ja.name
    again = tpm.calculate_anomaly(climatology=ta.climatology)
    np.testing.assert_array_equal(again.data.values,
                                  tpm.calculate_anomaly(climatology_dates=window).data.values)
    with pytest.raises(ValueError, match="12 monthly"):
        tpm.calculate_anomaly(climatology=np.zeros(11))


def test_process_model_contract_errors():
    vals = np.zeros((2, 5))
    with pytest.raises(TypeError):
        tbet.ProcessModel(vals, "bad")
    with pytest.raises(ValueError, match="realisation"):
        tbet.ProcessModel(tcoords.DimArray(vals.T, ("time", "realisation"), {}), "bad")
    nan = vals.copy()
    nan[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        tbet.ProcessModel(tcoords.DimArray(nan, ("realisation", "time"), {}), "bad")
    with pytest.raises(ValueError, match="at least one"):
        tbet.ModelCollection([])


def test_collection_basics_and_padded_stack_match_jax():
    arrays = model_arrays(3, counts=(2, 5, 3))
    jmc, tmc = build("jax", arrays), build("torch", arrays)
    assert tmc.number_of_models == 3 and tmc.model_names == jmc.model_names
    assert tmc.max_realisations == 5 and tmc[1].name == "model1" and len(list(tmc)) == 3
    assert tmc.max_val == jmc.max_val and tmc.min_val == jmc.min_val
    assert tmc.distributions() == {"model0": None, "model1": None, "model2": None}
    for kw in (dict(), dict(dtype=np.float64, r_target=7)):
        got, got_mask = tmc.padded_stack(**kw)
        want, want_mask = jmc.padded_stack(**kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_mask, want_mask)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError, match="r_target"):
        tmc.padded_stack(r_target=2)


def test_collection_time_axis_checks():
    arrays = model_arrays(4, counts=(2, 2))
    shifted = [arrays[0], (arrays[1][0], arrays[1][1] + np.timedelta64(1, "D"), "b")]
    with pytest.warns(UserWarning, match="naive fix"):
        mc = build("torch", shifted)
    np.testing.assert_array_equal(mc[0].time, mc[1].time)
    short = [arrays[0], (arrays[1][0][:, :10], arrays[1][1][:10], "b")]
    with pytest.raises(ValueError, match="LENGTHS"):
        build("torch", short)


@pytest.mark.parametrize("kind", ["full", "diag"])
def test_npz_checkpoint_loads_in_the_other_package(tmp_path, kind):
    """Saved by either package, loaded by the other: data, coords,
    climatology and posterior moments survive unchanged."""
    jmc, tmc = shared_posteriors(kind)
    jmc[0].climatology = np.arange(12.0)
    tmc[0].climatology = np.arange(12.0)
    tmc[2].distribution = None
    jmc[2].distribution = None

    def same(a, b):
        assert a.model_names == b.model_names
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa.data.values, pb.data.values)
            np.testing.assert_array_equal(pa.time, pb.time)
            assert pa.data.dims == pb.data.dims
            assert (pa.distribution is None) == (pb.distribution is None)
            if pa.distribution is not None:
                arr_a, arr_b = pa.distribution.to_arrays(), pb.distribution.to_arrays()
                assert sorted(arr_a) == sorted(arr_b) == sorted(["cov" if kind == "full" else "var", "mean"])
                for k in arr_a:
                    np.testing.assert_array_equal(arr_a[k], arr_b[k])
                    assert arr_a[k].dtype == arr_b[k].dtype
        np.testing.assert_array_equal(a[0].climatology, b[0].climatology)
        assert a[1].climatology is None and b[1].climatology is None

    jmc.save(str(tmp_path / "from_jax.npz"))
    same(tbet.ModelCollection.load(str(tmp_path / "from_jax.npz"), device="cpu"), jmc)
    tmc.save(str(tmp_path / "from_torch"))  # extensionless: numpy appends .npz
    same(jbet.ModelCollection.load(str(tmp_path / "from_torch")), tmc)
    same(tbet.ModelCollection.load(str(tmp_path / "from_torch"), device="cpu"), tmc)
    # The two packages write the same archive members.
    with np.load(str(tmp_path / "from_jax.npz")) as a, np.load(str(tmp_path / "from_torch.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError, match="A7b-2"):
        tmc.save(str(tmp_path / "ckpt"), backend="orbax")
    with pytest.raises(NotImplementedError, match="A7b-2"):
        tbet.ModelCollection.load(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tmc.save(str(tmp_path / "x"), backend="pickle")


def test_posterior_container():
    _, tmc = shared_posteriors("full")
    post = tmc[0].distribution
    assert post.is_full_cov and post.mean.dims == ("time",) and post.mean.name == "posterior mean"
    close(post.variance.values, torch.diagonal(post.gaussian.cov), 0)
    close(post.stddev.values ** 2, post.variance.values, 1e-15)
    draw = post.sample(torch.Generator().manual_seed(0))
    assert draw.shape == (16,) and np.isfinite(draw.values).all()
    assert post.sample().shape == (16,)
    assert post.log_prob(post.mean.values).shape == ()
    assert tmc[0].posterior is post
    ax = post.plot_temporally(n_sigma=(2,))  # the plotters are ported
    assert len(ax.lines) == 1 and len(ax.collections) == 1
    jpost = jbet.Posterior(jd.DiagGaussian(jnp.arange(16.0), jnp.ones(16)),
                           build("jax", model_arrays(0))[0].blank_template())
    back = convert.posterior_from_jax(jpost.to_arrays(), jpost.template, device="cpu")
    assert not back.is_full_cov and back.gaussian.mean.dtype == torch.float64
    close(back.mean.values, np.arange(16.0), 0)
    np.testing.assert_array_equal(back.template.time, jpost.template.time)


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    arrays = model_arrays(5)
    mc, obs = build("torch", arrays), build_obs("torch", 5)
    for em in (tbet.GPDTW1D(), tbet.MeanField()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mc.fit(em, n_optim_nits=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbet.run_scenario(mc, build("torch", arrays), obs, n_optim_nits=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbet.refine_posterior_f64(np.zeros((1, 2, 4)), np.ones((1, 2), bool),
                                  tgp.init_params(1, device="cpu", dtype=torch.float32))
    jmc, _ = shared_posteriors("diag")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.collection_from_jax(jmc._to_blobs(), device="cuda")
    assert mc[0].distribution is None


# --------------------------------------------------------------- emulators
def test_mean_field_closed_form_matches_jax_exactly():
    arrays = model_arrays(6, counts=(1, 4, 3))  # a single-realisation member: the 1e-8 floor
    jmc, tmc = build("jax", arrays), build("torch", arrays)
    jmc.fit(jbet.MeanField(dtype=jnp.float64))
    tmc.fit(tbet.MeanField(dtype=torch.float64), device="cpu")
    for jp, tp_ in zip(jmc, tmc):
        close(tp_.distribution.gaussian.mean, jp.distribution.gaussian.mean, 0)
        close(tp_.distribution.gaussian.var, jp.distribution.gaussian.var, 0)
        assert not tp_.distribution.is_full_cov
    assert float(tmc[0].distribution.gaussian.var.min()) == 1e-8
    one = tbet.MeanFieldApproximation(dtype=torch.float64).fit(tmc[1], device="cpu")
    close(one.gaussian.mean, tmc[1].distribution.gaussian.mean, 0)
    assert tbet.MeanField().fit(tmc[1], device="cpu").gaussian.mean.dtype == torch.float32


def test_mean_field_refinement_matches_jax():
    """20 Adam steps from a perturbed start; 1e-9."""
    rng = np.random.default_rng(7)
    block = gmst_series(rng, (3, 4), 12, 1.0)
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 1, 1, 0]], bool)
    block[~mask] = 0.0
    mean0 = block.mean(axis=1) + 0.05
    var0 = np.full((3, 12), 0.02)
    want = jmean_field._refine_batch(jnp.asarray(block), jnp.asarray(mask), jnp.asarray(mean0),
                                     jnp.asarray(var0), 20, 0.01)
    got = tmean_field._refine_batch(torch.from_numpy(block), torch.from_numpy(mask),
                                    torch.from_numpy(mean0), torch.from_numpy(var0), 20, 0.01)
    for g, w in zip(got, want):
        close(g, w, 1e-9)
    # Through ``fit`` the refinement starts AT the closed-form optimum, where
    # the gradient is round-off and Adam's normalisation turns it into steps
    # of either sign: the two packages then agree only to the size of those
    # steps (1e-3 here), so the wiring is held to ``_refine_batch`` exactly.
    arrays = model_arrays(8, counts=(2, 4))
    jmc, tmc = build("jax", arrays), build("torch", arrays)
    jmc.fit(jbet.MeanField(dtype=jnp.float64), n_optim_nits=20)
    tmc.fit(tbet.MeanField(dtype=torch.float64), n_optim_nits=20, device="cpu")
    block, mask = tmc.padded_stack(dtype=np.float64)
    mean0, var0 = tmean_field._masked_moments(block, mask)
    direct = tmean_field._refine_batch(torch.from_numpy(block), torch.from_numpy(mask),
                                       torch.from_numpy(mean0), torch.from_numpy(var0), 20, 0.01)
    for i, (jp, tp_) in enumerate(zip(jmc, tmc)):
        assert torch.equal(tp_.distribution.gaussian.mean, direct[0][i])
        assert torch.equal(tp_.distribution.gaussian.var, direct[1][i])
        close(tp_.distribution.gaussian.mean, jp.distribution.gaussian.mean, 1e-3)
        close(tp_.distribution.gaussian.var, jp.distribution.gaussian.var, 1e-3)


def block_and_mask(seed, m=3, r=4, t=14):
    rng = np.random.default_rng(seed)
    block = gmst_series(rng, (m, r), t, 1.0) + 0.2 * rng.normal(size=(m, 1, 1))
    counts = np.array([2, r, 3][:m])
    mask = np.arange(r)[None, :] < counts[:, None]
    block[~mask] = 0.0
    return block, mask


@pytest.mark.parametrize("kernel_name", ["matern32", "rbf"])
def test_single_model_gp_api_matches_jax(kernel_name):
    rng = np.random.default_rng(9)
    t, d = 12, 3
    x, y, nv = rng.normal(size=(t, d)), rng.normal(size=t), rng.uniform(0.05, 0.3, t)
    jp, jl = jgp.fit_gp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(nv), kernel_name=kernel_name,
                        n_optim_nits=8)
    tp_, tl = tgp.fit_gp(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(nv),
                         kernel_name=kernel_name, n_optim_nits=8)
    close(tl, jl, 1e-9)
    close(tp_.raw_lengthscale, jp.raw_lengthscale, 1e-9)
    # At the same hyperparameters.
    p = convert.gp_params_from_jax(np.asarray(jp.raw_lengthscale)[None],
                                   np.asarray(jp.raw_variance)[None], "cpu", torch.float64)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(nv))
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(nv))
    kern = jgp.get_kernel(kernel_name)
    close(tgp.get_kernel(kernel_name)(p, args[0], args[0][:5]), kern(jp, jargs[0], jargs[0][:5]), 1e-12)
    close(tgp.nlml(p, *args, kernel_name=kernel_name), jgp.nlml(jp, *jargs, kernel=kern), 1e-10)
    for tf, jf in ((tgp.posterior, jgp.posterior), (tgp.posterior_marginals, jgp.posterior_marginals)):
        got, want = tf(p, *args, kernel_name=kernel_name), jf(jp, *jargs, kernel=kern)
        close(got[0], want[0], 1e-10)
        close(got[1], want[1], 1e-10)
    with pytest.raises(ValueError, match="unknown kernel"):
        tgp.get_kernel("periodic")
    with pytest.raises(ValueError, match="one model"):
        tgp.nlml(tgp.init_params(2, device="cpu", dtype=torch.float64), *args)


def test_emulate_batch_mean_and_full_covariance_match_jax():
    """30 Adam steps; mean, full covariance and the NLML trace to 1e-8."""
    block, mask = block_and_mask(10)
    kw = dict(n_optim_nits=30, dba_iterations=3)
    want = jgp_dtw.emulate_batch(jnp.asarray(block), jnp.asarray(mask), return_params=True, **kw)
    got = tgp_dtw.emulate_batch(torch.from_numpy(block), torch.from_numpy(mask), return_params=True,
                                **kw)
    assert got[1].shape == (3, 14, 14) and got[2].shape == (3, 30) and len(got) == 6
    close(got[0], want[0], 1e-8)
    close(got[1], want[1], 1e-8)
    close(got[2], want[2], 1e-8)
    close(got[3].raw_lengthscale, want[3].raw_lengthscale, 1e-8)
    close(got[4], want[4], 1e-10)
    close(got[5], want[5], 1e-10)
    # The covariance is over observables: its diagonal is the fused step's
    # marginal variance (latent variance + noise).
    mu, var = tstep.emulate_marginals(torch.from_numpy(block), torch.from_numpy(mask), **kw)
    close(got[0], mu, 1e-12)
    close(torch.diagonal(got[1], dim1=-2, dim2=-1), var, 1e-12)
    assert len(tgp_dtw.emulate_batch(torch.from_numpy(block), torch.from_numpy(mask), **kw)) == 3


@pytest.mark.parametrize("opts", [
    dict(n_optim_nits=10, fit_chunk_steps=4),
    dict(n_optim_nits=6, fit_chunk_steps=3, optimizer="bfgs"),
    dict(n_optim_nits=6, time_stride=2, fine_steps=3, fit_chunk_steps=2),
])
def test_emulate_batch_chunked_equals_merged(opts):
    block, mask = block_and_mask(11)
    tb, tm = torch.from_numpy(block), torch.from_numpy(mask)
    merged_kw = {k: v for k, v in opts.items() if k != "fit_chunk_steps"}
    merged = tgp_dtw.emulate_batch(tb, tm, dba_iterations=2, **merged_kw)
    chunked = tgp_dtw.emulate_batch_chunked(tb, tm, dba_iterations=2, **opts)
    for a, b in zip(merged, chunked):
        assert torch.equal(a, b)
    want = jgp_dtw.emulate_batch_chunked(jnp.asarray(block), jnp.asarray(mask), dba_iterations=2,
                                         **opts)
    close(chunked[0], want[0], 1e-8)
    close(chunked[1], want[1], 1e-8)
    with pytest.raises(ValueError, match="chunk_steps must be positive"):
        tgp_dtw.emulate_batch_chunked(tb, tm, fit_chunk_steps=0)
    with pytest.raises(NotImplementedError, match="A6b"):
        tgp_dtw.emulate_batch(tb, tm, optimizer="lbfgs")


@pytest.mark.parametrize("opts", [
    dict(),
    dict(dba_method="subgradient", dba_iterations=4),
    dict(fit_chunk_steps=10),
    dict(optimizer="bfgs", n_optim_nits=5),
])
def test_gpdtw1d_fit_collection_matches_jax(opts, monkeypatch):
    arrays = model_arrays(12, counts=(2, 5, 3))
    jmc, tmc = build("jax", arrays), build("torch", arrays)
    kw = dict(dict(n_optim_nits=20, dba_iterations=3), **opts)
    if opts.get("dba_method") == "subgradient":
        # Both sides visit the realisations in the JAX package's epoch orders
        # (the two packages draw theirs from different random streams).
        from bayesian_ensembling_tpu_torch.ops import dtw as tdtw
        from test_torch_dtw_subgradient import _jax_orders
        monkeypatch.setattr(
            tdtw, "_epoch_orders",
            lambda seed, epoch, b, r: torch.from_numpy(_jax_orders(seed, epoch, b, r).astype(np.int64)))
    jmc.fit(jbet.GPDTW1D(dtype=jnp.float64), **kw)
    tmc.fit(tbet.GPDTW1D(dtype=torch.float64), device="cpu", **kw)
    for jp, tp_ in zip(jmc, tmc):
        assert tp_.distribution.is_full_cov
        close(tp_.distribution.gaussian.mean, jp.distribution.gaussian.mean, 1e-8)
        close(tp_.distribution.gaussian.cov, jp.distribution.gaussian.cov, 1e-8)
    with pytest.warns(UserWarning, match="previously learnt"):
        tmc.fit(tbet.MeanField(), device="cpu")


def test_gpdtw1d_options_and_refine_f64():
    arrays = model_arrays(13, counts=(2, 3))
    tmc32, tmc64 = build("torch", arrays), build("torch", arrays)
    kw = dict(n_optim_nits=10, dba_iterations=2, device="cpu")
    tmc32.fit(tbet.GPDTW1D(), refine_f64=True, **kw)
    g = tmc32[0].distribution.gaussian
    assert g.mean.dtype == torch.float64 and g.cov.dtype == torch.float64
    # The refinement recomputes the float64 posterior at the float32 fit's
    # hyperparameters and targets: the JAX package's does the same.
    block, mask = tmc32.padded_stack()
    out = tgp_dtw.emulate_batch(torch.from_numpy(block), torch.from_numpy(mask), n_optim_nits=10,
                                dba_iterations=2, return_params=True)
    jparams = jgp.GPParams(**{k: jnp.asarray(v) for k, v in convert.gp_params_to_numpy(out[3]).items()})
    want = jgp_dtw.refine_posterior_f64(jnp.asarray(block), jnp.asarray(mask), jparams,
                                        targets=(out[4].numpy(), out[5].numpy()), device="cpu")
    close(torch.stack([pm.distribution.gaussian.mean for pm in tmc32]), want[0], 1e-9)
    close(torch.stack([pm.distribution.gaussian.cov for pm in tmc32]), want[1], 1e-9)
    # Without targets the preamble is recomputed in the block's dtype.
    again = tgp_dtw.refine_posterior_f64(block, mask, out[3], dba_iterations=2, device="cpu")
    close(again[0], want[0], 1e-9)
    # It removes float32 round-off only: close to the float32 moments.
    close(out[0].double(), want[0], 1e-3)
    # Config defaults and overrides.
    em = tbet.GPDTW1D(config=tconfig.GPRParameters(n_optim_nits=3, dba_iterations=2, kernel="rbf"),
                      dtype=torch.float64)
    assert em.kernel == "rbf"
    tmc64.fit(em, device="cpu")
    assert tmc64[1].distribution.gaussian.cov.shape == (16, 16)
    grid = tcoords.DimArray(np.zeros((2, 4, 2)), ("realisation", "time", "cell"), {"time": yearly(4)})
    with pytest.raises(NotImplementedError, match="GPDTW3D"):
        tbet.ModelCollection([tbet.ProcessModel(grid, "g")]).fit(tbet.GPDTW1D(), device="cpu")


# --------------------------------------------------------------- weighters
def _exp_tenth(mod):
    return lambda x: mod.exp(x / 10.0)


WEIGHTERS = [
    ("LogLikelihoodWeight", dict()),
    ("LogLikelihoodWeight", dict(joint=True)),
    ("LogLikelihoodWeight", dict(account_obs_uncertainty=True)),
    ("LogLikelihoodWeight", dict(joint=True, account_obs_uncertainty=True)),
    ("LogLikelihoodWeight", dict(standardisation_constant=0.5)),
    ("LogLikelihoodWeight", dict(standardisation_scheme=_exp_tenth)),
    ("InverseSquareWeight", dict()),
    ("UniformWeight", dict()),
    ("ModelSimilarityWeight", dict(mode="single")),
    ("ModelSimilarityWeight", dict(mode="temporal")),
    ("KSDWeight", dict()),
    ("KSDWeight", dict(compat_variance_as_scale=True)),
    ("CRPSWeight", dict()),
    ("CRPSWeight", dict(compat_variance_as_scale=True)),
    ("CRPSWeight", dict(account_obs_uncertainty=True)),
]


@pytest.mark.parametrize("kind", ["full", "diag", "mixed"])
@pytest.mark.parametrize("name,opts", WEIGHTERS, ids=[f"{n}-{'-'.join(o) or 'default'}" for n, o in WEIGHTERS])
def test_weighter_matches_jax_on_shared_posteriors(name, opts, kind):
    jmc, tmc = shared_posteriors(kind)
    jobs, tobs = build_obs("jax", 20), build_obs("torch", 20)
    jopts, topts = dict(opts), dict(opts)
    if "standardisation_scheme" in opts:
        jopts["standardisation_scheme"] = opts["standardisation_scheme"](jnp)
        topts["standardisation_scheme"] = opts["standardisation_scheme"](torch)
    want = getattr(jbet, name)()(jmc, jobs, **jopts)
    got = getattr(tbet, name)()(tmc, tobs, **topts)
    assert got.dims == want.dims and got.name == want.name
    # The full-covariance W2 takes two eigendecompositions per pair.
    tol = 1e-7 if (name == "ModelSimilarityWeight" and kind == "full") else 1e-9
    close(got.values, want.values, tol)
    np.testing.assert_allclose(got.values.sum(axis=0), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.coords["model"], want.coords["model"])
    if "time" in got.dims:
        np.testing.assert_array_equal(got.coords["time"], want.coords["time"])


@pytest.mark.parametrize("kind", ["full", "diag"])
def test_log_likelihood_return_lls_matches_jax(kind):
    jmc, tmc = shared_posteriors(kind)
    jobs, tobs = build_obs("jax", 21), build_obs("torch", 21)
    want_w, want_ll = jbet.LogLikelihoodWeight()(jmc, jobs, return_lls=True)
    got_w, got_ll = tbet.LogLikelihoodWeight()(tmc, tobs, return_lls=True)
    close(got_w.values, want_w.values, 1e-9)
    close(got_ll.values, want_ll.values, 1e-8)  # raw log-densities are O(100) on full covariances
    assert got_ll.name == "Log-likelihoods"


def test_similarity_spatial_mode_and_errors():
    rng = np.random.default_rng(22)
    dims = ("realisation", "time", "latitude", "longitude")
    coords = {"time": yearly(6), "latitude": np.array([-30.0, 30.0]), "longitude": np.array([0.0, 120.0, 240.0])}
    vals = [rng.normal(size=(r, 6, 2, 3)) for r in (3, 2, 4)]
    jmc = jbet.ModelCollection([jbet.ProcessModel(jcoords.DimArray(v.copy(), dims, dict(coords)), f"m{i}")
                                for i, v in enumerate(vals)])
    tmc = tbet.ModelCollection([tbet.ProcessModel(tcoords.DimArray(v.copy(), dims, dict(coords)), f"m{i}")
                                for i, v in enumerate(vals)])
    jmc.fit(jbet.MeanField(dtype=jnp.float64))
    tmc.fit(tbet.MeanField(dtype=torch.float64), device="cpu")
    for mode in ("spatial", "temporal", "single"):
        want = jbet.ModelSimilarityWeight()(jmc, mode=mode)
        got = tbet.ModelSimilarityWeight()(tmc, mode=mode)
        assert got.dims == want.dims
        close(got.values, want.values, 1e-9)
    with pytest.raises(ValueError, match="Mode must be"):
        tbet.ModelSimilarityWeight()(tmc, mode="global")
    _, flat = shared_posteriors("diag")
    with pytest.raises(ValueError, match="latitude/longitude"):
        tbet.ModelSimilarityWeight()(flat, mode="spatial")
    with pytest.raises(ValueError, match="at least 2 models"):
        tbet.ModelSimilarityWeight()(tbet.ModelCollection([flat[0]]))


def test_weighter_validation():
    arrays = model_arrays(23)
    mc, obs = build("torch", arrays), build_obs("torch", 23)
    with pytest.raises(ValueError, match="fit models first"):
        tbet.CRPSWeight()(mc, obs)
    assert tbet.UniformWeight()(mc).values.shape == (3, 16)  # needs no posteriors
    mc.fit(tbet.MeanField(), device="cpu")
    late = build_obs("torch", 23)
    late.data.coords["time"] = late.data.coords["time"] + np.timedelta64(1, "D")
    with pytest.raises(ValueError, match="Time coordinates do not match"):
        tbet.CRPSWeight()(mc, late)
    assert issubclass(tbet.CRPSWeight, tbet.AbstractWeight)
    # A single-model collection gets weight one everywhere.
    solo = tbet.ModelCollection([mc[0]])
    np.testing.assert_allclose(tbet.LogLikelihoodWeight()(solo, obs).values, 1.0)


# ----------------------------------------------------------------- schemes
@pytest.mark.parametrize("kind", ["full", "diag"])
@pytest.mark.parametrize("sigma_mode", ["w2", "compat", "mixture"])
def test_barycentre_matches_jax(sigma_mode, kind):
    jmc, tmc = shared_posteriors(kind)
    jw = jbet.CRPSWeight()(jmc, build_obs("jax", 30))
    tw = tbet.CRPSWeight()(tmc, build_obs("torch", 30))
    want = jbet.Barycentre()(jmc, jw, sigma_mode=sigma_mode)
    scheme = tbet.Barycentre()
    got = scheme(tmc, tw, sigma_mode=sigma_mode)
    assert scheme.posterior is got and not got.is_full_cov
    close(got.gaussian.mean, want.gaussian.mean, 1e-9)
    close(got.gaussian.var, want.gaussian.var, 1e-9)
    np.testing.assert_array_equal(got.template.time, want.template.time)
    if sigma_mode == "compat":
        alias = tbet.Barycentre()(tmc, tw, compat_fixed_point=True)
        assert torch.equal(alias.gaussian.var, got.gaussian.var)
    # One weight per model (the dimensionless similarity weights) broadcasts.
    jsingle = jbet.ModelSimilarityWeight()(jmc, mode="single")
    tsingle = tbet.ModelSimilarityWeight()(tmc, mode="single")
    close(tbet.Barycentre()(tmc, tsingle, sigma_mode=sigma_mode).gaussian.var,
          jbet.Barycentre()(jmc, jsingle, sigma_mode=sigma_mode).gaussian.var, 1e-7)


def test_barycentre_warns_when_the_fixed_point_hits_its_cap():
    _, tmc = shared_posteriors("diag")
    tmc[0].distribution.gaussian.var[3] = float("nan")
    w = tbet.UniformWeight()(tmc)
    with pytest.warns(UserWarning, match="not converged for 1 point"):
        tbet.Barycentre()(tmc, w, sigma_mode="compat")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tbet.Barycentre()(tmc, w, sigma_mode="w2")
    unfitted = build("torch", model_arrays(31))
    with pytest.raises(AttributeError, match="run fit"):
        tbet.Barycentre()(unfitted, tbet.UniformWeight()(unfitted))
    with pytest.raises(AttributeError, match="no posterior yet"):
        tbet.Barycentre().plot()
    with pytest.raises(ValueError, match="incompatible"):
        tschemes._weights_block(tmc, tcoords.DimArray(np.ones((4, 5)), ("model", "time"), {}))


def test_model_means_match_jax():
    jmc, tmc = shared_posteriors("diag")
    jw = jbet.InverseSquareWeight()(jmc, build_obs("jax", 32))
    tw = tbet.InverseSquareWeight()(tmc, build_obs("torch", 32))
    for name, args in (("MultiModelMean", ()), ("WeightedModelMean", (jw, tw))):
        want = getattr(jschemes, name)()(jmc, *args[:1])
        got = getattr(tschemes, name)()(tmc, *args[1:])
        close(got.gaussian.mean, want.gaussian.mean, 1e-12)
        close(got.gaussian.var, want.gaussian.var, 1e-12)
        assert got.gaussian.mean.device.type == "cpu"  # where the posteriors are


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the error raised without CUDA")
@pytest.mark.parametrize("name", ["MultiModelMean", "WeightedModelMean"])
def test_model_means_of_an_unfitted_collection_go_to_the_card(name):
    unfitted = build("torch", model_arrays(33))
    args = () if name == "MultiModelMean" else (tbet.UniformWeight()(unfitted),)
    with pytest.raises(RuntimeError, match=f"{name}: CUDA is not available"):
        getattr(tschemes, name)()(unfitted, *args)


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("kind", ["full", "diag", "mixed"])
def test_metrics_match_jax(kind):
    jmc, tmc = shared_posteriors(kind)
    obs = build_obs("jax", 40).data.values
    for name in ("nll", "rmse", "crps"):
        for jp, tp_ in zip(jmc, tmc):
            got = getattr(tmetrics, name)(tp_.distribution, obs)
            assert isinstance(got, float)
            assert got == pytest.approx(getattr(jmetrics, name)(jp.distribution, obs), abs=1e-9)
    for i, j in ((0, 1), (1, 2), (2, 2)):
        got = tmetrics.w2_between_posteriors(tmc[i].distribution, tmc[j].distribution)
        want = jmetrics.w2_between_posteriors(jmc[i].distribution, jmc[j].distribution)
        assert got == pytest.approx(want, abs=1e-7)


# ------------------------------------------------------------ run_scenario
def scenario(pkg, seed):
    hist = build(pkg, model_arrays(seed, counts=(2, 5, 3), t=16, slope=1.0))
    ssp = build(pkg, model_arrays(seed + 1, counts=(2, 5, 3), t=12, slope=1.5, start=2015))
    return hist, ssp, build_obs(pkg, seed + 2)


@pytest.mark.parametrize("opts", [
    dict(weighter="LogLikelihoodWeight"),
    dict(weighter="CRPSWeight", sigma_mode="mixture"),
    dict(weighter="ModelSimilarityWeight", sigma_mode="compat"),
    dict(weighter="KSDWeight", fit_chunk_steps=8, optimizer="bfgs", n_optim_nits=6),
])
def test_run_scenario_matches_jax(opts):
    """End to end: both packages fit, weight and combine the same synthetic
    collections; barycentre mean and std to 1e-7."""
    opts = dict(dict(n_optim_nits=20, dba_iterations=3), **opts)
    name = opts.pop("weighter")
    jh, js, jo = scenario("jax", 50)
    th, ts, to = scenario("torch", 50)
    want = jpipeline.run_scenario(jh, js, jo, "ssp245", weighter=getattr(jbet, name)(),
                                  emulator=jbet.GPDTW1D(dtype=jnp.float64), **opts)
    got = tbet.run_scenario(th, ts, to, "ssp245", weighter=getattr(tbet, name)(),
                            emulator=tbet.GPDTW1D(dtype=torch.float64), device="cpu", **opts)
    assert isinstance(got, tbet.ScenarioResult) and got.ssp == "ssp245"
    assert got.weights.dims == ("model", "time") and got.weights.shape == (3, 12)
    close(got.weights.values, want.weights.values, 1e-7)
    np.testing.assert_allclose(got.weights.values.sum(axis=0), 1.0, atol=1e-12)
    close(got.barycentre.gaussian.mean, want.barycentre.gaussian.mean, 1e-7)
    close(got.barycentre.stddev.values, want.barycentre.stddev.values, 1e-7)
    assert 0.0 < got.fit_seconds <= got.total_seconds
    ws_got, ws_want = tpipeline.warming_summary(got, years=(2020,)), jpipeline.warming_summary(want, years=(2020,))
    assert ws_got[2020] == pytest.approx(ws_want[2020], abs=1e-7)


def test_run_scenario_refine_f64_matches_jax():
    """float32 fits, float64 published moments and tail; the float32 fits
    of the two packages differ by float32 round-off, so 2e-3."""
    opts = dict(n_optim_nits=10, dba_iterations=2, refine_f64=True)
    jh, js, jo = scenario("jax", 60)
    th, ts, to = scenario("torch", 60)
    want = jpipeline.run_scenario(jh, js, jo, refine_device="cpu", **opts)
    got = tbet.run_scenario(th, ts, to, device="cpu", **opts)
    assert got.barycentre.gaussian.mean.dtype == torch.float64
    assert got.weights.values.dtype == np.float64
    close(got.barycentre.gaussian.mean, want.barycentre.gaussian.mean, 2e-3)
    close(got.barycentre.stddev.values, want.barycentre.stddev.values, 2e-3)


def test_run_scenario_profiles(monkeypatch):
    for native in (False, True):
        assert tprofiles.resolve_profile("fast", native_monthly=native) == \
            jprofiles.resolve_profile("fast", native_monthly=native)
    assert tprofiles.resolve_profile("fast", gridded=True) == jprofiles.resolve_profile("fast", gridded=True)
    assert tprofiles.resolve_profile("faithful") == {} and tprofiles.PROFILES == jprofiles.PROFILES
    with pytest.raises(ValueError, match="unknown profile"):
        tprofiles.resolve_profile("fastest")
    th, ts, to = scenario("torch", 70)
    seen = []

    class Recorder(tbet.MeanField):
        def fit_collection(self, collection, **kw):
            seen.append(kw)
            return super().fit_collection(collection, **kw)

    tbet.run_scenario(th, ts, to, emulator=Recorder(), profile="fast", device="cpu")
    assert {k: seen[0][k] for k in ("n_optim_nits", "optimizer", "time_stride", "fine_steps")} == \
        jprofiles.resolve_profile("fast")
    assert len(seen) == 2 and seen[1]["refine_f64"] is False and seen[0]["device"].type == "cpu"
    seen.clear()
    tbet.run_scenario(th, ts, to, emulator=Recorder(), profile="faithful", device="cpu")
    assert seen[0]["n_optim_nits"] == 2000 and seen[0]["optimizer"] == "adam"
    with pytest.raises(ValueError, match=r"sets \['n_optim_nits', 'optimizer'\] itself"):
        tbet.run_scenario(th, ts, to, profile="fast", n_optim_nits=5, optimizer="bfgs", device="cpu")
    # The JAX package raises the same clash.
    jh, js, jo = scenario("jax", 70)
    with pytest.raises(ValueError, match=r"sets \['n_optim_nits', 'optimizer'\] itself"):
        jpipeline.run_scenario(jh, js, jo, profile="fast", n_optim_nits=5, optimizer="bfgs")


def test_unported_pipeline_entry_points_name_their_roadmap_item():
    # Every pipeline entry point is ported now (the loaders' parity is in
    # test_torch_io.py): each takes every argument the JAX one does, and
    # what is left unported names its item.
    import inspect

    for name in ("default_data_dir", "load_observations", "load_scenario",
                 "load_packed_scenarios", "run_scenario", "run_gridded_scenario"):
        jparams = inspect.signature(getattr(jpipeline, name)).parameters
        tparams = inspect.signature(getattr(tpipeline, name)).parameters
        assert list(jparams) == [p for p in tparams if p != "device"], name
    assert tpipeline.ALL_SSPS == jpipeline.ALL_SSPS
    _, tmc = shared_posteriors("diag")
    with pytest.raises(NotImplementedError, match="A7b-2"):
        tmc.save("unused", backend="orbax")


@pytest.mark.parametrize("sigma_mode", ["w2", "mixture"])
def test_run_scenario_agrees_with_the_fused_step(sigma_mode):
    """Inside the port, two surfaces of one computation: ``GPDTW1D`` +
    ``CRPSWeight`` + ``Barycentre`` through ``run_scenario`` gives the
    weights and barycentre of ``ensemble_scenario_step`` on the same blocks
    (the diagonal of the full covariance is the marginal variance); 1e-9."""
    th, ts, to = scenario("torch", 80)
    kw = dict(n_optim_nits=15, dba_iterations=3)
    res = tbet.run_scenario(th, ts, to, emulator=tbet.GPDTW1D(dtype=torch.float64),
                            sigma_mode=sigma_mode, device="cpu", **kw)
    hb, hm = th.padded_stack(dtype=np.float64)
    sb, sm = ts.padded_stack(dtype=np.float64)
    obs = to.data.values
    mean, std, w = tstep.ensemble_scenario_step(
        *(torch.from_numpy(a) for a in (hb, hm, sb, sm, obs)), sigma_mode=sigma_mode, **kw)
    close(res.weights.values[:, 0], w, 1e-9)
    close(res.barycentre.gaussian.mean, mean, 1e-9)
    close(res.barycentre.stddev.values, std, 1e-9)
