"""The port's dedup campaign and chunked emulation against the JAX package.

The collections are the JAX package's ``ModelCollection``s (the port's
``pack_dedup_campaign`` reads only their ``model_names``,
``max_realisations`` and ``padded_stack``).  Packing is exact.  The
emulations run in float64 on both sides with a few Adam steps; as in
test_torch_step.py, barycentre moments and weights agree to 1e-8 (round-off
of different solvers, amplified mildly by the fit).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.coords import DimArray
from bayesian_ensembling_tpu.data import ModelCollection, ProcessModel
from bayesian_ensembling_tpu.parallel import campaign as jcampaign
from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch import launch_counts, reset_launch_counts, route_counts
from bayesian_ensembling_tpu_torch.ops import dtw_cuda, linalg_blocked, linalg_cuda
from bayesian_ensembling_tpu_torch.parallel import campaign as tcampaign
from bayesian_ensembling_tpu_torch.parallel import step as tstep

torch.set_num_threads(1)

TOL = 1e-8
FIT_KW = dict(n_optim_nits=3, dba_iterations=2)


def scenarios(seed, t_h=14, t_s=8, r=3):
    """Two scenarios sharing historical models b and c, as in the JAX
    package's dedup test (tests/test_parallel.py), with ragged realisation
    counts."""
    rng = np.random.default_rng(seed)
    time_h = (np.datetime64("2000-01", "M") + np.arange(t_h)).astype("datetime64[ns]")
    time_s = (np.datetime64("2010-01", "M") + np.arange(t_s)).astype("datetime64[ns]")

    def pm(name, t, time, n_real):
        vals = rng.normal(size=(n_real, t)) + np.linspace(0.0, 1.0, t)
        return ProcessModel(DimArray(vals, ("realisation", "time"), {"time": time}, name="tas"), name)

    n_real = {"a": 2, "b": r, "c": 2, "d": r}
    hist_pool = {n: pm(n, t_h, time_h, n_real[n]) for n in n_real}
    out = []
    for si, names in enumerate((("a", "b", "c"), ("b", "c", "d"))):
        hists = ModelCollection([hist_pool[n] for n in names])
        ssps = ModelCollection([pm(n, t_s, time_s, n_real[n]) for n in names])
        out.append((f"scn{si}", hists, ssps))
    obs = rng.normal(size=(4, t_h)) + np.linspace(0.0, 1.0, t_h)
    return out, obs


FIELDS = ("hb", "hm", "sb", "sm", "mmask", "uh", "um", "usb", "usm", "uidx", "sidx")


def test_pack_dedup_campaign_matches_jax():
    scen, _ = scenarios(0)
    got = tcampaign.pack_dedup_campaign(scen)
    want = jcampaign.pack_dedup_campaign(scen)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert got.names == want.names == ("scn0", "scn1")
    assert got.n_fits == want.n_fits == 4 + 6


def test_pack_refuses_differing_historical_anomalies():
    scen, _ = scenarios(1)
    name, hists, ssps = scen[1]
    other = ProcessModel(hists[0].data.copy(values=hists[0].data.values + 1.0), hists[0].name)
    scen[1] = (name, ModelCollection([other, hists[1], hists[2]]), ssps)
    with pytest.raises(ValueError, match="differ between scenarios"):
        tcampaign.pack_dedup_campaign(scen)


@pytest.mark.parametrize("multiple", [1, 3, 8, 16])
def test_pad_unique_axis_matches_jax(multiple):
    rng = np.random.default_rng(multiple)
    block = rng.normal(size=(5, 3, 7))
    mask = rng.random(size=(5, 3)) > 0.3
    got = tcampaign.pad_unique_axis(block, mask, multiple)
    want = jcampaign.pad_unique_axis(block, mask, multiple)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunk", [4, 10, 24])
def test_chunked_marginals_matches_jax(chunk):
    """Chunks that divide the batch, that do not (pad-and-slice), and that
    exceed twice the batch (tiled filler)."""
    rng = np.random.default_rng(chunk)
    b, r, t = 10, 3, 12
    block = rng.normal(size=(b, r, t)) + np.linspace(0.0, 1.0, t)
    mask = np.ones((b, r), bool)
    mask[::3, 2] = False
    block[~mask] = 0.0
    calls = []

    def em(blk, msk):
        calls.append(blk.shape[0])
        return tstep.emulate_marginals(blk, msk, **FIT_KW)

    got = tstep.chunked_marginals(em, torch.from_numpy(block), torch.from_numpy(mask), chunk)
    want = jstep.chunked_marginals(
        jax.jit(functools.partial(jstep.emulate_marginals, **FIT_KW)),
        jnp.asarray(block), jnp.asarray(mask), chunk,
    )
    assert calls == [chunk] * -(-b // chunk)
    for g, w in zip(got, want):
        assert g.shape == (b, t)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="chunk must be positive"):
        tstep.chunked_marginals(em, torch.from_numpy(block), torch.from_numpy(mask), 0)


@pytest.fixture
def small_routes(monkeypatch):
    """Thresholds cut so that the monthly campaign's routes appear at a small
    size: the split DBA, the SSP fit (B = 6) on the blocked NLML with
    4 x 4 leaves, and the historical chunk (B = 5) and both posteriors on the
    library route."""
    monkeypatch.setattr(dtw_cuda, "fused_dba_fits", lambda t, dtype=torch.float32: False)
    monkeypatch.setitem(linalg_cuda.KERNEL_T_CAP, torch.float64, 4)
    monkeypatch.setattr(linalg_cuda, "BLOCKED_MIN_BATCH", 6)
    monkeypatch.setattr(linalg_cuda, "BLOCKED_DTYPES", (torch.float32, torch.float64))
    monkeypatch.setattr(linalg_blocked, "DEFAULT_BLOCK", 4)


@pytest.mark.filterwarnings("ignore:batched linalg")
@pytest.mark.parametrize("sigma_mode", ["w2", "mixture"])
def test_run_dedup_campaign_matches_jax(small_routes, monkeypatch, sigma_mode):
    scen, obs = scenarios(2)
    pack64 = jcampaign.pack_dedup_campaign(scen)
    for name in FIELDS:
        a = getattr(pack64, name)
        if a.dtype == np.float32:
            setattr(pack64, name, a.astype(np.float64))
    want = jcampaign.run_dedup_campaign(pack64, jnp.asarray(obs), hist_chunk=5, sigma_mode=sigma_mode, **FIT_KW)

    seen = []
    real = linalg_cuda.linalg_path

    def spy(t, b=None, dtype=torch.float32):
        seen.append((t, b, real(t, b=b, dtype=dtype)))
        return seen[-1][-1]

    monkeypatch.setattr(linalg_cuda, "linalg_path", spy)
    reset_launch_counts()
    got = tcampaign.run_dedup_campaign(
        tcampaign.pack_dedup_campaign(scen), obs, hist_chunk=5, sigma_mode=sigma_mode,
        device="cpu", dtype=torch.float64, **FIT_KW,
    )
    # The fits' decisions (with a batch), then every routed factorisation of
    # the library fit and the posteriors (no batch): 3 steps x (forward +
    # backward) + 2 per posterior on the library route, 3 blocked NLMLs.
    assert [s for s in seen if s[1] is not None] == [(14, 5, "library"), (8, 6, "blocked")]
    assert {s for s in seen if s[1] is None} == {(14, None, "library"), (8, None, "library")}
    n = FIT_KW["n_optim_nits"]
    assert route_counts() == {"kernel": 0, "blocked": n, "library": 2 * n + 2 + 2}
    assert sum(launch_counts().values()) == 0  # the CPU runs the plain versions
    assert got[0].shape == (2, 8) and got[2].shape == (2, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    np.testing.assert_allclose(got[2].sum(dim=1).numpy(), 1.0, rtol=1e-12)


def test_run_dedup_campaign_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    scen, obs = scenarios(3)
    pack = tcampaign.pack_dedup_campaign(scen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcampaign.run_dedup_campaign(pack, obs, **FIT_KW)


def test_unported_campaign_options_raise():
    scen, obs = scenarios(4)
    pack = tcampaign.pack_dedup_campaign(scen)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A10"):
        tcampaign.make_sharded_dedup_campaign(None)
    with pytest.raises(ValueError, match="unknown weight_kind"):
        tcampaign.run_dedup_campaign(pack, obs, weight_kind="nope", device="cpu", **FIT_KW)


@pytest.mark.parametrize("weight_kind", ["loglik", "inverse_square", "similarity_single"])
def test_run_dedup_campaign_weight_kinds_match_jax(weight_kind):
    """The campaign's tail with the other weighters, on the default routes
    (nothing here leaves the kernels' size cap)."""
    scen, obs = scenarios(5)
    pack64 = jcampaign.pack_dedup_campaign(scen)
    for name in FIELDS:
        a = getattr(pack64, name)
        if a.dtype == np.float32:
            setattr(pack64, name, a.astype(np.float64))
    want = jcampaign.run_dedup_campaign(pack64, jnp.asarray(obs), hist_chunk=3,
                                        weight_kind=weight_kind, **FIT_KW)
    got = tcampaign.run_dedup_campaign(tcampaign.pack_dedup_campaign(scen), obs, hist_chunk=3,
                                       weight_kind=weight_kind, device="cpu",
                                       dtype=torch.float64, **FIT_KW)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
