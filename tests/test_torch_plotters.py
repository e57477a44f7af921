"""The port's plotters and the containers' five plot methods against the JAX
package: the same containers (posteriors carried across with
``convert.collection_from_jax``) must draw the same lines, bands and images.
"""

import numpy as np
import pytest

pytest.importorskip("matplotlib")

import jax.numpy as jnp  # noqa: E402

import bayesian_ensembling_tpu as jbet  # noqa: E402
import bayesian_ensembling_tpu_torch as tbet  # noqa: E402
from bayesian_ensembling_tpu import coords as jcoords  # noqa: E402
from bayesian_ensembling_tpu import plotters as jplotters  # noqa: E402
from bayesian_ensembling_tpu.ops import distributions as jd  # noqa: E402
from bayesian_ensembling_tpu_torch import convert  # noqa: E402
from bayesian_ensembling_tpu_torch import plotters as tplotters  # noqa: E402


def pyplot():
    return tplotters.pyplot()


def drawn(obj):
    """Everything an axes (or every axes of a figure) drew, as arrays."""
    axes = obj.axes if hasattr(obj, "savefig") else [obj]
    out = []
    for ax in axes:
        out += [("line", np.asarray(line.get_xydata(), float), line.get_label(),
                 line.get_color(), line.get_linestyle()) for line in ax.lines]
        out += [("band", np.concatenate([np.asarray(p.vertices) for p in c.get_paths()]))
                for c in ax.collections if c.get_paths()]
        out += [("image", np.asarray(im.get_array()), tuple(im.get_extent())) for im in ax.images]
        out.append(("title", ax.get_title()))
    return out


def same_drawing(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, np.ndarray):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
            else:
                assert a == b


def collections(spatial=False):
    rng = np.random.default_rng(3)
    t = 12
    time = (np.datetime64("2000-01", "M") + np.arange(t)).astype("datetime64[ns]")
    shape, dims, coords = (t,), ("realisation", "time"), {"time": time}
    if spatial:
        shape, dims = (t, 3, 4), dims + ("latitude", "longitude")
        coords = {"time": time, "latitude": np.array([30.0, 0.0, -30.0]),
                  "longitude": np.array([0.0, 90.0, 180.0, 270.0])}
    jmc = jbet.ModelCollection([
        jbet.ProcessModel(jcoords.DimArray(rng.normal(size=(r,) + shape) + i, dims, dict(coords),
                                           name="tas"), f"m{i}")
        for i, r in enumerate((2, 3, 4, 2))
    ])
    for pm in jmc:
        n = int(np.prod(shape))
        pm.distribution = jbet.Posterior(
            jd.DiagGaussian(jnp.asarray(rng.normal(size=n)), jnp.asarray(rng.uniform(0.1, 1, n))),
            pm.blank_template())
    return jmc, convert.collection_from_jax(jmc._to_blobs(), device="cpu")


@pytest.mark.parametrize("method", ["plot", "plot_all", "plot_grid", "plot_temporally",
                                    "plot_spatially"])
@pytest.mark.parametrize("spatial", [False, True])
def test_plot_methods_draw_what_jax_draws(method, spatial):
    plt = pyplot()
    jmc, tmc = collections(spatial)
    if method == "plot_spatially" and not spatial:
        for post in (jmc[2].distribution, tmc[2].distribution):
            with pytest.raises(ValueError, match="latitude/longitude"):
                post.plot_spatially()
        return
    targets = {"plot": (jmc[1], tmc[1]), "plot_all": (jmc, tmc), "plot_grid": (jmc, tmc),
               "plot_temporally": (jmc[2].distribution, tmc[2].distribution),
               "plot_spatially": (jmc[2].distribution, tmc[2].distribution)}
    want_obj, got_obj = targets[method]
    want, got = getattr(want_obj, method)(), getattr(got_obj, method)()
    same_drawing(drawn(got), drawn(want))
    plt.close("all")


def test_plotter_helpers_match_jax():
    assert tplotters.cmap() == jplotters.cmap()
    assert list(tplotters.get_style_cycler()) == list(jplotters.get_style_cycler())
    plt = pyplot()
    jmc, tmc = collections()
    for kw in ({"legend": True}, {"one_color": "k"}):
        same_drawing(drawn(tplotters.plot_collection(tmc, **kw)),
                     drawn(jplotters.plot_collection(jmc, **kw)))
    same_drawing(drawn(tplotters.plot_posterior_temporal(tmc[0].distribution, color="r",
                                                         label="x", n_sigma=(1,))),
                 drawn(jplotters.plot_posterior_temporal(jmc[0].distribution, color="r",
                                                         label="x", n_sigma=(1,))))
    for mod, mc in ((tplotters, tmc), (jplotters, jmc)):
        with pytest.raises(ValueError, match="latitude/longitude"):
            mod.plot_posterior_spatial(mc[0].distribution)
    plt.close("all")
