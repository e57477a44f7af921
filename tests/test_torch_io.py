"""The port's netCDF reader and writer (``io/netcdf.py``) and the file half of
``pipeline.py`` against the JAX package, on the CPU.

The reader and the writer are held against JAX's on files written by JAX's
``save_dataarray`` and by ``h5py`` directly.  The four loaders run on a
temporary tree laid out as ``default_data_dir`` expects (HadCRUT5-like
observations and three CMIP6-like models, monthly 1850-01 to 2014-12 and
2015-01 to 2100-12) and must give the JAX package's collections bit for
bit: both sides are host numpy code.  The last test imports the port with
h5py, pandas and matplotlib blocked.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from bayesian_ensembling_tpu import coords as jcoords  # noqa: E402
from bayesian_ensembling_tpu import pipeline as jpipeline  # noqa: E402
from bayesian_ensembling_tpu.io import netcdf as jnetcdf  # noqa: E402
from bayesian_ensembling_tpu_torch import coords as tcoords  # noqa: E402
from bayesian_ensembling_tpu_torch import io as tio  # noqa: E402
from bayesian_ensembling_tpu_torch import pipeline as tpipeline  # noqa: E402
from bayesian_ensembling_tpu_torch.io import netcdf as tnetcdf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same_dimarray(got, want):
    assert got.dims == want.dims and got.name == want.name
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)  # NaN == NaN here
    assert set(got.coords) == set(want.coords)
    for k in want.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
        assert got.coords[k].dtype == want.coords[k].dtype


def open_both(path, **kw):
    got, want = tnetcdf.open_dataarray(path, **kw), jnetcdf.open_dataarray(path, **kw)
    same_dimarray(got, want)
    return got


# ------------------------------------------------------- reader and writer
def _h5_file(path, values, time, units, calendar=None, attrs=None, dims=True):
    with h5py.File(path, "w") as f:
        v = f.create_dataset("tas", data=values)
        for k, a in (attrs or {}).items():
            v.attrs[k] = a
        t = f.create_dataset("time", data=time)
        t.attrs["units"] = np.bytes_(units)
        if calendar is not None:
            t.attrs["calendar"] = np.bytes_(calendar)
        r = f.create_dataset("realisation", data=np.arange(values.shape[0]))
        t.make_scale("time")
        r.make_scale("realisation")
        if dims:
            v.dims[0].attach_scale(r)
            v.dims[1].attach_scale(t)


def test_scaled_integers_and_fill_values_match_jax(tmp_path):
    p = str(tmp_path / "packed.nc")
    raw = np.array([[100, 200, -32767], [5, -32768, 7]], dtype=np.int16)
    _h5_file(p, raw, np.arange(3, dtype=np.float64), "days since 2000-01-01", attrs={
        "scale_factor": np.float64(0.01), "add_offset": np.float64(273.15),
        "_FillValue": np.int16(-32767), "missing_value": np.int16(-32768)})
    da = open_both(p)
    np.testing.assert_allclose(da.values[0, :2], [274.15, 275.15])
    assert np.isnan(da.values[0, 2]) and np.isnan(da.values[1, 1])


def test_float_fill_and_unscaled_integers_match_jax(tmp_path):
    p = str(tmp_path / "fill.nc")
    vals = np.array([[1.5, -999.0, 2.5]], dtype=np.float32)
    _h5_file(p, vals, np.arange(3.0), "hours since 2015-01-16 12:00:00",
             attrs={"_FillValue": np.float32(-999.0)})
    assert np.isnan(open_both(p).values[0, 1])
    p2 = str(tmp_path / "ints.nc")
    _h5_file(p2, np.array([[1, 2, 3]], np.int32), np.arange(3.0), "days since 2000-01-01",
             attrs={"_FillValue": np.int32(2)})
    assert open_both(p2).values.dtype == np.float64


@pytest.mark.parametrize("calendar", ["noleap", "360_day", "365_day"])
def test_non_gregorian_calendar_is_refused_by_both(tmp_path, calendar):
    p = str(tmp_path / "cal.nc")
    _h5_file(p, np.zeros((1, 3)), np.arange(3) * 30.0, "days since 1850-01-01", calendar)
    for mod in (tnetcdf, jnetcdf):
        with pytest.raises(NotImplementedError, match=calendar):
            mod.open_dataarray(p)


@pytest.mark.parametrize("calendar", ["standard", "gregorian", "proleptic_gregorian", None])
def test_gregorian_family_and_wide_epoch_match_jax(tmp_path, calendar):
    p = str(tmp_path / "wide.nc")
    days = 365.2425 * 2014 + 16 + np.arange(4) * 30.0  # from mid-January 2015
    _h5_file(p, np.ones((2, 4)), days, "days since 0001-01-01", calendar)
    da = open_both(p)
    assert str(da.time[0]).startswith("2015-01-1")


def test_dimension_scales_without_dimension_list_match_jax(tmp_path):
    """No DIMENSION_LIST: scales are matched by length, each used once, and
    two of equal length warn in both packages."""
    p = str(tmp_path / "nolist.nc")
    _h5_file(p, np.ones((3, 3)), np.arange(3.0), "days since 2000-01-01", dims=False)
    with pytest.warns(UserWarning, match="several dimension scales"):
        got = tnetcdf.open_dataarray(p)
    with pytest.warns(UserWarning, match="several dimension scales"):
        want = jnetcdf.open_dataarray(p)
    same_dimarray(got, want)
    p2 = str(tmp_path / "novar.nc")
    with h5py.File(p2, "w") as f:
        f.create_dataset("time_bnds", data=np.zeros((3, 2)))
    for mod in (tnetcdf, jnetcdf):
        with pytest.raises(ValueError, match="no data variable"):
            mod.open_dataarray(p2)


TIMES = {
    "subhour": np.array(["2000-01-01T00:30", "2000-01-01T01:45", "2000-01-01T03:10"],
                        dtype="datetime64[ns]"),
    "fractional_epoch": np.datetime64("2000-01-01T00:00:00.500", "ns")
    + np.arange(3) * np.timedelta64(1, "h"),
    "subsecond": np.datetime64("2000-01-01T00:00:00", "ns")
    + np.array([0, 250_000_000, 1_750_000_001]).astype("timedelta64[ns]"),
    "monthly": (np.datetime64("1850-01", "M") + np.arange(3)).astype("datetime64[ns]")
    + np.timedelta64(15, "D") + np.timedelta64(12, "h"),
}


@pytest.mark.parametrize("kind", sorted(TIMES))
def test_writers_agree_and_round_trip(tmp_path, kind):
    """Each package reads what either writes, the same as the other does,
    and the time stamps come back exactly."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(2, 3))
    time = TIMES[kind]
    written = {}
    for pkg, mod, da_cls in (("torch", tnetcdf, tcoords.DimArray),
                             ("jax", jnetcdf, jcoords.DimArray)):
        p = str(tmp_path / f"{pkg}.nc")
        mod.save_dataarray(p, da_cls(vals, ("realisation", "time"), {"time": time}, name="tas"))
        written[pkg] = p
    for p in written.values():
        da = open_both(p)
        np.testing.assert_array_equal(da.time, time)
        np.testing.assert_array_equal(da.values, vals)
    with h5py.File(written["torch"]) as a, h5py.File(written["jax"]) as b:
        assert a["time"].attrs["units"] == b["time"].attrs["units"]
        np.testing.assert_array_equal(a["time"][...], b["time"][...])


def test_io_package_exports():
    assert tio.open_dataarray is tnetcdf.open_dataarray
    assert tio.save_dataarray is tnetcdf.save_dataarray
    assert set(tio.__all__) == {"netcdf", "timeutils", "open_dataarray", "save_dataarray"}


# ----------------------------------------------------------------- loaders
OBS_FILE = "obs/gmst/HadCRUT.5.0.1.0.analysis.anomalies_gmst.nc"
MODELS = ("CCCma_CanESM5-p1", "MOHC_UKESM1-0-LL", "NCAR_CESM2")


def _monthly(start, n, day_offset):
    months = np.datetime64(start, "M") + np.arange(n)
    return months.astype("datetime64[ns]") + day_offset


def _save(path, values, time):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jnetcdf.save_dataarray(path, jcoords.DimArray(
        values, ("realisation", "time"), {"time": time}, name="tas"))


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    """obs, 3 models in historical and ssp119, 2 of them in ssp585, one
    model only in historical; one model's historical stamps on the first of
    the month (the others mid-month, as HadCRUT5's), which the collocation
    repairs."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(42)
    mid = np.timedelta64(15, "D") + np.timedelta64(12, "h")
    t_hist, t_ssp = _monthly("1850-01", 1980, mid), _monthly("2015-01", 1032, mid)
    seasonal = np.sin(2 * np.pi * np.arange(1980) / 12)
    _save(str(root / OBS_FILE), seasonal + 0.1 * rng.normal(size=(4, 1980)), t_hist)
    for i, name in enumerate(MODELS + ("IPSL_IPSL-CM6A-LR",)):
        r = 2 + i
        hist_time = _monthly("1850-01", 1980, np.timedelta64(0, "D")) if i == 1 else t_hist
        trend = np.linspace(0.0, 1.0, 1980) + 14.0 + 0.5 * i
        _save(str(root / f"gmst/historical/{name}_historical_gmst.nc"),
              trend + seasonal + 0.1 * rng.normal(size=(r, 1980)), hist_time)
        if i == 3:
            continue  # only in historical
        for ssp, keep in (("ssp119", True), ("ssp585", i < 2)):
            if keep:
                _save(str(root / f"gmst/{ssp}/{name}_{ssp}_gmst.nc"),
                      15.0 + 0.5 * i + np.sin(2 * np.pi * np.arange(1032) / 12)
                      + 0.1 * rng.normal(size=(r, 1032)), t_ssp)
    return str(root)


def same_collection(got, want):
    assert got.model_names == want.model_names
    for g, w in zip(got, want):
        same_dimarray(g.data, w.data)
        if w.climatology is None:
            assert g.climatology is None
        else:
            np.testing.assert_array_equal(g.climatology, w.climatology)
        assert g.distribution is None


@pytest.mark.parametrize("freq", ["Y", None, "Q"])
def test_load_observations_matches_jax(data_tree, freq):
    got = tpipeline.load_observations(data_tree, resample_freq=freq)
    want = jpipeline.load_observations(data_tree, resample_freq=freq)
    assert got.name == want.name == "Observations"
    same_dimarray(got.data, want.data)
    assert got.data.values.shape[1] == {"Y": 165, None: 1980, "Q": 660}[freq]


@pytest.mark.parametrize("collocate", [True, False])
@pytest.mark.parametrize("freq", ["Y", None])
def test_load_scenario_matches_jax(data_tree, freq, collocate):
    import warnings

    with warnings.catch_warnings(record=True) as caught_t:
        warnings.simplefilter("always")
        got = tpipeline.load_scenario("ssp119", data_tree, freq, collocate_obs_time=collocate)
    with warnings.catch_warnings(record=True) as caught_j:
        warnings.simplefilter("always")
        want = jpipeline.load_scenario("ssp119", data_tree, freq, collocate_obs_time=collocate)
    for g, w in zip(got, want):
        same_collection(g, w)
    assert [str(c.message) for c in caught_t] == [str(c.message) for c in caught_j]
    hist, ssp = got
    assert hist.model_names == [f"{m} anomaly" for m in MODELS]
    assert len(ssp.time) == (86 if freq else 1032)
    if freq is None and collocate:  # the model on the first of the month took the obs axis
        obs = tpipeline.load_observations(data_tree, resample_freq=None)
        np.testing.assert_array_equal(hist[1].time, obs.time)


def test_load_packed_scenarios_matches_jax(data_tree):
    got = tpipeline.load_packed_scenarios(data_tree, ssps=["ssp119", "ssp585"])
    want = jpipeline.load_packed_scenarios(data_tree, ssps=["ssp119", "ssp585"])
    assert got[-1] == want[-1] == ("ssp119", "ssp585")
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    hb, hm, sb, sm, mmask = got[:-1]
    assert hb.shape == (2, 3, 4, 165) and sb.shape == (2, 3, 4, 86)
    np.testing.assert_array_equal(mmask, [[1, 1, 1], [1, 1, 0]])


def test_default_data_dir_and_errors(data_tree, monkeypatch, tmp_path):
    monkeypatch.setenv("BET_DATA_DIR", data_tree)
    assert tpipeline.default_data_dir() == jpipeline.default_data_dir() == data_tree
    same_dimarray(tpipeline.load_observations().data, jpipeline.load_observations().data)
    same_collection(tpipeline.load_scenario("ssp585")[1], jpipeline.load_scenario("ssp585")[1])
    for mod in (tpipeline, jpipeline):
        with pytest.raises(FileNotFoundError, match="no overlapping models for ssp999"):
            mod.load_scenario("ssp999")
    monkeypatch.setenv("BET_DATA_DIR", str(tmp_path / "missing"))
    messages = []
    for mod in (tpipeline, jpipeline):
        with pytest.raises(FileNotFoundError, match="is not a directory") as e:
            mod.default_data_dir()
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    monkeypatch.delenv("BET_DATA_DIR")
    outcomes = []
    for mod in (tpipeline, jpipeline):
        try:
            outcomes.append(mod.default_data_dir())
        except FileNotFoundError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_obs_time_cache_is_read_only_and_rechecks_the_file(tmp_path):
    root = tmp_path / "tree"
    assert tpipeline._obs_time(str(root)) is None
    t = _monthly("1850-01", 24, np.timedelta64(15, "D"))
    _save(str(root / OBS_FILE), np.zeros((2, 24)), t)
    cached = tpipeline._obs_time(str(root))
    np.testing.assert_array_equal(cached, t)
    assert not cached.flags.writeable
    assert tpipeline._obs_time(str(root)) is cached
    os.remove(root / OBS_FILE)
    assert tpipeline._obs_time(str(root)) is None


# ------------------------------------------------------- optional imports
def test_package_imports_without_h5py_pandas_and_matplotlib():
    code = textwrap.dedent("""
        import sys
        for name in ("h5py", "pandas", "matplotlib", "matplotlib.pyplot"):
            sys.modules[name] = None
        import bayesian_ensembling_tpu_torch as bt
        from bayesian_ensembling_tpu_torch import *  # noqa: F401,F403
        import bayesian_ensembling_tpu_torch.serve
        import bayesian_ensembling_tpu_torch.utils.cli
        assert bt.plotters.cmap() and bt.serve.ProjectionService
        try:
            bt.io.open_dataarray("any.nc")
        except ImportError as e:
            assert "h5py" in str(e), e
        else:
            raise AssertionError("no ImportError")
        try:
            bt.plotters.pyplot()
        except ImportError:
            pass
        else:
            raise AssertionError("no ImportError")
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "bayesian_ensembling_tpu"))
        assert not leaked, leaked
        print("ok")
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
