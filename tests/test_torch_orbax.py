"""The port's orbax checkpoint backend (``io/orbax_ckpt.py``: orbax's
``StandardCheckpointer`` layout read and written with ``tensorstore``,
without orbax or JAX) against the JAX package's, which writes through
orbax, on the CPU.

Round trips both ways, exact: the port loads what JAX saved and JAX
(orbax) restores what the port saved, for every kind of blob the
collections hold (floats of both widths, integers, booleans, 0-d arrays,
datetime64, unicode) and for whole fitted ``ModelCollection``s; a save
replaces what is at the path, as orbax's ``force=True``; zero-size arrays
are refused, as orbax refuses them; the port's module imports neither
orbax nor JAX, and names ``tensorstore`` when it is missing.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("tensorstore")

from bayesian_ensembling_tpu.io import orbax_ckpt as jorbax  # noqa: E402
from bayesian_ensembling_tpu_torch.io import orbax_ckpt as torbax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    t = (np.datetime64("1961-01", "M") + np.arange(5)).astype("datetime64[ns]")
    return {
        "m0/data": rng.normal(size=(3, 5)),
        "m0/data32": rng.normal(size=(2, 4)).astype(np.float32),
        "m0/coord/time": t,
        "m0/delta": np.diff(t),
        "names": np.array(["model0", "a much longer model name"]),
        "bytes": np.array([b"ab", b"c"]),
        "m0/scalar": np.array(2.5),
        "m0/ints": np.arange(7, dtype=np.int32),
        "m0/mask": np.array([[True, False], [False, True]]),
        "m0/post/cov": rng.normal(size=(2, 5, 5)),
    }


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_loads_what_jax_saved(tmp_path):
    blobs = _blobs(1)
    jorbax.save_blobs(str(tmp_path / "ck"), blobs)
    _same(torbax.load_blobs(str(tmp_path / "ck")), blobs)


def test_jax_loads_what_the_port_saved(tmp_path):
    blobs = _blobs(2)
    torbax.save_blobs(str(tmp_path / "ck"), blobs)
    _same(jorbax.load_blobs(str(tmp_path / "ck")), blobs)
    _same(torbax.load_blobs(str(tmp_path / "ck")), blobs)
    assert sorted(os.listdir(tmp_path)) == ["ck"]  # no temporary left beside it
    assert {"_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt"} <= set(os.listdir(tmp_path / "ck"))


def test_save_replaces_what_is_there(tmp_path):
    path = str(tmp_path / "ck")
    torbax.save_blobs(path, _blobs(3))
    smaller = {"only": np.arange(3.0)}
    torbax.save_blobs(path, smaller)
    _same(torbax.load_blobs(path), smaller)
    _same(jorbax.load_blobs(path), smaller)
    jorbax.save_blobs(path, _blobs(4))
    torbax.save_blobs(path, smaller)  # over a directory orbax wrote
    _same(jorbax.load_blobs(path), smaller)


def test_zero_size_arrays_are_refused_as_orbax_does(tmp_path):
    with pytest.raises(ValueError, match="zero size"):
        jorbax.save_blobs(str(tmp_path / "j"), {"e": np.zeros((0, 2))})
    with pytest.raises(ValueError, match="zero size"):
        torbax.save_blobs(str(tmp_path / "t"), {"e": np.zeros((0, 2))})
    assert not os.path.exists(tmp_path / "t")


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_fitted_collections_round_trip(tmp_path, direction):
    """Whole fitted collections through ``ModelCollection.save/load``."""
    import bayesian_ensembling_tpu as jbet
    import bayesian_ensembling_tpu_torch as tbet
    from bayesian_ensembling_tpu.models.gp_dtw import GPDTW1D

    rng = np.random.default_rng(5)
    t = (np.datetime64("1961-01", "M") + np.arange(12)).astype("datetime64[ns]")
    models = [jbet.ProcessModel(jbet.DimArray(
        np.linspace(0, 1, 12) + 0.1 * rng.normal(size=(2 + i, 12)), ("realisation", "time"),
        {"time": t}, name="tas"), f"model{i}") for i in range(3)]
    jmc = jbet.ModelCollection(models)
    jmc.fit(GPDTW1D(dtype=np.float64), n_optim_nits=3, dba_iterations=2)
    jmc[0].climatology = np.arange(12.0)
    path = str(tmp_path / "ck")
    if direction == "jax_to_torch":
        jmc.save(path, backend="orbax")
        got = tbet.ModelCollection.load(path, device="cpu")
    else:
        tbet.ModelCollection.load(_npz(jmc, tmp_path), device="cpu").save(path, backend="orbax")
        got = jbet.ModelCollection.load(path)
    assert got.model_names == jmc.model_names
    for a, b in zip(got, jmc):
        np.testing.assert_array_equal(a.data.values, b.data.values)
        np.testing.assert_array_equal(a.time, b.time)
        for k, v in b.distribution.to_arrays().items():
            np.testing.assert_array_equal(np.asarray(a.distribution.to_arrays()[k]), v)
    np.testing.assert_array_equal(got[0].climatology, jmc[0].climatology)


def _npz(mc, tmp_path):
    path = str(tmp_path / "via.npz")
    mc.save(path)
    return path


def test_imports_without_orbax_and_jax_and_names_tensorstore():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from bayesian_ensembling_tpu_torch.io import orbax_ckpt\n"
        "import tempfile, os\n"
        "d = tempfile.mkdtemp()\n"
        "orbax_ckpt.save_blobs(os.path.join(d, 'c'), {'a': np.arange(3.0)})\n"
        "assert orbax_ckpt.load_blobs(os.path.join(d, 'c'))['a'].tolist() == [0.0, 1.0, 2.0]\n"
        "sys.modules['tensorstore'] = None\n"
        "try:\n"
        "    orbax_ckpt.load_blobs(os.path.join(d, 'c'))\n"
        "except ImportError as e:\n"
        "    assert 'tensorstore' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'orbax')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
