"""The orbax checkpoint backend of ``ModelCollection`` blobs, without orbax.

The JAX package writes ``ModelCollection.save(backend="orbax")`` through
``orbax.checkpoint.StandardCheckpointer``, which cannot be imported without
JAX.  The port reads and writes the same directory layout directly with
``tensorstore`` (the storage library orbax itself writes through, imported
on use):

- ``_CHECKPOINT_METADATA``: JSON naming the item handler and the save time;
- ``_METADATA``: JSON, the pytree of the checkpoint, one entry per leaf
  with its key path and value type (``np.ndarray``), and the storage
  options (OCDBT on, zarr v2);
- an OCDBT key-value store at the directory's root holding one zarr v2
  array per leaf, at the key ``"<blob key>.<field>"``, compressed with zstd.

Each blob is one dict of leaves (orbax keys cannot contain ``/``, so it is
escaped): numeric arrays as themselves; datetime64 / timedelta64 arrays as
an int64 view with their dtype's name as a byte array; unicode and bytes
arrays as raw bytes with their dtype's name and shape.  Loading restores
every array exactly; the two packages read each other's checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import typing as tp

import numpy as np

__all__ = ["save_blobs", "load_blobs"]

_SEP = "__SLASH__"  # orbax tree keys cannot contain '/'
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_KEY_TYPE_DICT = 2  # orbax's key_type of a dict key


def _encode(v: np.ndarray) -> tp.Dict[str, np.ndarray]:
    v = np.asarray(v)
    if v.dtype.kind in "Mm":  # datetime64 / timedelta64
        return {"b": v.view(np.int64), "dtype": _str_arr(str(v.dtype)), "kind": _str_arr("dt")}
    if v.dtype.kind in "US":  # unicode / bytes
        return {"b": np.frombuffer(v.tobytes(), np.uint8).copy(),
                "dtype": _str_arr(str(v.dtype)),
                "shape": np.array(v.shape, np.int64),
                "kind": _str_arr("str")}
    return {"b": v, "kind": _str_arr("num")}


def _decode(d: tp.Dict[str, np.ndarray]) -> np.ndarray:
    kind = _arr_str(d["kind"])
    if kind == "dt":
        return np.asarray(d["b"]).view(_arr_str(d["dtype"]))
    if kind == "str":
        dt = np.dtype(_arr_str(d["dtype"]))
        flat = np.frombuffer(np.asarray(d["b"], np.uint8).tobytes(), dt)
        return flat.reshape(tuple(np.asarray(d["shape"])))
    return np.asarray(d["b"])


def _str_arr(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8).copy()


def _arr_str(a: np.ndarray) -> str:
    return np.asarray(a, np.uint8).tobytes().decode()


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "the orbax checkpoint backend needs the 'tensorstore' package (the port "
            "reads and writes orbax's layout with it, without orbax or JAX)"
        ) from e
    return tensorstore


def _kvstore(directory: str) -> dict:
    return {"driver": "ocdbt", "base": "file://" + os.path.abspath(directory) + "/"}


def save_blobs(path: str, blobs: tp.Dict[str, np.ndarray]) -> None:
    """Write ``blobs`` as an orbax ``StandardCheckpointer`` directory at
    ``path``, replacing what is there (orbax's ``force=True``).  The
    directory is written beside ``path`` and renamed into place."""
    ts = _tensorstore()
    tree = {k.replace("/", _SEP): _encode(v) for k, v in blobs.items()}
    for key, leaves in tree.items():
        for field, leaf in leaves.items():
            if np.asarray(leaf).size == 0:
                # as orbax refuses them
                raise ValueError(f"Cannot save arrays with zero size: {key}.{field}")
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    started = time.time_ns()
    try:
        # One context (so one OCDBT store) and one transaction: a single
        # commit for every array.
        context, txn = ts.Context(), ts.Transaction()
        tree_metadata = {}
        for key in sorted(tree):
            for field in sorted(tree[key]):
                leaf = np.asarray(tree[key][field], order="C")  # keeps 0-d arrays 0-d
                spec = {
                    "driver": "zarr",
                    "kvstore": dict(_kvstore(tmp), path=f"{key}.{field}/"),
                    "metadata": {"shape": list(leaf.shape), "chunks": list(leaf.shape),
                                 "dtype": leaf.dtype.str, "compressor": {"id": "zstd", "level": 1},
                                 "fill_value": None, "dimension_separator": "."},
                    "create": True,
                }
                ts.open(spec, context=context, transaction=txn).result().write(leaf).result()
                tree_metadata[str((key, field))] = {
                    "key_metadata": [{"key": key, "key_type": _KEY_TYPE_DICT},
                                     {"key": field, "key_type": _KEY_TYPE_DICT}],
                    "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
                }
        txn.commit_sync()
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_blobs(path: str) -> tp.Dict[str, np.ndarray]:
    """Read the blobs of an orbax ``StandardCheckpointer`` directory (the
    JAX package's ``save_blobs`` or :func:`save_blobs`)."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT checkpoints of zarr v2 arrays are read")
    tree: tp.Dict[str, tp.Dict[str, np.ndarray]] = {}
    for entry in meta["tree_metadata"].values():
        key, field = (k["key"] for k in entry["key_metadata"])
        spec = {"driver": "zarr", "kvstore": dict(_kvstore(path), path=f"{key}.{field}/"),
                "open": True}
        tree.setdefault(key, {})[field] = ts.open(spec).result().read().result()
    return {k.replace(_SEP, "/"): _decode(v) for k, v in tree.items()}
