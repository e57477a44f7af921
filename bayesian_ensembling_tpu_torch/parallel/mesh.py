"""What stands in for a JAX mesh: a ``torch.distributed`` device mesh with
named axes, the collectives of the sharded steps, and the wrapper that runs a
step on each rank's shard.

A :class:`torch.distributed.device_mesh.DeviceMesh` takes the place of
``jax.sharding.Mesh``: its ``mesh_dim_names`` are the JAX axis names
(``"model"``, ``"cells"``, ``"scenario"``) and a named axis resolves to
``mesh.get_group(name)``.  In the JAX package ``model_axis="model"`` names a
live ``shard_map`` axis; here :func:`shard_map` makes its mesh current (a
:class:`contextvars.ContextVar`) while it calls the step, and
``model_axis=`` inside the step functions resolves against that mesh.  An
axis name with no current mesh raises, as JAX raises on an unbound axis
name: nothing runs unsharded quietly.

The collectives are those of the JAX code: ``psum`` is ``all_reduce(SUM)``,
``pmax`` is ``all_reduce(MAX)`` and a tiled ``all_gather`` is
``all_gather_into_tensor``.  Each adds one to its count in
:data:`COLLECTIVES` where it is issued and nowhere else, as
``_build.launch`` counts kernel launches.

The caller makes the process group (NCCL for CUDA, gloo for the CPU) and the
mesh (``torch.distributed.device_mesh.init_device_mesh``); nothing here calls
``init_process_group`` for a step.  :func:`run_local` starts a gloo group
of processes on this host for callers that have none, as the tests do.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import socket
import tempfile
import typing as tp
import warnings

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "COLLECTIVES",
    "all_gather",
    "axis_group",
    "axis_size",
    "collective_counts",
    "free_port",
    "mesh_device",
    "pmax",
    "psum",
    "run_local",
    "shard_map",
    "use_mesh",
]

# Collectives issued since the last reset (``reset_launch_counts`` of the
# package resets them with the kernel counts), by kind.
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("bet_current_mesh", default=None)

# A partition spec: one mesh axis name (or None) per leading tensor dimension,
# as ``jax.sharding.PartitionSpec``; ``()`` is replicated.
Spec = tp.Tuple[tp.Optional[str], ...]


def collective_counts() -> dict[str, int]:
    """Collectives issued since the last reset, by kind."""
    return dict(COLLECTIVES)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh, against which ``model_axis=`` and the
    other axis names of the step functions resolve."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along the named axis of ``mesh``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {names}")
    return mesh.size(names.index(axis))


def axis_group(axis: str):
    """The process group of the named axis of the current mesh.  Raises
    ``NameError`` when no mesh is current or the mesh has no such axis."""
    mesh = _CURRENT.get()
    if mesh is None:
        raise NameError(
            f"unbound axis name: {axis!r}; no mesh is current (model_axis= and the other axis "
            "names resolve inside a make_sharded_* step or under parallel.mesh.use_mesh)"
        )
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise NameError(f"unbound axis name: {axis!r}; the current mesh has axes {names}")
    return mesh.get_group(axis)


def psum(x: torch.Tensor, axis: tp.Optional[str]) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (``x`` itself when
    ``axis`` is None)."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: tp.Optional[str]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis``."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def _all_reduce(x, axis, op):
    if axis is None:
        return x
    group = axis_group(axis)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    COLLECTIVES["all_reduce"] += 1
    return out


def all_gather(x: torch.Tensor, axis: tp.Optional[str], dim: int = 0) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``axis`` joined along ``dim`` in
    mesh order (JAX's ``all_gather(..., tiled=True)``); ``x`` itself when
    ``axis`` is None.  A boolean tensor travels as bytes."""
    if axis is None:
        return x
    group = axis_group(axis)
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0)
    if x.dtype == torch.bool:
        src = src.to(torch.uint8)
    src = src.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        # Newer torch renames the call; the older one on the card has no other.
        warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.*", category=FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    COLLECTIVES["all_gather"] += 1
    if x.dtype == torch.bool:
        out = out.to(torch.bool)
    return out.movedim(0, dim).contiguous()


def mesh_device(mesh) -> torch.device:
    """The device of this rank: ``cuda:<local rank>`` on a CUDA mesh (the
    ``LOCAL_RANK`` variable, else the global rank modulo the cards of this
    host), else the mesh's device type."""
    if mesh.device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
        return torch.device("cuda", index)
    return torch.device(mesh.device_type)


def _tensor_on(a, device: torch.device) -> torch.Tensor:
    """``a`` (numpy or tensor) on ``device`` in its own dtype."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a).to(device)


def _local_block(x: torch.Tensor, spec: Spec, mesh, pad: tp.Mapping[str, str]) -> torch.Tensor:
    """This rank's block of the global ``x``: along each dimension named in
    ``spec``, rank r of n takes rows ``[r N / n, (r + 1) N / n)``."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = axis_size(mesh, axis)
        if x.shape[d] % n:
            helper = pad.get(axis)
            fix = f"pad it with {helper} first" if helper else f"pass a multiple of {n}"
            raise ValueError(
                f"dimension {d} (length {x.shape[d]}) does not divide over mesh axis {axis!r} of "
                f"{n} ranks; {fix}"
            )
        k = x.shape[d] // n
        x = x.narrow(d, mesh.get_local_rank(axis) * k, k)
    return x.contiguous()


def _global(local, spec: Spec, mesh):
    """A sharded output as a ``DTensor`` over ``mesh`` (no collective); a
    replicated one as the plain tensor, equal on every rank."""
    if local is None or all(a is None for a in spec):
        return local
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        if axis is not None:
            placements[names.index(axis)] = Shard(d)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def shard_map(fn, mesh, in_specs: tp.Sequence[Spec], out_specs: tp.Sequence[Spec], *,
              pad: tp.Optional[tp.Mapping[str, str]] = None):
    """The port's ``jax.shard_map``: a function of the GLOBAL inputs (numpy
    arrays or tensors; every rank passes the same) that calls ``fn`` on this
    rank's blocks, on this rank's device, with ``mesh`` current.

    ``in_specs`` / ``out_specs`` give one spec per argument / output: a tuple
    of mesh axis names (or None) per leading dimension; ``()`` is
    replicated.  A None argument passes through.  A sharded output comes
    back as a ``DTensor`` (``DTensor.from_local``, no collective), a
    replicated one as a plain tensor.  A dimension that its axis does not
    divide raises a ``ValueError`` naming the padding helper that ``pad``
    maps the axis to.
    """
    names = tuple(mesh.mesh_dim_names or ())
    for spec in (*in_specs, *out_specs):
        for axis in spec:
            if axis is not None and axis not in names:
                raise ValueError(f"the mesh has no axis {axis!r}; its axes are {names}")
    pad = dict(pad or {})

    def call(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} arguments, got {len(args)}")
        device = mesh_device(mesh)
        local = [None if a is None else _local_block(_tensor_on(a, device), spec, mesh, pad)
                 for a, spec in zip(args, in_specs)]
        scope = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with use_mesh(mesh), scope:
            out = fn(*local)
        return tuple(_global(o, spec, mesh) for o, spec in zip(out, out_specs))

    return call


def free_port() -> int:
    """A TCP port free on localhost now (for a process group's address)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, nprocs, address, timeout, out_path, args):
    dist.init_process_group("gloo", init_method=address, world_size=nprocs, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, nprocs, *args)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def run_local(fn, nprocs: int, *args, timeout: float = 300.0):
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes (the
    ``spawn`` start method) joined in one gloo process group on a free
    localhost port, and return rank 0's return value.  (Gloo takes CPU
    tensors, and on torch 2.11 CUDA tensors too, several ranks to a card.)

    ``fn`` must be importable by name (a module-level function) and its
    return value loadable by ``torch.load``.  A rank that raises fails the
    call with its traceback; a group still running after ``timeout``
    seconds is terminated and raises ``TimeoutError``.
    """
    import time

    import torch.multiprocessing as mp

    address = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        ctx = mp.start_processes(_rank_main, args=(fn, nprocs, address, timeout, out_path, args),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"run_local: {nprocs} ranks still running after {timeout} s")
        return torch.load(out_path, weights_only=False)
