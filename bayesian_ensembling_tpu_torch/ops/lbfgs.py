"""``optax.lbfgs()`` at its defaults, written out in PyTorch.

The JAX package's ``optimizer="lbfgs"`` is ``optax.lbfgs()``: the two-loop
L-BFGS recursion over a ring of 10 curvature pairs (``scale_by_lbfgs``,
with the scaled-identity initial preconditioner), ``scale(-1)``, and a zoom
line search of at most 20 steps that starts every step at a step size of 1
(``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')``); the iterate's value and gradient come from
the state when the line search left finite ones there
(``value_and_grad_from_state``).  Every function here follows optax's order
of operations, so in float64 the port walks optax's iterates.

The parameters are one tensor of shape ``(L, ...)``: the ``L`` leaves of the
JAX pytree stacked in tree order (``GPParams``: ``raw_lengthscale`` then
``raw_variance``).  Inner products sum each leaf and then add the leaves'
sums in that order, as ``optax.tree.vdot`` does.

The line search is a host loop, the counterpart of optax's ``while_loop``:
each trial point costs one value and gradient of the summed objective, and
one read of its value and slope to the host, where the search's scalars are
float64 numbers with IEEE semantics (``numpy.float64``: a NaN propagates
through ``maximum`` and compares false, a division by zero gives inf).  The
read of a step's first trial carries the slope along the direction, and the
iterate's value when the step computed it fresh; so a step synchronises
with the device once per line-search evaluation.  :data:`COUNTS` tallies
the steps, the evaluations (from each step's ``num_linesearch_steps``), the
fresh evaluations and the reads; :data:`TRACE` keeps each step's count and
accepted value.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

__all__ = [
    "ZoomLinesearchInfo",
    "LBFGSState",
    "init",
    "precondition",
    "zoom_linesearch",
    "update",
    "counts",
    "trace",
    "reset_counts",
]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0

#: Tally of the lbfgs steps run since the last :func:`reset_counts`:
#: ``steps``; ``linesearch_evals``, the sum of the steps'
#: ``num_linesearch_steps`` (one value and gradient each); ``fresh_evals``,
#: the value-and-gradient evaluations at an iterate (the first step, and
#: every step whose state holds a non-finite value); ``host_syncs``, the
#: reads of line-search scalars to the host.
COUNTS = {"steps": 0, "linesearch_evals": 0, "fresh_evals": 0, "host_syncs": 0}
#: Per step since the last :func:`reset_counts`: ``(num_linesearch_steps,
#: value)``, the value being the summed objective at the accepted point
#: (a host number already, so recording it costs no synchronisation).
TRACE: tp.List[tp.Tuple[int, float]] = []


def counts() -> tp.Dict[str, int]:
    return dict(COUNTS)


def trace() -> tp.List[tp.Tuple[int, float]]:
    return list(TRACE)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    TRACE.clear()


@dataclasses.dataclass
class ZoomLinesearchInfo:
    """``optax.ZoomLinesearchInfo`` of the last step."""

    num_linesearch_steps: int = 0
    decrease_error: float = float("inf")
    curvature_error: float = float("inf")


@dataclasses.dataclass
class LBFGSState:
    """The fields of optax's ``(ScaleByLBFGSState, EmptyState,
    ScaleByZoomLinesearchState)``; tensors hold the stacked leaves."""

    count: int  # steps taken
    params: torch.Tensor  # (L, ...) the previous iterate
    updates: torch.Tensor  # (L, ...) the gradient there
    diff_params_memory: torch.Tensor  # (MEMORY_SIZE, L, ...)
    diff_updates_memory: torch.Tensor  # (MEMORY_SIZE, L, ...)
    weights_memory: torch.Tensor  # (MEMORY_SIZE,)
    learning_rate: float  # the last accepted step size
    value: float  # the objective at the iterate, inf before the first step
    grad: torch.Tensor  # (L, ...) the gradient at the iterate
    info: ZoomLinesearchInfo


def init(params: torch.Tensor) -> LBFGSState:
    """``optax.lbfgs().init(params)`` for stacked leaves ``(L, ...)``."""
    zeros = torch.zeros_like(params)
    mem = torch.zeros((MEMORY_SIZE,) + tuple(params.shape), dtype=params.dtype,
                      device=params.device)
    return LBFGSState(
        count=0, params=zeros, updates=zeros.clone(), diff_params_memory=mem,
        diff_updates_memory=mem.clone(),
        weights_memory=torch.zeros((MEMORY_SIZE,), dtype=params.dtype, device=params.device),
        learning_rate=1.0, value=float("inf"), grad=zeros.clone(), info=ZoomLinesearchInfo(),
    )


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``optax.tree.vdot``: each leaf's sum of products, then the leaves'
    sums added in tree order."""
    per_leaf = torch.sum((a * b).reshape(a.shape[0], -1), dim=1)
    total = per_leaf[0]
    for i in range(1, a.shape[0]):
        total = total + per_leaf[i]
    return total


def precondition(updates, diff_params_memory, diff_updates_memory, weights_memory,
                 identity_scale, memory_idx: int) -> torch.Tensor:
    """optax's ``_precondition_by_lbfgs``: the two-loop recursion, newest
    pair first in the right product, over the ring from ``memory_idx``."""
    rhos = weights_memory
    n = weights_memory.shape[0]
    indices = [(memory_idx + i) % n for i in range(n)]
    vec = updates
    alphas = {}
    for idx in reversed(indices):
        alpha = rhos[idx] * _vdot(diff_params_memory[idx], vec)
        vec = vec + (-alpha) * diff_updates_memory[idx]
        alphas[idx] = alpha
    vec = identity_scale * vec
    for idx in indices:
        beta = rhos[idx] * _vdot(diff_updates_memory[idx], vec)
        vec = vec + (alphas[idx] - beta) * diff_params_memory[idx]
    return vec


def _scale_by_lbfgs(grad: torch.Tensor, state: LBFGSState, params: torch.Tensor):
    """optax's ``scale_by_lbfgs`` update: refresh the ring with the last
    step's pair, then precondition ``grad``.  Returns the preconditioned
    gradient and the new ring fields."""
    memory_idx = state.count % MEMORY_SIZE
    prev_memory_idx = (state.count - 1) % MEMORY_SIZE
    if state.count > 0:
        diff_params = params - state.params
        diff_updates = grad - state.updates
        vdot_diff = _vdot(diff_updates, diff_params)
        weight = torch.where(vdot_diff == 0.0, torch.zeros_like(vdot_diff), 1.0 / vdot_diff)
        # gamma: the scaled identity the recursion starts from
        denominator = _vdot(diff_updates, diff_updates)  # optax.tree.norm(squared=True)
        identity_scale = torch.where(denominator > 0.0, vdot_diff / denominator,
                                     torch.ones_like(vdot_diff))
    else:
        # No pair yet: a zero pair, and the capped reciprocal of |grad|.
        diff_params = diff_updates = torch.zeros_like(params)
        weight = torch.zeros((), dtype=params.dtype, device=params.device)
        identity_scale = torch.clamp(1.0 / torch.sqrt(_vdot(grad, grad)), max=1.0)
    dp_mem = state.diff_params_memory.clone()
    du_mem = state.diff_updates_memory.clone()
    w_mem = state.weights_memory.clone()
    dp_mem[prev_memory_idx] = diff_params
    du_mem[prev_memory_idx] = diff_updates
    w_mem[prev_memory_idx] = weight
    precond = precondition(grad, dp_mem, du_mem, w_mem, identity_scale, memory_idx)
    return precond, dp_mem, du_mem, w_mem


def _host(*vals: torch.Tensor) -> tp.List[np.float64]:
    """One device read of 0-d tensors, as float64 host scalars."""
    COUNTS["host_syncs"] += 1
    return [np.float64(v) for v in torch.stack([v.detach() for v in vals]).tolist()]


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
    approx = np.maximum(approx, delta_values)
    dec = np.minimum(approx, dec)
    dec = np.maximum(dec, 0.0)
    return np.float64(np.inf) if np.isnan(dec) else dec


def _curvature_error(slope_step, slope_init):
    curv = np.abs(slope_step) - CURV_RTOL * np.abs(slope_init)
    curv = np.maximum(curv, 0.0)
    return np.float64(np.inf) if np.isnan(curv) else curv


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``; NaN when the radical is negative."""
    cc = fpa
    db = b - a
    dc = c - a
    dbdc = db * dc
    denom = (dbdc * dbdc) * (db - dc)
    v0 = fb - fa - cc * db
    v1 = fc - fa - cc * dc
    big_a = (dc * dc * v0 + (-(db * db)) * v1) / denom
    big_b = ((-(dc * dc * dc)) * v0 + db * db * db * v1) / denom
    radical = big_b * big_b - 3.0 * big_a * cc
    return a + (-big_b + np.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    big_b = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * big_b)


@dataclasses.dataclass
class _Trial:
    stepsize: np.float64
    value: np.float64
    grad: torch.Tensor
    slope: np.float64


def zoom_linesearch(value_and_grad, params: torch.Tensor, updates: torch.Tensor,
                    value, grad: torch.Tensor):
    """optax's ``zoom_linesearch`` run to its end from step size 1 along
    ``updates``: an interval search (the step doubled) and then a zoom
    (cubic, else quadratic, else bisection), at most
    :data:`MAX_LINESEARCH_STEPS` evaluations, and its safe-step fallback.

    ``value_and_grad(z) -> (0-d tensor, gradient like z)`` is the summed
    objective; ``value`` is the objective at ``params`` (a host float, or a
    0-d tensor read with the first trial).  Returns ``(stepsize, value,
    grad, info)`` at the accepted step.
    """
    with np.errstate(all="ignore"):
        return _zoom(value_and_grad, params, updates, value, grad)


def _zoom(value_and_grad, params, updates, value, grad):
    slope_init_t = _vdot(updates, grad)

    def evaluate(stepsize, first=False):
        stepsize = float(stepsize)  # a Python number: the device multiplies in its dtype
        v, g = value_and_grad(params + stepsize * updates)
        slope = _vdot(g, updates)
        if first:
            extra = [value] if torch.is_tensor(value) else []
            read = _host(*extra, slope_init_t, v, slope)
            return read[:-2], _Trial(np.float64(stepsize), read[-2], g, read[-1])
        read = _host(v, slope)
        return None, _Trial(np.float64(stepsize), read[0], g, read[1])

    count = 0
    cur = None  # the last trial; before the first, stepsize 0 at the iterate
    value_init = slope_init = None
    low = high = cubic_ref = safe = None
    interval_found = done = failed = False
    dec_err = curv_err = np.float64(np.inf)
    while not (done or failed):
        if not interval_found:
            new_stepsize = 1.0 if count == 0 else INCREASE_FACTOR * cur.stepsize
            head, new = evaluate(new_stepsize, first=count == 0)
            if count == 0:
                value_init = np.float64(value) if not torch.is_tensor(value) else head[0]
                slope_init = head[-1]
                cur = _Trial(np.float64(0.0), value_init, grad, slope_init)
                safe = cur
            dec_err = _decrease_error(new.stepsize, new.value, new.slope, value_init, slope_init)
            curv_err = _curvature_error(new.slope, slope_init)
            new_error = np.maximum(dec_err, curv_err)
            if dec_err <= TOL:
                safe = new
            set_high_to_new = (dec_err > 0.0) or ((new.value >= cur.value) and count > 0)
            set_low_to_new = (new.slope >= 0.0) and not set_high_to_new
            low, high = (new, cur) if set_low_to_new else (cur, new)
            interval_found = set_high_to_new or set_low_to_new or (new_error <= TOL)
            done = bool(new_error <= TOL)
            failed = (count + 1 >= MAX_LINESEARCH_STEPS) and not done
            cubic_ref = low
            cur = new
        else:
            delta = np.abs(high.stepsize - low.stepsize)
            left = np.minimum(high.stepsize, low.stepsize)
            right = np.maximum(high.stepsize, low.stepsize)
            cubic_chk = 0.2 * delta
            quad_chk = 0.1 * delta
            too_small_int = delta <= STEPSIZE_PRECISION
            middle_cubic = _cubicmin(low.stepsize, low.value, low.slope, high.stepsize,
                                     high.value, cubic_ref.stepsize, cubic_ref.value)
            use_cubic = (middle_cubic > left + cubic_chk) and (middle_cubic < right - cubic_chk)
            middle_quad = _quadmin(low.stepsize, low.value, low.slope, high.stepsize, high.value)
            use_quad = (not use_cubic) and (middle_quad > left + quad_chk) and (
                middle_quad < right - quad_chk)
            if use_cubic:
                middle = middle_cubic
            elif use_quad:
                middle = middle_quad
            else:
                middle = (low.stepsize + high.stepsize) / 2.0
            _, mid = evaluate(middle)
            dec_err = _decrease_error(mid.stepsize, mid.value, mid.slope, value_init, slope_init)
            curv_err = _curvature_error(mid.slope, slope_init)
            new_error = np.maximum(dec_err, curv_err)
            if (dec_err <= TOL) and (mid.value < safe.value):
                safe = mid
            done = bool(new_error <= TOL)
            set_high_to_middle = (dec_err > 0.0) or (mid.value >= low.value)
            set_high_to_low = (mid.slope * (high.stepsize - low.stepsize) >= 0.0) and (
                not set_high_to_middle)
            old_low, old_high = low, high
            if set_high_to_middle:
                high = mid
            if set_high_to_low:
                high = old_low
            if not set_high_to_middle:
                low = mid
            cubic_ref = old_high if (set_high_to_middle or set_high_to_low) else old_low
            presumably_failed = (count + 1 >= MAX_LINESEARCH_STEPS) or (
                too_small_int and safe.stepsize > 0.0)
            failed = presumably_failed and not done
            cur = mid
        count += 1
        if failed and ((safe.stepsize > 0.0) or np.isinf(dec_err)):
            # optax's _try_safe_step: the step that met the decrease
            # criterion, or no step (size 0) when the last trial left the
            # domain and none did.
            cur = _Trial(safe.stepsize, safe.value, safe.grad, cur.slope)
    return float(cur.stepsize), float(cur.value), cur.grad, ZoomLinesearchInfo(
        count, float(dec_err), float(curv_err))


def update(value_and_grad, params: torch.Tensor, state: LBFGSState):
    """One ``optax.lbfgs()`` step from ``params`` (stacked leaves): the value
    and gradient from the state when finite, else fresh
    (``value_and_grad_from_state``); the preconditioned descent direction;
    the line search; ``params + stepsize * direction``.  Returns the new
    iterate and state."""
    COUNTS["steps"] += 1
    value, grad = state.value, state.grad
    if not np.isfinite(value):
        COUNTS["fresh_evals"] += 1
        value, grad = value_and_grad(params)
    precond, dp_mem, du_mem, w_mem = _scale_by_lbfgs(grad, state, params)
    direction = -1.0 * precond
    stepsize, ls_value, ls_grad, info = zoom_linesearch(value_and_grad, params, direction,
                                                        value, grad)
    COUNTS["linesearch_evals"] += info.num_linesearch_steps
    TRACE.append((info.num_linesearch_steps, ls_value))
    new_params = params + stepsize * direction
    return new_params, LBFGSState(
        count=state.count + 1, params=params, updates=grad, diff_params_memory=dp_mem,
        diff_updates_memory=du_mem, weights_memory=w_mem, learning_rate=stepsize,
        value=ls_value, grad=ls_grad, info=info,
    )
