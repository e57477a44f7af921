"""The port's ``optimizer="lbfgs"`` (``ops/lbfgs.py``) against optax and
the JAX package, in float64.

- The zoom line search alone against optax's, trial by trial (step size,
  value, ``num_linesearch_steps``), on 1-D lines chosen so that between
  them every branch runs: the doubling search, a trial that overshoots to
  a positive slope, the cubic and the quadratic minimisers, bisection, an
  interval shrunk below ``stepsize_precision``, the 20-step cap with its
  unsafe step, and a NaN trial value; then on a quadratic, Rosenbrock and
  the summed GP NLML.  The functions are computed the same way on both
  sides, so the 1-D, quadratic and Rosenbrock cases agree to 1e-15; the
  NLML goes through two different solvers, so to 1e-12.
- The two-loop recursion against ``optax.scale_by_lbfgs`` over 25 steps
  (the ring of 10 wraps twice); whole ``optax.lbfgs()`` iterates over up
  to 50 steps, until the gradient is round-off.
- ``fit_gp_batch(optimizer="lbfgs")`` against the JAX package at M = 4,
  T = 24 over 40 steps, step for step: each of the port's steps starts from
  the JAX state of the step before (the optax state carried over field by
  field) and must land on the JAX step's loss within 1e-9 relative, its
  parameters within 1e-8 (relative, or absolute near 0) and its
  ``num_linesearch_steps``.  Left to run
  alone, the two trajectories take equal line-search counts at every step,
  but they part faster than 1e-8: L-BFGS on this objective amplifies a
  change of one rounding in the NLML about twofold a step, and the JAX
  package parts from itself as fast under a 1e-15 relative change of y
  (measured in ``test_fit_free_running_parts_like_jax_from_itself``).
- The routes: chunked = merged bit for bit, warm in time, the dispatch; a
  NaN model (the whole batch goes NaN, as in the JAX package); the step
  and ``chunked_marginals`` on ragged, padded inputs; and the behaviour of
  the JAX package's own lbfgs tests (``tests/test_gp.py``).
"""

import functools
import types
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from optax._src import linesearch as optax_linesearch

from bayesian_ensembling_tpu.ops import gp as jgp
from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch.ops import gp as tgp
from bayesian_ensembling_tpu_torch.ops import lbfgs
from bayesian_ensembling_tpu_torch.ops import linalg_cuda
from bayesian_ensembling_tpu_torch.parallel import step as tstep

from test_torch_gp import make_block
from test_torch_step import scenario_blocks

torch.set_num_threads(1)

EXACT = 1e-15
NLML_TOL = 1e-12
LOSS_RTOL = 1e-9
PARAM_TOL = 1e-8
STEP_TOL = 1e-8  # through the DBA, the fit, the posterior and the tail


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float64)))


# --- the line search alone ------------------------------------------------

def _line(kind):
    """A 1-D objective along the line params = 0, direction = +1 (so the
    trial point is the step size), in numpy-like form for both sides."""

    def nan_where(xp, cond, val):
        return xp.where(cond, xp.full_like(val, np.nan), val)

    return {
        # first trial overshoots into a rising value: quadratic interpolation
        "quad": lambda xp, z: (z - 0.3) ** 2,
        # a quadratic after one bisection, then the cubic
        "cubic": lambda xp, z: xp.exp(3 * z) - 4 * z,
        # the first trial lands past the minimum with a positive slope and
        # sufficient decrease: low moves to the trial
        "overshoot": lambda xp, z: (z - 0.51) ** 2,
        # far minimum: the search doubles the step three times
        "doubling": lambda xp, z: (z - 50.0) ** 2,
        # the curvature test never passes (|slope| is constant): the zoom
        # shrinks the interval below stepsize_precision, then the safe step
        "kink": lambda xp, z: xp.abs(z - 0.37),
        # not a descent direction: 20 trials, then the unsafe last one
        "ascent": lambda xp, z: (z + 1.0) ** 2,
        # NaN beyond 0.5: such a trial counts as too large a step
        "nan": lambda xp, z: nan_where(xp, z >= 0.5, (z - 0.45) ** 2),
        # a wiggle: the sine's slope turns the secant test
        "sine": lambda xp, z: xp.sin(8 * z) + 0.1 * z,
    }[kind]


def _optax_trials(fun, params, updates):
    """optax's zoom line search run as a Python loop of its own step
    function: the state after every iteration and the final one."""
    init, step, cond = optax_linesearch.zoom_linesearch(
        max_linesearch_steps=20, tol=0.0, increase_factor=2.0, slope_rtol=1e-4,
        curv_rtol=0.9, approx_dec_rtol=1e-6, interval_threshold=1e-5,
    )
    value, grad = jax.value_and_grad(fun)(params)
    state = init(updates, params, value=value, grad=grad, initial_guess_strategy="one")
    step = jax.jit(functools.partial(step, value_and_grad_fn=jax.value_and_grad(fun),
                                     fn_kwargs={}))
    states = []
    while bool(cond(state)):
        state = step(state)
        states.append(state)
    return states


def _port_trials(fun, params, updates, monkeypatch=None):
    """The port's line search; returns its trials (step size, value), its
    result and the branches its zoom iterations took."""
    trials = []

    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            v = fun(z)
            (g,) = torch.autograd.grad(v, z)
        return v.detach(), g

    v0, g0 = vg(params)
    picks = []
    if monkeypatch is not None:
        cub, quad = lbfgs._cubicmin, lbfgs._quadmin
        monkeypatch.setattr(lbfgs, "_cubicmin", lambda *a: picks.append(("cubic", cub(*a))) or picks[-1][1])
        monkeypatch.setattr(lbfgs, "_quadmin", lambda *a: picks.append(("quad", quad(*a))) or picks[-1][1])

    def recording_vg(z):
        v, g = vg(z)
        trials.append(v.item())
        return v, g

    out = lbfgs.zoom_linesearch(recording_vg, params, updates, v0.item(), g0)
    return trials, out, picks


def _zoom_branches(picks, stepsizes):
    """Which of cubic / quadratic / bisection gave each zoom trial (the
    trial step sizes after the interval search)."""
    cubic = [v for k, v in picks if k == "cubic"]
    quad = [v for k, v in picks if k == "quad"]
    first = len(stepsizes) - len(cubic)
    names = []
    for i, s in enumerate(stepsizes[first:]):
        names.append("cubic" if s == cubic[i] else "quad" if s == quad[i] else "bisect")
    return names


LINE_CASES = ["quad", "cubic", "overshoot", "doubling", "kink", "ascent", "nan", "sine"]


@pytest.mark.parametrize("kind", LINE_CASES)
def test_zoom_linesearch_matches_optax_trial_by_trial(kind, monkeypatch):
    f = _line(kind)
    states = _optax_trials(lambda p: jnp.sum(f(jnp, p)), jnp.zeros((1, 1)), jnp.ones((1, 1)))
    trials, (stepsize, value, _, info), picks = _port_trials(
        lambda z: torch.sum(f(torch, z)), torch.zeros((1, 1), dtype=torch.float64),
        torch.ones((1, 1), dtype=torch.float64), monkeypatch)
    assert info.num_linesearch_steps == len(states) == int(states[-1].count)
    for s, v in zip(states[:-1], trials[:-1]):  # the last may be the safe step
        np.testing.assert_allclose(v, float(s.value), rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(stepsize, float(states[-1].stepsize), rtol=EXACT, atol=0)
    np.testing.assert_allclose(value, float(states[-1].value), rtol=EXACT, atol=EXACT)
    assert info.decrease_error == pytest.approx(float(states[-1].decrease_error), rel=1e-12, abs=1e-15)
    assert info.curvature_error == pytest.approx(float(states[-1].curvature_error), rel=1e-12, abs=1e-15)


def _branch_trace(kind, monkeypatch):
    f = _line(kind)
    stepsizes = []
    fun = lambda z: torch.sum(f(torch, z))  # noqa: E731

    def vg(z):
        stepsizes.append(float(z[0, 0]))
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            v = fun(z)
            (g,) = torch.autograd.grad(v, z)
        return v.detach(), g

    zero = torch.zeros((1, 1), dtype=torch.float64)
    v0, g0 = vg(zero)
    stepsizes.clear()
    picks = []
    cub, quad = lbfgs._cubicmin, lbfgs._quadmin
    monkeypatch.setattr(lbfgs, "_cubicmin", lambda *a: picks.append(("cubic", cub(*a))) or picks[-1][1])
    monkeypatch.setattr(lbfgs, "_quadmin", lambda *a: picks.append(("quad", quad(*a))) or picks[-1][1])
    out = lbfgs.zoom_linesearch(vg, zero, torch.ones((1, 1), dtype=torch.float64), v0.item(), g0)
    return stepsizes, _zoom_branches(picks, stepsizes), out


def test_line_cases_cover_every_branch(monkeypatch):
    """Between them the 1-D cases run every branch of the zoom."""
    seen = {}
    for kind in LINE_CASES:
        stepsizes, branches, out = _branch_trace(kind, monkeypatch)
        seen[kind] = (stepsizes, branches, out)
    assert "quad" in seen["quad"][1] and "cubic" in seen["cubic"][1]
    assert "bisect" in seen["cubic"][1] and "bisect" in seen["nan"][1]
    assert seen["doubling"][0] == [1.0, 2.0, 4.0, 8.0] and seen["doubling"][1] == []
    # overshoot: the first trial meets the decrease test with a positive
    # slope, so it becomes the interval's low end and the zoom follows
    assert seen["overshoot"][0][0] == 1.0 and seen["overshoot"][1] == ["quad"]
    # kink: ends before the cap on a shrunken interval with a safe step
    assert seen["kink"][2][3].num_linesearch_steps < lbfgs.MAX_LINESEARCH_STEPS
    assert seen["kink"][2][3].curvature_error > 0
    # ascent: the cap, and the last trial kept (no safe step exists)
    ascent = seen["ascent"]
    assert ascent[2][3].num_linesearch_steps == lbfgs.MAX_LINESEARCH_STEPS
    assert ascent[2][0] == ascent[0][-1]
    # nan: a NaN trial value shrinks the step, and the step found is finite
    assert any(s >= 0.5 for s in seen["nan"][0]) and np.isfinite(seen["nan"][2][1])


def test_linesearch_with_a_nan_iterate_takes_no_step():
    """A NaN value at the iterate: no trial can meet the decrease test, the
    search runs to the cap, and optax's safe step is size 0 with the
    iterate's (NaN) value and gradient."""
    u = torch.tensor([[-1.0]], dtype=torch.float64)
    z = torch.zeros((1, 1), dtype=torch.float64)
    calls = []

    def vg(p):
        calls.append(p)
        return torch.tensor(float("nan"), dtype=torch.float64), torch.full_like(p, float("nan"))

    g0 = torch.full_like(z, float("nan"))
    stepsize, value, grad, info = lbfgs.zoom_linesearch(vg, z, u, float("nan"), g0)
    assert stepsize == 0.0 and np.isnan(value) and grad is g0
    assert info.num_linesearch_steps == len(calls) == lbfgs.MAX_LINESEARCH_STEPS
    assert info.decrease_error == float("inf")


def _quadratic(xp, z):
    a = xp.asarray(np.array([[3.0, 0.5, 1.0], [0.5, 2.0, 4.0]]))
    return xp.sum(a * (z - 0.25) ** 2) + xp.sum(z[0] * z[1])


def _rosenbrock(xp, z):
    x = z.reshape(-1)
    return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _jax_gp_objective(x, y, v):
    xj, yj, vj = map(jnp.asarray, (x, y, v))

    def total(p):  # p: (2, M) stacked raw leaves
        params = jgp.GPParams(raw_lengthscale=p[0], raw_variance=p[1])
        return jnp.sum(jax.vmap(jgp.nlml)(params, xj, yj, vj))

    return total


def _port_gp_objective(x, y, v):
    """The summed NLML as the port's fit evaluates it."""
    x, y, v = _t(x), _t(y), _t(v)
    precompute, apply_fn = tgp.get_kernel_precomputed("matern32")
    stat = precompute(x, x)
    ky0 = torch.diag_embed(v) + 1e-6 * torch.eye(x.shape[1], dtype=torch.float64)

    def total(z):
        k = apply_fn(types.SimpleNamespace(lengthscale=tgp.softplus(z[0]),
                                           variance=tgp.softplus(z[1])), stat)
        quad, logdet = linalg_cuda.nlml_terms(k + ky0, y)
        return torch.sum(0.5 * (quad + logdet + x.shape[1] * np.log(2 * np.pi)))

    return total


def _gp_inputs(seed, t=24, m=4):
    block, mask = make_block(seed, m=m, t=t)
    x, y, v = jgp.prepare_gp_inputs(jnp.asarray(block), jnp.asarray(mask), dba_iterations=2)
    return np.array(x), np.array(y), np.array(v)


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock", "gp_nlml"])
@pytest.mark.parametrize("direction", ["gradient", "scaled"])
def test_zoom_linesearch_matches_optax_on_objectives(problem, direction):
    """``optax.scale_by_zoom_linesearch`` (max 20 steps, step 1 first) and
    the port along -g and along -g / |g|: step size, value, count, and the
    value and gradient it hands the next step."""
    if problem == "gp_nlml":
        x, y, v = _gp_inputs(1)
        jf, tf = _jax_gp_objective(x, y, v), _port_gp_objective(x, y, v)
        p0 = np.stack([np.linspace(-0.5, 0.8, 4), np.linspace(0.3, -0.2, 4)])
        tol = NLML_TOL
    else:
        fun = _quadratic if problem == "quadratic" else _rosenbrock
        jf, tf = functools.partial(fun, jnp), functools.partial(fun, torch)
        p0 = np.array([[-0.6, 1.2, 0.3], [0.9, -1.1, 0.4]])
        tol = EXACT * 10
    jp = jnp.asarray(p0)
    value, grad = jax.value_and_grad(jf)(jp)
    scale = 1.0 if direction == "gradient" else 1.0 / float(jnp.linalg.norm(grad))
    upd = -scale * grad
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20, initial_guess_strategy="one")
    st = ls.init(jp)
    scaled, st = ls.update(upd, st, jp, value=value, grad=grad, value_fn=jf)

    tz = _t(p0)
    with torch.enable_grad():
        zz = tz.clone().requires_grad_(True)
        tv = tf(zz)
        (tg,) = torch.autograd.grad(tv, zz)

    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            val = tf(z)
            (g,) = torch.autograd.grad(val, z)
        return val.detach(), g

    stepsize, lv, lg, info = lbfgs.zoom_linesearch(vg, tz, -scale * tg, tv.item(), tg)
    assert info.num_linesearch_steps == int(st.info.num_linesearch_steps)
    np.testing.assert_allclose(stepsize, float(st.learning_rate), rtol=tol)
    np.testing.assert_allclose(lv, float(st.value), rtol=tol)
    np.testing.assert_allclose(lg.numpy(), np.asarray(st.grad), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose((stepsize * (-scale * tg)).numpy(), np.asarray(scaled),
                               rtol=1e-10, atol=1e-13)


# --- the two-loop recursion and whole iterates -----------------------------

def test_two_loop_recursion_matches_optax_across_the_ring():
    """``optax.scale_by_lbfgs`` (memory 10, scaled identity) fed 25 steps of
    random iterates and gradients; the port's ring, weights and
    preconditioned gradient at every step."""
    rng = np.random.default_rng(7)
    tx = optax.scale_by_lbfgs(memory_size=10, scale_init_precond=True)
    m = 5
    jparams = jgp.GPParams(raw_lengthscale=jnp.zeros(m), raw_variance=jnp.zeros(m))
    jstate = tx.init(jparams)
    tstate = lbfgs.init(torch.zeros((2, m), dtype=torch.float64))
    base = rng.normal(size=(2, m))
    for k in range(25):
        p = base + 0.3 * rng.normal(size=(2, m)) / (k + 1)
        g = 2.0 * p + 0.05 * rng.normal(size=(2, m))
        jp = jgp.GPParams(raw_lengthscale=jnp.asarray(p[0]), raw_variance=jnp.asarray(p[1]))
        jg = jgp.GPParams(raw_lengthscale=jnp.asarray(g[0]), raw_variance=jnp.asarray(g[1]))
        jout, jstate = tx.update(jg, jstate, jp)
        out, dp, du, w = lbfgs._scale_by_lbfgs(_t(g), tstate, _t(p))
        tstate = lbfgs.LBFGSState(
            count=tstate.count + 1, params=_t(p), updates=_t(g), diff_params_memory=dp,
            diff_updates_memory=du, weights_memory=w, learning_rate=1.0, value=0.0,
            grad=_t(g), info=lbfgs.ZoomLinesearchInfo())
        want = np.stack([np.asarray(jout.raw_lengthscale), np.asarray(jout.raw_variance)])
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-11, atol=1e-13)
        np.testing.assert_allclose(w.numpy(), np.asarray(jstate.weights_memory), rtol=1e-12)
        for i, leaf in enumerate(("raw_lengthscale", "raw_variance")):
            np.testing.assert_allclose(dp[:, i].numpy(),
                                       np.asarray(getattr(jstate.diff_params_memory, leaf)),
                                       rtol=0, atol=1e-15)
            np.testing.assert_allclose(du[:, i].numpy(),
                                       np.asarray(getattr(jstate.diff_updates_memory, leaf)),
                                       rtol=0, atol=1e-15)


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock"])
def test_lbfgs_iterates_match_optax_over_50_steps(problem):
    fun = _quadratic if problem == "quadratic" else _rosenbrock
    jf, tf = functools.partial(fun, jnp), functools.partial(fun, torch)
    p0 = np.array([[-0.6, 1.2, 0.3], [0.9, -1.1, 0.4]])
    solver = optax.lbfgs()
    jp = jnp.asarray(p0)
    jst = solver.init(jp)
    vag = optax.value_and_grad_from_state(jf)
    tz = _t(p0)
    tst = lbfgs.init(tz)

    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            val = tf(z)
            (g,) = torch.autograd.grad(val, z)
        return val.detach(), g

    @jax.jit
    def jax_step(jp, jst):
        value, grad = vag(jp, state=jst)
        upd, jst = solver.update(grad, jst, jp, value=value, grad=grad, value_fn=jf)
        return optax.apply_updates(jp, upd), jst, jnp.linalg.norm(grad)

    for k in range(50):
        jp1, jst1, gnorm = jax_step(jp, jst)
        if float(gnorm) < 1e-7:
            # converged: from here on the line search's comparisons are
            # between values equal to round-off, and either side may tie
            break
        jp, jst = jp1, jst1
        tz, tst = lbfgs.update(vg, tz, tst)
        ls = jst[2]
        assert tst.info.num_linesearch_steps == int(ls.info.num_linesearch_steps), k
        np.testing.assert_allclose(tz.numpy(), np.asarray(jp), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tst.learning_rate, float(ls.learning_rate), rtol=1e-9)
        np.testing.assert_allclose(tst.value, float(ls.value), rtol=1e-9, atol=1e-15)
    assert k >= 10, k  # several steps held, then converged (Rosenbrock: a local minimum)
    np.testing.assert_allclose(tst.value, float(jf(jp)), rtol=1e-9, atol=1e-15)


# --- fit_gp_batch against the JAX package ----------------------------------

def _port_state(st):
    """optax's lbfgs state (GPParams leaves) as the port's LBFGSState."""
    lb, _, ls = st

    def stack(p):
        return torch.stack([_t(p.raw_lengthscale), _t(p.raw_variance)], dim=-2)

    return lbfgs.LBFGSState(
        count=int(lb.count), params=stack(lb.params), updates=stack(lb.updates),
        diff_params_memory=stack(lb.diff_params_memory),
        diff_updates_memory=stack(lb.diff_updates_memory),
        weights_memory=_t(lb.weights_memory), learning_rate=float(ls.learning_rate),
        value=float(ls.value), grad=stack(ls.grad),
        info=lbfgs.ZoomLinesearchInfo(int(ls.info.num_linesearch_steps),
                                      float(ls.info.decrease_error),
                                      float(ls.info.curvature_error)))


def _jax_steps(x, y, v, n, init=None):
    m = x.shape[0]
    if init is None:
        params = jax.vmap(lambda _: jgp.init_params(dtype=jnp.float64))(jnp.arange(m))
    else:
        params = init
    opt = jgp._make_batch_opt("lbfgs", 0.01)
    st = opt.init(params)
    step = jax.jit(jgp._build_batch_step(opt, *map(jnp.asarray, (x, y, v)), "matern32", 1e-6,
                                         "lbfgs"))
    out = [(params, st, None)]
    for _ in range(n):
        (params, st), loss = step((params, st), None)
        out.append((params, st, np.asarray(loss)))
    return out


def test_fit_matches_jax_step_for_step():
    """40 steps at M = 4, T = 24: each port step from the JAX state before
    it lands on the JAX step (loss 1e-9 relative, parameters 1e-8, equal
    line-search counts, the state's fields)."""
    x, y, v = _gp_inputs(4)
    traj = _jax_steps(x, y, v, 40)
    step = tgp._build_batch_step(_t(x), _t(y), _t(v), "matern32", 1e-6, "lbfgs")
    counts = []
    for k in range(40):
        jp, jst, _ = traj[k]
        jp1, jst1, jloss = traj[k + 1]
        params = convert.gp_params_from_jax(np.asarray(jp.raw_lengthscale),
                                            np.asarray(jp.raw_variance), "cpu", torch.float64)
        opt = types.SimpleNamespace(state=_port_state(jst))
        loss = step(params, opt)
        want = _port_state(jst1)
        assert opt.state.info.num_linesearch_steps == want.info.num_linesearch_steps, k
        assert opt.state.count == want.count
        np.testing.assert_allclose(loss.numpy(), jloss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(params.raw_lengthscale.detach().numpy(),
                                   np.asarray(jp1.raw_lengthscale), rtol=PARAM_TOL, atol=PARAM_TOL)
        np.testing.assert_allclose(params.raw_variance.detach().numpy(),
                                   np.asarray(jp1.raw_variance), rtol=PARAM_TOL, atol=PARAM_TOL)
        # an interpolated step size moves more than the iterate it makes
        np.testing.assert_allclose(opt.state.learning_rate, want.learning_rate, rtol=1e-6)
        np.testing.assert_allclose(opt.state.value, want.value, rtol=LOSS_RTOL)
        np.testing.assert_allclose(opt.state.grad.numpy(), want.grad.numpy(), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(opt.state.weights_memory.numpy(), want.weights_memory.numpy(),
                                   rtol=1e-6)
        counts.append(want.info.num_linesearch_steps)
    assert max(counts) > 1  # some steps searched beyond the first trial


def test_fit_free_running_parts_like_jax_from_itself():
    """Both whole 40-step fits take equal line-search counts at every step;
    the port parts from the JAX fit by no more than the JAX fit parts from
    itself when y moves by 1e-15 relative (ten times that, for margin)."""
    x, y, v = _gp_inputs(4)
    traj = _jax_steps(x, y, v, 40)
    perturbed = _jax_steps(x, y * (1 + 1e-15), v, 40)
    params = tgp._start_params(4, _t(y), None)
    opt = tgp._make_batch_opt("lbfgs", 0.01, params)
    step = tgp._build_batch_step(_t(x), _t(y), _t(v), "matern32", 1e-6, "lbfgs")
    for k in range(40):
        loss = step(params, opt)
        assert opt.state.info.num_linesearch_steps == int(traj[k + 1][1][2].info.num_linesearch_steps)
    jp, jloss = traj[-1][0], traj[-1][2]
    kp, kloss = perturbed[-1][0], perturbed[-1][2]
    self_gap = max(np.max(np.abs(np.asarray(kp.raw_lengthscale) - np.asarray(jp.raw_lengthscale))),
                   np.max(np.abs(np.asarray(kp.raw_variance) - np.asarray(jp.raw_variance))))
    gap = max(np.max(np.abs(params.raw_lengthscale.detach().numpy() - np.asarray(jp.raw_lengthscale))),
              np.max(np.abs(params.raw_variance.detach().numpy() - np.asarray(jp.raw_variance))))
    assert self_gap > 1e-6  # the JAX fit itself is this sensitive
    assert gap <= 10 * self_gap
    self_loss = np.max(np.abs(kloss - jloss) / np.abs(jloss))
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=10 * self_loss)


def test_fit_gp_batch_counts_and_shapes():
    x, y, v = _gp_inputs(5)
    lbfgs.reset_counts()
    params, losses = tgp.fit_gp_batch(_t(x), _t(y), _t(v), n_optim_nits=12, optimizer="lbfgs")
    c = lbfgs.counts()
    assert losses.shape == (4, 12) and torch.isfinite(losses).all()
    assert c["steps"] == 12 and c["fresh_evals"] == 1
    assert c["host_syncs"] == c["linesearch_evals"] >= 12
    want = jgp.fit_gp_batch(*map(jnp.asarray, (x, y, v)), n_optim_nits=12, optimizer="lbfgs")
    np.testing.assert_allclose(losses.numpy(), np.asarray(want[1]), rtol=LOSS_RTOL)


@pytest.mark.parametrize("chunk", [1, 5, 12])
def test_chunked_equals_merged_bit_for_bit(chunk):
    """The state (ring, value, gradient) carries across segments, so the
    chunked fit repeats the merged fit's steps exactly; both agree with the
    JAX chunked fit."""
    x, y, v = _gp_inputs(6)
    merged = tgp.fit_gp_batch(_t(x), _t(y), _t(v), n_optim_nits=12, optimizer="lbfgs")
    chunked = tgp.fit_gp_batch_chunked(_t(x), _t(y), _t(v), n_optim_nits=12, optimizer="lbfgs",
                                       chunk_steps=chunk)
    assert torch.equal(merged[1], chunked[1])
    assert torch.equal(merged[0].raw_lengthscale, chunked[0].raw_lengthscale)
    assert torch.equal(merged[0].raw_variance, chunked[0].raw_variance)
    want = jgp.fit_gp_batch_chunked(*map(jnp.asarray, (x, y, v)), n_optim_nits=12,
                                    optimizer="lbfgs", chunk_steps=chunk)
    np.testing.assert_allclose(chunked[1].numpy(), np.asarray(want[1]), rtol=LOSS_RTOL)


@pytest.mark.parametrize(
    "route",
    [dict(), dict(chunk_steps=4), dict(time_stride=3, fine_steps=5),
     dict(time_stride=3, fine_steps=5, chunk_steps=2)],
)
def test_dispatch_routes_match_jax(route):
    x, y, v = _gp_inputs(8, t=20)
    want = jgp.fit_gp_batch_dispatch(*map(jnp.asarray, (x, y, v)), n_optim_nits=8,
                                     optimizer="lbfgs", **route)
    got = tgp.fit_gp_batch_dispatch(_t(x), _t(y), _t(v), n_optim_nits=8, optimizer="lbfgs",
                                    **route)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0].raw_lengthscale.detach().numpy(),
                               np.asarray(want[0].raw_lengthscale), rtol=0, atol=PARAM_TOL)
    np.testing.assert_allclose(got[0].raw_variance.detach().numpy(),
                               np.asarray(want[0].raw_variance), rtol=0, atol=PARAM_TOL)


def test_warm_time_matches_jax():
    x, y, v = _gp_inputs(9, t=24)
    want = jgp.fit_gp_batch_warm_time(*map(jnp.asarray, (x, y, v)), time_stride=4,
                                      coarse_steps=6, fine_steps=6, optimizer="lbfgs")
    got = tgp.fit_gp_batch_warm_time(_t(x), _t(y), _t(v), time_stride=4, coarse_steps=6,
                                     fine_steps=6, optimizer="lbfgs")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0].raw_lengthscale.detach().numpy(),
                               np.asarray(want[0].raw_lengthscale), rtol=0, atol=PARAM_TOL)


def test_a_nan_model_turns_the_batch_nan_like_jax():
    """One model starts at a NaN lengthscale: the summed objective is NaN,
    the direction is NaN, the line search runs to its cap and optax's safe
    step of size 0 (0 x NaN) turns every model NaN, in both packages; every
    later step evaluates fresh and searches 20 trials.  The warning names
    the models and says so."""
    x, y, v = _gp_inputs(3, t=20, m=3)
    ls = np.array([0.3, np.nan, -0.4])
    var = np.array([0.1, 0.2, 0.5])
    want = jgp.fit_gp_batch(*map(jnp.asarray, (x, y, v)), n_optim_nits=3, optimizer="lbfgs",
                            init=jgp.GPParams(raw_lengthscale=jnp.asarray(ls),
                                              raw_variance=jnp.asarray(var)))
    assert np.isnan(np.asarray(want[0].raw_lengthscale)).all()
    lbfgs.reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tgp.fit_gp_batch(_t(x), _t(y), _t(v), n_optim_nits=3, optimizer="lbfgs",
                               init=convert.gp_params_from_jax(ls, var, "cpu", torch.float64))
    assert torch.isnan(got[0].raw_lengthscale).all() and torch.isnan(got[0].raw_variance).all()
    assert torch.isnan(got[1]).all() and np.isnan(np.asarray(want[1])).all()
    assert lbfgs.counts() == {"steps": 3, "linesearch_evals": 60, "fresh_evals": 3,
                              "host_syncs": 60}
    msgs = [str(w.message) for w in caught]
    assert any("model(s) [0, 1, 2]" in msg and "every model's hyperparameters NaN" in msg
               for msg in msgs), msgs


# --- through the step --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_multi_scenario_step_matches_jax(seed):
    """S = 2 scenarios, M = 3 ragged models padded to 4 by ``pad_models``:
    the padded rows are part of each batch's summed objective, and so of
    its step size, in both packages."""
    hb, hm, sb, sm, obs = scenario_blocks(seed)
    padded = [jstep.pad_models(hb[i], hm[i], 4) for i in range(2)]
    spadded = [jstep.pad_models(sb[i], sm[i], 4) for i in range(2)]
    hb4 = np.stack([np.asarray(p[0]) for p in padded])
    hm4 = np.stack([np.asarray(p[1]) for p in padded])
    mm = np.stack([np.asarray(p[2]) for p in padded])
    sb4 = np.stack([np.asarray(p[0]) for p in spadded])
    sm4 = np.stack([np.asarray(p[1]) for p in spadded])
    kw = dict(n_optim_nits=6, dba_iterations=2, optimizer="lbfgs")
    args = (hb4, hm4, sb4, sm4, obs, mm)
    want = jstep.ensemble_multi_scenario_step(*(jnp.asarray(a) for a in args), **kw)
    got = tstep.ensemble_multi_scenario_step(*(_t(a) for a in args), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_TOL)
    assert (got[2][:, 3] == 0).all()


def test_scenario_step_matches_jax():
    hb, hm, sb, sm, obs = (a[0] if a.ndim > 2 else a for a in scenario_blocks(3, s=1))
    kw = dict(n_optim_nits=6, dba_iterations=2, optimizer="lbfgs")
    want = jstep.ensemble_scenario_step(*(jnp.asarray(a) for a in (hb, hm, sb, sm, obs)), **kw)
    got = tstep.ensemble_scenario_step(*(_t(a) for a in (hb, hm, sb, sm, obs)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_TOL)


@pytest.mark.parametrize("chunk", [3, 4, 10])
def test_chunked_marginals_matches_jax(chunk):
    """Each chunk runs its own line search; the last chunk's pad rows are
    replicated real rows, which weigh in that chunk's step size (chunk 4:
    two pad rows; chunk 10: the batch tiled).  Bit for bit the port's own
    per-chunk fits."""
    rng = np.random.default_rng(chunk)
    b, r, t = 5, 3, 12
    block = rng.normal(size=(b, r, t)) + np.linspace(0.0, 1.0, t)
    mask = np.ones((b, r), bool)
    mask[::3, 2] = False
    block[~mask] = 0.0
    kw = dict(n_optim_nits=6, dba_iterations=2, optimizer="lbfgs")
    em = functools.partial(tstep.emulate_marginals, **kw)
    got = tstep.chunked_marginals(em, _t(block), torch.from_numpy(mask), chunk)
    want = jstep.chunked_marginals(jax.jit(functools.partial(jstep.emulate_marginals, **kw)),
                                   jnp.asarray(block), jnp.asarray(mask), chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_TOL)
    # the last chunk's fit, by hand: its replicated pad rows share its line search
    g = -(-b // chunk)
    reps = -(-(g * chunk - b) // b)
    tiled = torch.cat([_t(block)] * (reps + 1))[: g * chunk]
    tmask = torch.cat([torch.from_numpy(mask)] * (reps + 1))[: g * chunk]
    last = em(tiled[(g - 1) * chunk:], tmask[(g - 1) * chunk:])
    lo = (g - 1) * chunk
    assert torch.equal(got[0][lo:], last[0][: b - lo])


# --- the JAX package's own lbfgs tests, on the port --------------------------

def _problems(rng, m, t, d):
    xs, ys, ns = [], [], []
    for _ in range(m):
        x = rng.normal(size=(t, d))
        xs.append(x)
        ys.append(np.sin(x[:, 0]) + 0.1 * rng.normal(size=t))
        ns.append(rng.uniform(0.05, 0.2, t))
    return _t(np.stack(xs)), _t(np.stack(ys)), _t(np.stack(ns))


def test_lbfgs_converges_faster_than_adam():
    """(``tests/test_gp.py::test_fit_gp_batch_lbfgs_converges_faster``)
    lbfgs-40 reaches Adam-500's NLML."""
    xb, yb, nb = _problems(np.random.default_rng(0), 3, 24, 3)
    _, adam = tgp.fit_gp_batch(xb, yb, nb, n_optim_nits=500)
    _, lb = tgp.fit_gp_batch(xb, yb, nb, n_optim_nits=40, optimizer="lbfgs")
    assert torch.isfinite(lb[:, -1]).all()
    assert (lb[:, -1] <= adam[:, -1] + 0.5).all()


def test_lbfgs_batch_matches_per_model_fits():
    """(``tests/test_gp.py::test_lbfgs_batch_matches_per_model_fits``) the
    shared step size couples the trajectories, but the summed objective is
    separable, so the converged NLMLs match independent per-model fits."""
    xb, yb, nb = _problems(np.random.default_rng(0), 8, 24, 3)
    _, batch = tgp.fit_gp_batch(xb, yb, nb, n_optim_nits=60, optimizer="lbfgs")
    solo = [tgp.fit_gp_batch(xb[i:i + 1], yb[i:i + 1], nb[i:i + 1], n_optim_nits=60,
                             optimizer="lbfgs")[1][0, -1].item() for i in range(8)]
    np.testing.assert_allclose(batch[:, -1].numpy(), solo, rtol=1e-4, atol=1e-3)


# --- float32: the summed objective's round-off stalls the line search -------

_JAX_F32_COUNTS = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from bayesian_ensembling_tpu.ops import gp as jgp
x, y, v = (np.load(sys.argv[1])[k] for k in ("x", "y", "v"))
params = jax.vmap(lambda _: jgp.init_params(dtype=jnp.float32))(jnp.arange(x.shape[0]))
opt = jgp._make_batch_opt("lbfgs", 0.01)
st = opt.init(params)
step = jax.jit(jgp._build_batch_step(opt, *map(jnp.asarray, (x, y, v)), "matern32", 1e-6, "lbfgs"))
counts = []
for _ in range(int(sys.argv[2])):
    (params, st), _ = step((params, st), None)
    counts.append(int(st[2].info.num_linesearch_steps))
print(json.dumps(counts))
"""


def test_float32_line_search_stalls_in_both_packages(tmp_path):
    """At scenario 0 of ``chip_smoke.py``'s flagship (16 models, T = 165),
    float32 L-BFGS takes one trial a step for about 25 steps; then the
    float32 round-off of the 16-model summed NLML swamps the decrease and
    curvature tests and many line searches run to their cap of 20.  The JAX
    package in float32 (run without x64, as on the TPU) does the same; in
    float64 the port stays near one trial a step.  This is why phase 13's
    float32 flagship takes about 16 evaluations a step (PERF.md, PR 12)."""
    import json
    import os
    import subprocess
    import sys

    import chip_smoke as cs

    hb, hm, *_ = cs.synthetic_flagship(0)
    n = 45
    x, y, v = jgp.prepare_gp_inputs(jnp.asarray(hb[0].astype(np.float32)), jnp.asarray(hm[0]),
                                    dba_iterations=10)
    x, y, v = (np.asarray(a, np.float32) for a in (x, y, v))
    np.savez(tmp_path / "in.npz", x=x, y=y, v=v)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_ENABLE_X64="0", PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _JAX_F32_COUNTS, str(tmp_path / "in.npz"), str(n)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    jax_counts = json.loads(proc.stdout.strip().splitlines()[-1])
    port = {}
    for dtype in (torch.float32, torch.float64):
        lbfgs.reset_counts()
        tgp.fit_gp_batch(*(torch.from_numpy(a).to(dtype) for a in (x, y, v)), n_optim_nits=n,
                         optimizer="lbfgs")
        port[dtype] = [c for c, _ in lbfgs.trace()]
    for counts in (jax_counts, port[torch.float32]):
        assert len(counts) == n
        assert np.mean(counts[:20]) < 1.5  # one trial a step at first
        assert counts.count(lbfgs.MAX_LINESEARCH_STEPS) >= 2  # then searches hit the cap
        assert np.mean(counts[25:]) > 5
    assert np.mean(port[torch.float64]) < 2


def test_chip_smoke_phases_13_and_14_rehearsed_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phases 13 and 14 at a tiny size with the plain
    versions: the CPU has no launch counters, so the launch checks are
    replaced; the route counts still follow ``lbfgs_expected_launches``."""
    import bayesian_ensembling_tpu_torch as bt
    import chip_smoke as cs

    routes = []
    monkeypatch.setattr(cs, "_counts_match",
                        lambda got, want: routes.append((got, want)) or True)
    monkeypatch.setattr(cs, "_launched", lambda counts, names: True)
    inputs = cs.synthetic_flagship(0, scenarios=2, models=4, min_real_models=3, realisations=3,
                                   t_hist=20, t_ssp=10, obs_members=5)
    report = {}
    cpu = torch.device("cpu")
    assert cs.run_lbfgs(torch, bt, inputs, cpu, report, nits=8, check_nits=5)
    assert cs.run_examples(bt, cpu, report)
    out = capsys.readouterr().out
    assert "line-search steps per step equal at every step: True" in out
    assert "[examples] gridded_refined:" in out
    (_, _), (got_routes, want_routes) = routes
    assert got_routes == want_routes  # kernel-route count = 2 x evaluations + steps + posteriors
    assert set(report["launches"]) == {"lbfgs", "examples"}
