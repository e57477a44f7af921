"""The port's span tracer (``utils/profiling.py``) and its optimiser-step
counter (``ops/gp.FIT_STEPS``), on the CPU at tiny shapes.

The tracer is off by default; on, it records each layer of a step where the
work is issued (``step`` -> per collection ``dba``, ``fit`` -> ``fit.loop``,
``posterior`` -> ``tail``) without changing a bit of the answers, and under
``torch.profiler`` each span is a ``bet.*`` range nested as the spans are.
Each ``fit.loop`` carries the linear-algebra route its step takes.
"""

import numpy as np
import pytest
import torch

import bayesian_ensembling_tpu_torch as bt
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.utils import profiling

torch.set_num_threads(1)

NITS = 5


def _blocks(rng, lead, r, t):
    """Trend plus noise, ragged realisation counts zero padded."""
    block = np.linspace(0.0, 1.0, t) + 0.1 * rng.normal(size=lead + (r, t))
    counts = rng.integers(1, r + 1, size=lead)
    counts.reshape(-1)[0] = r
    mask = np.arange(r) < counts[..., None]
    block[~mask] = 0.0
    return torch.from_numpy(block), torch.from_numpy(mask)


def _multi_scenario(**fit):
    rng = np.random.default_rng(3)
    s, m, r = 2, 3, 4
    hb, hm = _blocks(rng, (s, m), r, 16)
    sb, _ = _blocks(rng, (s, m), r, 10)
    obs = torch.from_numpy(np.linspace(0.0, 1.0, 16) + 0.1 * rng.normal(size=(5, 16)))
    mm = torch.ones((s, m), dtype=torch.float64)
    kw = dict(dict(n_optim_nits=NITS, dba_iterations=2), **fit)
    return lambda: bt.ensemble_multi_scenario_step(hb, hm, sb, hm.clone(), obs, mm, **kw)


def _gridded(**fit):
    rng = np.random.default_rng(4)
    m, c, r, t = 3, 4, 3, 12
    block, mask = _blocks(rng, (m, c), r, t)
    obs = torch.from_numpy(np.linspace(0.0, 1.0, t) + 0.1 * rng.normal(size=(c, 5, t)))
    kw = dict(dict(n_optim_nits=NITS, dba_iterations=2, optimizer="bfgs"), **fit)
    return lambda: bt.gridded_ensemble_step(block, obs, mask, None, **kw)


class _Collection:
    """What ``pack_dedup_campaign`` reads of a collection."""

    def __init__(self, names, block, mask):
        self.model_names, self.block, self.mask = names, block, mask

    def __len__(self):
        return len(self.model_names)

    @property
    def max_realisations(self):
        return self.block.shape[1]

    def padded_stack(self, r_target=None):
        return self.block, self.mask


def _dedup_campaign(**fit):
    """Three historical models, two of them listed by both scenarios, fitted
    in two chunks of two; five SSP runs in one batch."""
    rng = np.random.default_rng(6)
    u, r = 3, 4
    hb, hm = (a.numpy() for a in _blocks(rng, (u,), r, 16))
    sb, _ = _blocks(rng, (5,), r, 10)
    names = [f"m{k}" for k in range(u)]
    scenarios, row = [], 0
    for si, listed in enumerate(([0, 1, 2], [1, 2])):
        ssp = np.where(hm[listed][:, :, None], sb[row:row + len(listed)].numpy(), 0.0)
        row += len(listed)
        scenarios.append((f"s{si}", _Collection([names[k] for k in listed], hb[listed], hm[listed]),
                          _Collection([names[k] for k in listed], ssp, hm[listed])))
    pack = bt.pack_dedup_campaign(scenarios)
    obs = np.linspace(0.0, 1.0, 16) + 0.1 * rng.normal(size=(5, 16))
    kw = dict(dict(n_optim_nits=NITS, dba_iterations=2), **fit)
    return lambda: bt.run_dedup_campaign(pack, obs, hist_chunk=2, device="cpu",
                                         dtype=torch.float64, **kw)


STEPS = {"multi_scenario": _multi_scenario, "gridded": _gridded,
         "dedup_campaign": _dedup_campaign}
# The spans of one step in the order they begin, with their depth below it.
_COLLECTION = [("dba", 1), ("fit", 1), ("fit.loop", 2), ("posterior", 1)]
TREES = {
    "multi_scenario": [("step", 0)] + _COLLECTION * 2 + [("tail", 1)],
    "gridded": [("step", 0)] + _COLLECTION + [("tail", 1)],
    # two historical chunks, then the SSP batch
    "dedup_campaign": [("step", 0)] + _COLLECTION * 3 + [("tail", 1)],
}


def test_the_tracer_is_off_by_default_and_a_step_records_nothing():
    assert profiling._active is None
    null = profiling.span("step")
    assert profiling.span("fit", torch.zeros(2), B=2) is null  # one shared no-op context
    STEPS["multi_scenario"]()()
    assert profiling._active is None
    with profiling.recording() as rec:
        pass
    assert rec.spans == []


@pytest.mark.parametrize("entry", sorted(STEPS))
def test_a_traced_step_equals_the_untraced_step_bit_for_bit(entry):
    step = STEPS[entry]()
    off = step()
    with profiling.recording() as rec:
        on = step()
    assert rec.spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", sorted(STEPS))
def test_the_spans_form_the_step_tree(entry):
    with profiling.recording() as rec:
        STEPS[entry]()()
    spans = rec.spans
    by_id = {s.id: s for s in spans}

    def depth(s):
        return 0 if s.parent is None else 1 + depth(by_id[s.parent])

    assert [(s.name, depth(s)) for s in spans] == TREES[entry]
    assert {s.root for s in spans} == {spans[0].id}
    for s in spans:
        assert s.host_end_ns >= s.host_start_ns and s.device_ms is None  # the CPU has no events
        assert s.attrs["B"] > 0 and s.attrs["T"] > 0 and s.attrs["dtype"] == "float64"
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.host_start_ns <= s.host_start_ns and s.host_end_ns <= up.host_end_ns
    for s in spans:
        if s.name.startswith("fit"):
            assert s.attrs["steps"] == NITS and s.attrs["optimizer"] in ("adam", "bfgs")


def test_recording_blocks_do_not_nest():
    with profiling.recording():
        with pytest.raises(RuntimeError, match="do not nest"):
            with profiling.recording():
                pass
    assert profiling._active is None


def _fit_inputs():
    rng = np.random.default_rng(5)
    block, mask = _blocks(rng, (4,), 3, 24)
    return gp_ops.prepare_gp_inputs(block, mask, dba_iterations=2)


@pytest.mark.parametrize("route, kw, want, loops", [
    ("merged", dict(n_optim_nits=7), {"adam": 7}, 1),
    ("chunked", dict(n_optim_nits=7, chunk_steps=3), {"adam": 7}, 3),
    ("warm_time", dict(n_optim_nits=6, time_stride=4, fine_steps=2, optimizer="bfgs"),
     {"bfgs": 8}, 2),
    ("lbfgs", dict(n_optim_nits=3, optimizer="lbfgs"), {"lbfgs": 3}, 1),
])
def test_fit_step_counts_count_the_optimiser_steps_of_every_route(route, kw, want, loops):
    x, y, noise = _fit_inputs()
    bt.reset_launch_counts()
    with profiling.recording() as rec:
        gp_ops.fit_gp_batch_dispatch(x, y, noise, **kw)
    assert bt.fit_step_counts() == dict({"adam": 0, "bfgs": 0, "lbfgs": 0}, **want)
    fit, *inner = rec.spans
    assert fit.name == "fit" and fit.attrs["steps"] == sum(want.values())
    assert [s.name for s in inner] == ["fit.loop"] * loops
    assert sum(s.attrs["steps"] for s in inner) == sum(want.values())
    assert all(s.parent == fit.id for s in inner)
    bt.reset_launch_counts()
    assert bt.fit_step_counts() == {"adam": 0, "bfgs": 0, "lbfgs": 0}


def test_the_campaign_step_counts_its_unique_fits_and_chunks():
    with profiling.recording() as rec:
        STEPS["dedup_campaign"]()()
    step = rec.spans[0]
    assert step.name == "step" and step.parent is None
    assert {k: step.attrs[k] for k in ("B", "T", "T_ssp", "chunks")} == dict(
        B=3 + 5, T=16, T_ssp=10, chunks=2)
    assert [s.attrs["B"] for s in rec.spans if s.name == "fit"] == [2, 2, 5]


@pytest.mark.filterwarnings("ignore:batched linalg")
@pytest.mark.parametrize("dtype, b, t, fine", [
    (torch.float64, 4, 48, "kernel"),
    (torch.float64, 4, 170, "library"),  # past float64's kernel cap of 168
    (torch.float32, 64, 241, "blocked"),  # float32, B >= 28, 239 < T <= 3012
    (torch.float32, 28, 241, "blocked"),  # BLOCKED_MIN_BATCH: the monthly historical chunk's batch
])
def test_every_fit_loop_carries_the_route_its_step_takes(dtype, b, t, fine):
    """A coarse-to-fine fit: the coarse loop (T / 12) on the kernels, the
    fine loop on ``fine``; each loop's ``route`` is ``linalg_path``'s at its
    batch, length and dtype, and the routed calls counted are those routes'."""
    from bayesian_ensembling_tpu_torch.ops import linalg_cuda

    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(b, t, 3)), dtype=dtype)
    y = torch.as_tensor(np.sin(np.linspace(0.0, 3.0, t)) + 0.1 * rng.normal(size=(b, t)),
                        dtype=dtype)
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, size=(b, t)), dtype=dtype)
    bt.reset_launch_counts()
    with profiling.recording() as rec:
        gp_ops.fit_gp_batch_dispatch(x, y, noise, n_optim_nits=2, time_stride=12, fine_steps=2)
    loops = [s for s in rec.spans if s.name == "fit.loop"]
    assert [s.attrs["T"] for s in loops] == [-(-t // 12), t]
    for s in loops:
        assert s.attrs["route"] == linalg_cuda.linalg_path(s.attrs["T"], b=s.attrs["B"],
                                                           dtype=dtype)
    assert [s.attrs["route"] for s in loops] == ["kernel", fine]
    assert {k for k, v in bt.route_counts().items() if v} == {"kernel", fine}
    bt.reset_launch_counts()


def test_a_step_counts_n_optim_nits_per_collection():
    bt.reset_launch_counts()
    STEPS["multi_scenario"]()()
    assert bt.fit_step_counts() == {"adam": 2 * NITS, "bfgs": 0, "lbfgs": 0}
    bt.reset_launch_counts()
    STEPS["multi_scenario"](optimizer="bfgs", time_stride=4, fine_steps=2)()
    assert bt.fit_step_counts() == {"adam": 0, "bfgs": 2 * (NITS + 2), "lbfgs": 0}
    bt.reset_launch_counts()


def test_the_spans_are_nested_ranges_under_the_profiler():
    step = STEPS["gridded"]()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording():
            step()
    ranges = [e for e in prof.events() if e.name.startswith("bet.")]
    assert [e.name for e in sorted(ranges, key=lambda e: e.time_range.start)] == [
        "bet." + name for name, _ in TREES["gridded"]]

    def enclosing(e):
        up = e.cpu_parent
        while up is not None and not up.name.startswith("bet."):
            up = up.cpu_parent
        return None if up is None else up.name

    parents = {e.name: enclosing(e) for e in ranges}
    assert parents == {"bet.step": None, "bet.dba": "bet.step", "bet.fit": "bet.step",
                       "bet.fit.loop": "bet.fit", "bet.posterior": "bet.step",
                       "bet.tail": "bet.step"}
