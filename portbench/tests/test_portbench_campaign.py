"""The native-monthly dedup campaign's cell (``monthly-campaign.fast-monthly``)
on the CPU: its generator, its entry against the plain reference in float64
on each linear-algebra route, runs of the cell at a tiny size that come out
correct when sound and not correct with a fault planted, and the readers of
its fit's routes.

    python -m pytest portbench/tests/test_portbench_campaign.py -q
"""

from __future__ import annotations

import copy
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import faults, fit_loops, run, work  # noqa: E402
from portbench.entries import dedup_campaign as entry  # noqa: E402
from portbench.generators import monthly  # noqa: E402
from portbench.traffic import generate  # noqa: E402

torch.set_num_threads(1)

CELL = "monthly-campaign.fast-monthly"
# Float64 round-off carried through a fit, as in test_portbench_reference.py:
# the port and the reference order their sums differently (the library and
# blocked routes factorise in other orders again), and the optimiser passes
# the difference on.
F64_TOL = 1e-8
# Seven scenarios, so that a check ranked over scenarios has its rows, and
# two historical chunks (5 models in chunks of 3, the last padded).
RUN_SHAPE = dict(scenarios=7, hist_models=5, ssp_models=[4, 3, 3, 2, 2, 2, 2], models=4,
                 realisations=4, min_realisations=3, t_hist=26, t_ssp=14, obs_members=6,
                 hist_chunk=3)
RUN_PROFILE = dict(n_optim_nits=60, time_stride=3, fine_steps=20, dba_iterations=3)
SEED = 2 ** 31 + 101


def cell_at(shape, profile, pool=None):
    cell = copy.deepcopy(run.Cell.named(CELL))
    cell.config["shape"].update(shape)
    cell.traffic[cell.config["entry"]].update(profile)
    if pool is not None:
        cell.workload["pool"] = pool
    return cell


def inputs64(config, seed):
    return {k: a.astype(np.float64) if a.dtype != bool else a
            for k, a in generate.pool(config, seed, 1)[0].items()}


def port_and_reference(cell, seed):
    import bayesian_ensembling_tpu_torch as bt

    x = inputs64(cell.config, seed)
    got = run._host(entry.step(bt, entry.tensors(x, torch.float64, torch.device("cpu")),
                               cell.config, cell.profile))
    want = entry.reference(x, cell.config, cell.profile, torch.device("cpu"), torch.float64)
    return got, want


def test_the_generator_is_chip_smoke_s_synthetic_monthly():
    """At the cell's own shape and data, the draws of ``chip_smoke``'s
    generator from the same seed, laid out as the entry reads them."""
    import chip_smoke

    config = run.Cell.named(CELL).config
    x = monthly.make(config["shape"], config["data"], np.random.default_rng(11))
    scenarios, obs = chip_smoke.synthetic_monthly(11)
    np.testing.assert_array_equal(x["obs"], obs)
    rows = []
    for si, (_, hist, ssp) in enumerate(scenarios):
        listed = [int(name[len("model"):]) for name in hist.model_names]
        assert listed == np.nonzero(x["members"][si])[0].tolist()
        for k, h, s in zip(listed, hist.blocks, ssp.blocks):
            n = h.shape[0]
            assert x["hist_mask"][k].sum() == n and not x["hist"][k, n:].any()
            np.testing.assert_array_equal(x["hist"][k, :n], h)
            rows.append(s)
    assert x["ssp"].shape == (65, 29, 1032)
    for want, got in zip(rows, x["ssp"]):
        np.testing.assert_array_equal(got[:want.shape[0]], want)
        assert not got[want.shape[0]:].any()


def test_the_pool_keeps_the_membership_through_both_casts():
    """``generate.pool`` rounds the floats to float32 and the reference reads
    float64: the boolean maps survive both, and each historical block packs
    as one row however many scenarios list it."""
    config = run.Cell.named(CELL).config
    shape = dict(config["shape"], **entry.TINY)
    x32 = generate.pool(dict(config, shape=shape), 5, 1)[0]
    assert x32["members"].dtype == bool and x32["hist_mask"].dtype == bool
    assert x32["hist"].dtype == np.float32
    pack32, _ = entry.tensors(x32, torch.float32, torch.device("cpu"))
    pack64, _ = entry.tensors({k: a.astype(np.float64) if a.dtype != bool else a
                               for k, a in x32.items()}, torch.float64, torch.device("cpu"))
    assert pack32.uh.shape[0] == np.any(x32["members"], axis=0).sum()
    assert pack32.usb.shape[0] == sum(shape["ssp_models"])
    np.testing.assert_array_equal(pack32.uidx, pack64.uidx)
    np.testing.assert_array_equal(pack32.sidx, pack64.sidx)
    np.testing.assert_array_equal(pack32.uh.astype(np.float64), pack64.uh)


@pytest.mark.parametrize("n, t, ties", [(1, 2, False), (7, 13, False), (40, 37, True)])
def test_the_campaign_s_dba_is_the_reference_s_bit_for_bit(n, t, ties, monkeypatch):
    """The campaign's faster walk of the alignment tables gives
    ``reference/dba``'s sums and counts to the bit, ties (values on a grid
    of halves) included, and so its DBA; in blocks of a few pairs too."""
    from portbench.reference import campaign, dba

    g = torch.Generator().manual_seed(n)
    centres, series = (torch.randn(n, t, generator=g, dtype=torch.float64) for _ in range(2))
    if ties:
        centres, series = torch.round(centres * 2) / 2, torch.round(series * 2) / 2
    for got, want in zip(campaign._path_sums(centres, series), dba._path_sums(centres, series)):
        assert torch.equal(got, want)
    monkeypatch.setattr(campaign, "TABLE_BYTES", 3 * (t + 1) ** 2 * 8)
    block = torch.randn(4, 5, t, generator=g, dtype=torch.float64)
    mask = torch.arange(5)[None, :] < torch.tensor([[1], [5], [3], [2]])
    block = torch.where(mask[:, :, None], block, 0.0)
    assert torch.equal(campaign._dba(block, mask, 3), dba.dba(block, mask, 3))


def test_the_collections_are_the_batches_the_step_runs():
    cell = run.Cell.named(CELL)
    assert [tuple(c) for c in work.collections(cell.config)] == [(28, 1980, 29), (65, 1032, 29)]
    assert work.step_ops(cell.config, cell.profile) > 1e13


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
@pytest.mark.parametrize("stride", [1, 3], ids=["scratch", "coarse_to_fine"])
def test_reference_matches_the_port_in_float64(stride, seed):
    cell = cell_at(entry.TINY, dict(n_optim_nits=40, time_stride=stride, fine_steps=10))
    if stride == 1:  # a scratch fit takes no fine steps
        del cell.traffic[cell.config["entry"]]["fine_steps"]
    got, want = port_and_reference(cell, seed)
    for g, w, shape in zip(got, want, [(2, 14), (2, 14), (2, 3)]):
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL)


@pytest.mark.filterwarnings("ignore:batched linalg")
def test_reference_matches_the_port_on_the_library_and_blocked_routes(monkeypatch):
    """Past the kernels' cap (168 in float64, 239 in float32): the historical
    chunk of 16 takes ``torch.linalg``, the 64 SSP runs the recursive blocked
    NLML (float64 let onto it here; on the card it is float32's)."""
    from bayesian_ensembling_tpu_torch.ops import linalg_cuda

    monkeypatch.setattr(linalg_cuda, "BLOCKED_DTYPES", (torch.float32, torch.float64))
    seen = []
    real = linalg_cuda.linalg_path

    def spy(t, b=None, dtype=torch.float32):
        seen.append((t, b, real(t, b=b, dtype=dtype)))
        return seen[-1][-1]

    monkeypatch.setattr(linalg_cuda, "linalg_path", spy)
    shape = dict(scenarios=4, hist_models=16, ssp_models=[16] * 4, models=16, realisations=3,
                 min_realisations=3, t_hist=245, t_ssp=241, obs_members=4, hist_chunk=16)
    cell = cell_at(shape, dict(n_optim_nits=4, time_stride=12, fine_steps=2, dba_iterations=1))
    got, want = port_and_reference(cell, 3)
    fits = [s for s in seen if s[1] is not None]
    assert fits == [(21, 16, "kernel"), (245, 16, "library"), (21, 64, "kernel"),
                    (241, 64, "blocked")]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL)


def run_tiny(cell):
    result, _ = run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"))
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    return result


def tiny_run_cell():
    return cell_at(RUN_SHAPE, RUN_PROFILE, pool=1)


def test_a_sound_run_is_correct():
    result = run_tiny(tiny_run_cell())
    assert result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged_fit", "half_first_batch_unfitted",
                                   "half_last_batch_unfitted"])
def test_a_fit_fault_is_not_correct(fault):
    cell = tiny_run_cell()
    with faults.planted(fault, cell.config):
        assert not run_tiny(cell)["correct"]


def test_half_of_the_models_left_out_is_not_correct():
    """Planted where the campaign calls its tail, ``campaign.multi_scenario_tail``
    (the entry's ``TAIL_SITE``): ``model_masks`` (S, M), the eighth argument,
    keeps its first half of the models."""
    from bayesian_ensembling_tpu_torch.parallel import campaign

    cell = tiny_run_cell()
    assert faults.site(cell.config, "tail") == (campaign, "multi_scenario_tail")
    with faults.planted("half_models_left_out", cell.config):
        assert not run_tiny(cell)["correct"]


@pytest.mark.parametrize("number", sorted(run.Cell.named(CELL).workload["checks"]))
def test_one_answer_altered_where_it_is_produced_is_not_correct(number):
    """The output a number compares, altered by twice its limit where the
    campaign's tail produces it: at one point for a widest gap, everywhere
    for the other statistics."""
    cell = tiny_run_cell()
    spec = cell.workload["checks"][number]
    with faults.answer_altered(cell.config, spec["output"], 2.0 * spec["limit"],
                               everywhere=spec["statistic"] != "max"):
        result = run_tiny(cell)
    assert not result["correct"]
    assert result["checks"][number]["value"] > spec["limit"]


def loop(id_, root, device_ms, **attrs):
    return types.SimpleNamespace(name="fit.loop", id=id_, root=root, device_ms=device_ms,
                                 attrs=dict(attrs))


def campaign_spans(with_route=True):
    """One campaign's spans: a historical chunk and the SSP batch, each a
    coarse and a fine loop; then a second step (another root) not counted."""
    def route(r):
        return {"route": r} if with_route else {}

    step = types.SimpleNamespace(name="step", id=1, root=1, device_ms=5000.0, attrs={})
    return [step,
            loop(2, 1, 150.0, B=28, T=165, **route("kernel")),
            loop(3, 1, 3500.0, B=28, T=1980, **route("library")),
            loop(4, 1, 140.0, B=65, T=86, **route("kernel")),
            loop(5, 1, 1200.0, B=65, T=1032, **route("blocked")),
            types.SimpleNamespace(name="step", id=6, root=6, device_ms=1.0, attrs={}),
            loop(7, 6, 999.0, B=28, T=1980, **route("library"))]


def reader_ctx(spans):
    return run.Context(cell=run.Cell.named(CELL), setup_s=20.0, step_s=5.0,
                       peak_window_bytes=2 ** 33, program_spans=spans)


def test_the_route_readers_split_the_loops_of_the_step():
    ctx = reader_ctx(campaign_spans())
    assert fit_loops.route_ms(ctx, "library") == pytest.approx(3500.0)
    assert run.read_metric("fit.blocked_ms", ctx) == pytest.approx(1200.0)
    kernel_only = [s for s in campaign_spans() if s.attrs.get("route") in (None, "kernel")]
    assert run.read_metric("fit.blocked_ms", reader_ctx(kernel_only)) == 0.0


def test_the_fine_roofline_is_the_full_t_work_over_the_full_t_loops():
    cell = run.Cell.named(CELL)
    ops = 100 * (work.value_and_grad_ops(28, 1980) + work.value_and_grad_ops(65, 1032))
    want = 100.0 * ops / work.FP32_FLOPS / 4.7  # a float32 cell
    got = run.read_metric("fit.fine_roofline", reader_ctx(campaign_spans()))
    assert cell.profile["fine_steps"] == 100 and got == pytest.approx(want)
    assert 0.0 < got < 100.0
    unrouted = run.read_metric("fit.fine_roofline", reader_ctx(campaign_spans(with_route=False)))
    assert unrouted == pytest.approx(want)  # it reads T, not the route


@pytest.mark.parametrize("metric", ["fit.blocked_ms", "fit.fine_roofline"])
def test_the_route_readers_find_nothing_where_there_is_nothing_to_read(metric):
    no_root = [s for s in campaign_spans() if s.name != "step"]
    on_cpu = [types.SimpleNamespace(**dict(vars(s), device_ms=None)) for s in campaign_spans()]
    for spans in (None, [], no_root, on_cpu):
        assert run.read_metric(metric, reader_ctx(spans)) is None
    if metric != "fit.fine_roofline":  # a program whose loops carry no route
        assert run.read_metric(metric, reader_ctx(campaign_spans(with_route=False))) is None


@pytest.mark.parametrize("own_step", [True, False], ids=["campaign_step", "no_campaign_step"])
def test_the_entry_s_step_is_the_root_of_every_span_it_reads(own_step, monkeypatch):
    """The entry's ``step`` span roots the campaign's spans, so ``span.*``
    and the route readers find them also with a campaign that opens no
    ``step`` span of its own (planted by dropping it)."""
    import contextlib

    import bayesian_ensembling_tpu_torch as bt
    from bayesian_ensembling_tpu_torch.parallel import campaign
    from bayesian_ensembling_tpu_torch.utils import profiling

    if not own_step:
        real = campaign.span
        monkeypatch.setattr(campaign, "span", lambda name, *a, **k: (
            contextlib.nullcontext() if name == "step" else real(name, *a, **k)))
    cell = cell_at(entry.TINY, dict(n_optim_nits=6, time_stride=3, fine_steps=2,
                                    dba_iterations=2))
    x = inputs64(cell.config, SEED)
    t = entry.tensors(x, torch.float64, torch.device("cpu"))
    with profiling.recording() as rec:
        entry.step(bt, t, cell.config, cell.profile)
    names = [s.name for s in rec.spans]
    root = rec.spans[0]
    assert root.name == "step" and root.parent is None
    assert names.count("step") == (2 if own_step else 1)
    assert {s.root for s in rec.spans} == {root.id}
    chunks = -(-cell.config["shape"]["hist_models"] // cell.config["shape"]["hist_chunk"])
    for name, count in (("dba", chunks + 1), ("fit", chunks + 1), ("posterior", chunks + 1),
                        ("tail", 1)):
        assert names.count(name) == count, (name, names)
