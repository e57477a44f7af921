"""fit.fine_roofline: the least time of the fit's work at full T over the card
time of the optimiser loops at full T, in percent.  The least time is, for
each batch a step emulates (``work.collections``), the full-T steps of the
profile (``fine_steps`` after a coarse pass, else ``n_optim_nits``) times
the operations of one NLML evaluation (``work.value_and_grad_ops``, and
``value_ops`` for an optimiser that also takes a value alone) over the
card's peak in the configuration's dtype; the card time is the CUDA-event
time of the ``fit.loop`` spans of one step run with the port's tracer on
whose ``T`` is a batch's full T (``portbench/fit_loops.py``).  It reads the
same whatever route or leaf size the loops take.  Nothing to read for an
entry that counts its own operations: its fit is not the exact GP's."""

from portbench import fit_loops, work


def read(ctx):
    found = fit_loops.loops(ctx)
    config, profile = ctx.cell.config, ctx.cell.profile
    if found is None or work.counts_its_own(config):
        return None
    batches = work.collections(config)
    steps = profile["fine_steps"] if profile.get("time_stride", 1) > 1 else profile["n_optim_nits"]
    vg, v = work.optimiser_evaluations(profile)
    ops = sum(steps * (vg * work.value_and_grad_ops(b, t) + v * work.value_ops(b, t))
              for b, t, _ in batches)
    full = {t for _, t, _ in batches}
    ms = sum(s.device_ms for s in found if fit_loops.attrs(s).get("T") in full)
    if ms <= 0.0:
        return None
    return 100.0 * ops / work.peak_flops(config) / (ms * 1e-3)
