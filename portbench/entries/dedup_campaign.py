"""``run_dedup_campaign``: the native-monthly campaign, packed once an input
set (``pack_dedup_campaign``, outside the timed steps), then each unique
historical model fitted once, in chunks of ``hist_chunk``, each listed SSP
run once in one batch, and per scenario the CRPS weights and the W2
barycentre."""

from __future__ import annotations

import numpy as np

from portbench.entries import GP_FIT_SITE, fit_kwargs

OUTPUTS = ("bary_mean", "bary_std", "weights")
TINY = dict(scenarios=2, hist_models=3, ssp_models=[3, 2], models=3, realisations=4,
            min_realisations=3, t_hist=26, t_ssp=14, obs_members=5, hist_chunk=2)
# The fit, and the tail as the campaign binds it by name (faults.py).
FIT_SITE = GP_FIT_SITE
TAIL_SITE = ("bayesian_ensembling_tpu_torch.parallel.campaign", "multi_scenario_tail")


class _Collection:
    """What ``pack_dedup_campaign`` reads of a collection: its length, model
    names, largest realisation count and zero-padded stack."""

    def __init__(self, names, block, mask):
        self.model_names, self.block, self.mask = names, block, mask

    def __len__(self):
        return len(self.model_names)

    @property
    def max_realisations(self):
        return int(self.mask.sum(axis=1).max())

    def padded_stack(self, r_target=None):
        """Blocks and masks cut to ``r_target`` realisations (the inputs are
        zero padded to the configuration's count, at least the campaign's
        largest)."""
        r = self.max_realisations if r_target is None else r_target
        return self.block[:, :r], self.mask[:, :r]


def scenarios(inputs):
    """``[(name, hist_collection, ssp_collection), ...]`` of one input set:
    a model's historical block is row k of ``inputs["hist"]`` in every
    scenario that lists it."""
    hist, mask, members, ssp = (inputs[k] for k in ("hist", "hist_mask", "members", "ssp"))
    out, row = [], 0
    for si, listed in enumerate(members):
        ks = np.nonzero(listed)[0]
        names = [f"model{k:02d}" for k in ks]
        rows = ssp[row:row + len(ks)]
        row += len(ks)
        out.append((f"ssp{si}", _Collection(names, hist[ks], mask[ks]),
                    _Collection(names, rows, mask[ks])))
    return out


def tensors(inputs, dtype, device):
    """``(pack, obs)``: the campaign packed once (numpy, in the inputs'
    dtype) and the observation members on ``device`` in ``dtype``."""
    import torch

    from bayesian_ensembling_tpu_torch.parallel.campaign import pack_dedup_campaign

    return (pack_dedup_campaign(scenarios(inputs)),
            torch.as_tensor(np.asarray(inputs["obs"]), dtype=dtype, device=device))


def step(bt, t, config, profile):
    """One campaign inside a ``step`` span of its own: the root of the spans
    that ``program_spans`` reads, also for a program whose campaign opens
    none (its ``dba``, ``fit``, ``posterior`` and ``tail`` spans come from
    the layers it shares with the other entries).  Where the campaign opens
    its own ``step``, that one nests under this one, on the same root."""
    from bayesian_ensembling_tpu_torch.utils.profiling import span

    pack, obs = t
    with span("step", obs, B=pack.n_fits):
        return bt.run_dedup_campaign(
            pack, obs, hist_chunk=config["shape"]["hist_chunk"],
            weight_kind=config["weight_kind"], sigma_mode=config["sigma_mode"],
            device=obs.device, dtype=obs.dtype, kernel_name=config["kernel"],
            jitter=config["jitter"], dba_iterations=profile["dba_iterations"],
            **fit_kwargs(profile))


def collections(config):
    """Two batches as the step runs them: the unique historical models padded
    to whole chunks of ``hist_chunk`` (a chunk's batch), then every listed SSP
    run."""
    s = config["shape"]
    chunk = s["hist_chunk"]
    return [(chunk * -(-s["hist_models"] // chunk), s["t_hist"], s["realisations"]),
            (sum(s["ssp_models"]), s["t_ssp"], s["realisations"])]


def reference(inputs, config, profile, device, dtype):
    """The plain reference's answers of the same step (``portbench/reference``)."""
    from portbench.reference import campaign

    return campaign.campaign(inputs, config, profile, device, dtype)
