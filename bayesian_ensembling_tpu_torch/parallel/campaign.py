"""Deduplicated multi-scenario campaign: pack once, fit each unique model once.

PyTorch counterpart of ``bayesian_ensembling_tpu/parallel/campaign.py``,
single-device form.  The 7-SSP experiment's padded ``(S, M)`` scenario
layout would re-fit every (scenario, model) slot, but a historical model's
anomaly series is byte-identical across every SSP collection it appears in:
the native-monthly campaign holds only about 20 distinct historical and 65
distinct SSP fits.  :func:`pack_dedup_campaign` finds them (numpy only), and
:func:`run_dedup_campaign` emulates each once (the historical fits at
T = 1980 in host-level chunks, to bound device memory), gathers the
marginals back into the ``(S, M)`` layout and runs the weighting and
barycentre tail.  :func:`make_sharded_dedup_campaign` is its form on a
device mesh: the unique fits sharded over a mesh axis with no collective,
their marginals gathered back, and the tail run on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import resolve_device
from bayesian_ensembling_tpu_torch.parallel.mesh import (
    _tensor_on,
    all_gather,
    mesh_device,
    shard_map,
)
from bayesian_ensembling_tpu_torch.parallel.step import (
    _check_step_options,
    chunked_marginals,
    emulate_marginals,
    multi_scenario_tail,
    pad_models,
)
from bayesian_ensembling_tpu_torch.utils.profiling import span

__all__ = [
    "DedupCampaign",
    "make_sharded_dedup_campaign",
    "pack_dedup_campaign",
    "pad_unique_axis",
    "run_dedup_campaign",
]


@dataclasses.dataclass
class DedupCampaign:
    """Packing of a multi-scenario campaign, as numpy arrays.

    Scenario layout (for the tail): ``hb/hm`` (S, M, R, T_hist)/(S, M, R)
    zero-padded historical blocks and masks, ``sb/sm`` their SSP twins,
    ``mmask`` (S, M) zeroing padded model slots.

    Unique-fit layout (for the emulation): ``uh/um`` (U, R, T_hist), one
    row per distinct historical model; ``usb/usm`` (B_ssp, R, T_ssp), one
    row per real (scenario, model) SSP pair; and the gather maps
    ``uidx/sidx`` (S, M) from scenario slots into the unique axes.
    """

    hb: np.ndarray
    hm: np.ndarray
    sb: np.ndarray
    sm: np.ndarray
    mmask: np.ndarray
    uh: np.ndarray
    um: np.ndarray
    usb: np.ndarray
    usm: np.ndarray
    uidx: np.ndarray
    sidx: np.ndarray
    names: tp.Tuple[str, ...]

    @property
    def n_fits(self) -> int:
        return self.uh.shape[0] + self.usb.shape[0]


def pack_dedup_campaign(scenarios) -> DedupCampaign:
    """Pack ``[(name, hist_collection, ssp_collection), ...]``.

    A collection is anything with ``len()``, ``model_names``,
    ``max_realisations`` and ``padded_stack(r_target=...) -> (block, mask)``
    (the JAX package's ``ModelCollection`` has them).  Historical rows are
    deduplicated by model name; their anomalies and realisation masks must
    be byte-identical across scenarios, and a mismatch raises.
    """
    m_max = max(len(h) for _, h, _ in scenarios)
    r_max = max(max(h.max_realisations, s.max_realisations) for _, h, s in scenarios)
    s = len(scenarios)
    packed, prepad = [], []
    for _, hist, ssp_mc in scenarios:
        hb_, hm_ = hist.padded_stack(r_target=r_max)
        sb_, sm_ = ssp_mc.padded_stack(r_target=r_max)
        prepad.append((hb_, hm_, sb_, sm_))
        hb_, hm_, mmask_ = pad_models(hb_, hm_, m_max)
        sb_, sm_, _ = pad_models(sb_, sm_, m_max)
        packed.append((hb_, hm_, sb_, sm_, mmask_))
    hb, hm, sb, sm, mmask = (np.stack([p[i] for p in packed]) for i in range(5))

    uniq: dict = {}
    uidx = np.zeros((s, m_max), np.int64)
    sidx = np.zeros((s, m_max), np.int64)
    ssp_rows, ssp_masks = [], []
    for si, (_, hist, _) in enumerate(scenarios):
        hb_, hm_, sb_, sm_ = prepad[si]
        for mi, name in enumerate(hist.model_names):
            if name in uniq:
                k, row, mrow = uniq[name]
                if not (np.array_equal(row, hb_[mi]) and np.array_equal(mrow, hm_[mi])):
                    raise ValueError(
                        f"historical anomalies for {name} differ between scenarios; "
                        "deduplication is invalid"
                    )
            else:
                k = len(uniq)
                uniq[name] = (k, hb_[mi], hm_[mi])
            uidx[si, mi] = k
            sidx[si, mi] = len(ssp_rows)
            ssp_rows.append(sb_[mi])
            ssp_masks.append(sm_[mi])
        # Padded model slots keep index 0; mmask zeroes them in the tail.
    return DedupCampaign(
        hb=hb, hm=hm, sb=sb, sm=sm, mmask=mmask,
        uh=np.stack([v[1] for v in uniq.values()]),
        um=np.stack([v[2] for v in uniq.values()]),
        usb=np.stack(ssp_rows),
        usm=np.stack(ssp_masks),
        uidx=uidx, sidx=sidx,
        names=tuple(n for n, _, _ in scenarios),
    )


def pad_unique_axis(block: np.ndarray, mask: np.ndarray, multiple: int):
    """Pad a unique-fit axis to a multiple of ``multiple`` with replicated
    real rows (the gather maps reference only real rows, so replicas never
    reach the tail)."""
    u = block.shape[0]
    target = -(-u // multiple) * multiple
    pad = target - u
    if not pad:
        return block, mask
    reps = -(-pad // u)
    fb = np.concatenate([block] * reps, axis=0)[:pad]
    fm = np.concatenate([mask] * reps, axis=0)[:pad]
    return np.concatenate([block, fb], axis=0), np.concatenate([mask, fm], axis=0)


def run_dedup_campaign(
    pack: DedupCampaign,
    obs,
    *,
    hist_chunk: int = 28,
    weight_kind: str = "crps",
    sigma_mode: str = "w2",
    device: tp.Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
    **fit_kw,
):
    """Single-device dedup campaign: the unique historical fits in chunks of
    ``hist_chunk`` models, the SSP fits in one batch, then the tail.

    Args:
      pack: from :func:`pack_dedup_campaign`.
      obs: ``(R_obs, T_hist)`` observation realisations (numpy or tensor).
      device: where everything runs; the card unless the caller asks for
        ``"cpu"``.  A CUDA device without CUDA raises.
      dtype: working float type of the blocks, the fits and the tail.
      **fit_kw: options of ``parallel.step.emulate_marginals``
        (``n_optim_nits``, ``dba_iterations``, ...).

    Returns:
      ``(bary_mean (S, T_ssp), bary_std (S, T_ssp), weights (S, M))``.

    With the tracer on (``utils.profiling.recording``) the campaign is one
    ``step`` span, the root of its chunks' and the SSP batch's ``dba``,
    ``fit`` and ``posterior`` spans and of its ``tail``; ``B`` counts the
    unique fits, ``T`` is the historical length, ``chunks`` the historical
    chunks.
    """
    _check_step_options(weight_kind, sigma_mode, None)
    device = resolve_device(device, "run_dedup_campaign")

    def tensor(a):
        a = np.asarray(a)
        return torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else dtype, device=device)

    em = functools.partial(emulate_marginals, **fit_kw)
    uh = tensor(pack.uh)
    with span("step", uh, B=pack.n_fits, T=uh.shape[-1], T_ssp=pack.usb.shape[-1],
              chunks=-(-uh.shape[0] // max(hist_chunk, 1))):
        uidx = torch.as_tensor(pack.uidx, device=device)
        sidx = torch.as_tensor(pack.sidx, device=device)
        h_mu_u, h_var_u = chunked_marginals(em, uh, tensor(pack.um), hist_chunk)
        s_mu_f, s_var_f = em(tensor(pack.usb), tensor(pack.usm))
        return multi_scenario_tail(
            h_mu_u[uidx], h_var_u[uidx], s_mu_f[sidx], s_var_f[sidx],
            torch.as_tensor(obs, dtype=dtype, device=device),
            tensor(pack.hb), tensor(pack.hm), tensor(pack.mmask),
            weight_kind=weight_kind, sigma_mode=sigma_mode,
        )


def make_sharded_dedup_campaign(
    mesh,
    model_axis: str = "model",
    *,
    weight_kind: str = "crps",
    sigma_mode: str = "w2",
    hist_chunk: tp.Optional[int] = None,
    **fit_kw,
):
    """The campaign on a device mesh: the unique-fit axes sharded over the
    ``model_axis`` of ``mesh``.

    Returns ``campaign(uh, um, usb, usm, uidx, sidx, obs, hb, hm, mmask) ->
    (bary_mean (S, T_ssp), bary_std, weights (S, M))`` of the global
    arrays of a :class:`DedupCampaign` (every rank passes the same; the
    unique-fit axes ``uh`` / ``usb`` multiples of the axis size, see
    :func:`pad_unique_axis`).  Fits never couple, so each rank emulates its
    ``U/n`` historical and ``B_ssp/n`` SSP rows with no collective; the
    ``(U, T)`` marginals (mean and variance together) are gathered back,
    one ``all_gather`` per collection, and the weighting and barycentre tail
    runs as it does unsharded, on every rank.  The outputs are plain
    tensors, equal on every rank.

    ``hist_chunk`` runs a rank's historical fits in chunks of that many
    models, as :func:`run_dedup_campaign` does, to bound the device memory
    at T = 1980; ``**fit_kw`` are ``parallel.step.emulate_marginals``'s.
    """
    _check_step_options(weight_kind, sigma_mode, None)
    em = functools.partial(emulate_marginals, **fit_kw)

    def emulate(block, mask, chunk):
        mu, var = em(block, mask) if chunk is None else chunked_marginals(em, block, mask, chunk)
        both = all_gather(torch.stack([mu, var]), model_axis, dim=1)
        return both[0], both[1]

    p = (model_axis,)
    pad = {model_axis: "pad_unique_axis"}
    hist = shard_map(functools.partial(emulate, chunk=hist_chunk), mesh, (p, p), ((), ()), pad=pad)
    ssp = shard_map(functools.partial(emulate, chunk=None), mesh, (p, p), ((), ()), pad=pad)

    def campaign(uh, um, usb, usm, uidx, sidx, obs, hb, hm, mmask):
        h_mu_u, h_var_u = hist(uh, um)
        s_mu_f, s_var_f = ssp(usb, usm)
        tensor = functools.partial(_tensor_on, device=mesh_device(mesh))
        uidx, sidx = tensor(uidx), tensor(sidx)
        return multi_scenario_tail(
            h_mu_u[uidx], h_var_u[uidx], s_mu_f[sidx], s_var_f[sidx], tensor(obs), tensor(hb),
            tensor(hm), tensor(mmask), weight_kind=weight_kind, sigma_mode=sigma_mode,
        )

    return campaign
