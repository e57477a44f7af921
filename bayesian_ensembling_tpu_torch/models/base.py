"""Emulator base class.

PyTorch counterpart of ``bayesian_ensembling_tpu/models/base.py``: emulators
implement ``fit_collection`` (batched, the entry point
``ModelCollection.fit`` dispatches to) and get a single-model ``fit`` for
free; optional X/y transform hooks mirror the reference template.
"""

from __future__ import annotations

import abc
import typing as tp

from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior, ProcessModel

__all__ = ["AbstractEmulator"]


class AbstractEmulator(abc.ABC):
    """Template for probabilistic emulators of climate-model output."""

    def __init__(self, name: str = "Model") -> None:
        self.name = name

    @abc.abstractmethod
    def fit_collection(self, collection: ModelCollection, **kwargs) -> tp.List[Posterior]:
        """Fit every member of the collection; return one posterior each."""

    def fit(self, model: ProcessModel, **kwargs) -> Posterior:
        return self.fit_collection(ModelCollection([model]), **kwargs)[0]

    # Transform hooks of the reference template; identity by default.
    def transform_x(self, x, training: bool = True):
        return x

    def transform_y(self, y, training: bool = True):
        return y

    def untransform_outputs(self, mu, sigma2):
        return mu, sigma2
