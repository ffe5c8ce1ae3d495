"""Epoch-level evaluators accumulating per-batch statistics (the port's own
copy of `paths_tpu.train.evaluators`, numpy only).

Covers the reference's evaluator behavior (`eval.py:9-120`): the survival
evaluator turns post-sigmoid hazards into a risk score (negative summed
cumulative survival, `eval.py:59-64`) and reports the censored
concordance index with an all-censored guard (`eval.py:66-77`); the
subtype evaluator reports mean one-vs-rest AUROC. Both emit
`{split}_loss` plus their metric and can fill a per-epoch history dict.

Structure here is a generic column store: each evaluator declares the
per-batch columns it accumulates and a pure function from stacked columns
to metrics — rather than one hand-written list attribute per statistic.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Optional

import numpy as np

from paths_tpu_torch.train.metrics import (
    NoComparablePairs,
    binary_auroc,
    class_probs,
    concordance_index_censored,
    survival_risk,
)


class Evaluator(ABC):
    """Accumulates named per-batch column arrays plus a scalar loss, then
    reduces them to `{split}_*` metrics at epoch end."""

    #: column names collected by register(); defined by subclasses
    COLUMNS: tuple = ()

    def __init__(self, split: str):
        self.split = split
        self._loss_sum = 0.0
        self._loss_n = 0
        self._cols: Dict[str, list] = {c: [] for c in self.COLUMNS}

    def reset(self) -> None:
        self._loss_sum = 0.0
        self._loss_n = 0
        for chunks in self._cols.values():
            chunks.clear()

    def _collect(self, loss, **columns) -> None:
        self._loss_sum += float(loss)
        self._loss_n += 1
        for name, value in columns.items():
            self._cols[name].append(np.asarray(value))

    def _stacked(self, name: str) -> np.ndarray:
        return np.concatenate(self._cols[name])

    @property
    def mean_loss(self) -> float:
        # nan (not 0.0) when no batch was registered: an empty eval pass
        # must be visible, not score as a perfect loss (matches the
        # reference's np.mean([]) -> nan)
        if self._loss_n == 0:
            return float("nan")
        return self._loss_sum / self._loss_n

    @abstractmethod
    def register(self, batch: Dict, pred, loss) -> None: ...

    @abstractmethod
    def _metrics(self) -> Dict[str, float]:
        """Reduce stacked columns to metric values (without the loss)."""

    def calculate(self, train_stats: Optional[dict] = None,
                  epoch: Optional[int] = None) -> Dict:
        out = {f"{self.split}_loss": self.mean_loss}
        out.update({f"{self.split}_{k}": v for k, v in self._metrics().items()})
        self._record_history(out, train_stats, epoch)
        return out

    @staticmethod
    def _record_history(out: Dict, train_stats: Optional[dict],
                        epoch: Optional[int]) -> None:
        """Write metrics into a history dict that pre-declares its keys:
        per-epoch when an epoch index is given, overwrite otherwise."""
        if train_stats is None:
            return
        for key in out.keys() & train_stats.keys():
            if epoch is None:
                train_stats[key] = out[key]
            else:
                train_stats[key][epoch] = out[key]


class SurvivalEvaluator(Evaluator):
    COLUMNS = ("censored", "time", "risk")

    def register(self, batch: Dict, hazards, loss):
        """:param batch: dict with "censored" (1 = censored) and "survival"
        (event/censoring time in months)
        :param hazards: (B, nbins) post-sigmoid hazards"""
        self._collect(loss, censored=batch["censored"],
                      time=batch["survival"],
                      risk=survival_risk(hazards))

    def _metrics(self):
        events = (1 - self._stacked("censored")).astype(bool)
        if events.sum() <= 1:
            # all-censored guard (`eval.py:72-74`)
            return {"c-index": 0.5}
        try:
            ci = concordance_index_censored(
                events, self._stacked("time"), self._stacked("risk"))[0]
        except NoComparablePairs:
            ci = 0.5
        return {"c-index": float(ci)}


class SubtypeClassificationEvaluator(Evaluator):
    COLUMNS = ("prob", "subtype")

    def __init__(self, split: str, nclasses: int):
        super().__init__(split)
        self.nclasses = nclasses

    def register(self, batch: Dict, logits, loss):
        self._collect(loss, prob=class_probs(logits),
                      subtype=batch["subtype"])

    def _metrics(self):
        probs = self._stacked("prob")
        labels = self._stacked("subtype")
        aucs = [binary_auroc(probs[:, i], labels == i)
                for i in range(self.nclasses)]
        return {"AUC": float(np.mean(aucs))}


def make_evaluator(config, split: str) -> Evaluator:
    """Reference `train.py:32-36`."""
    if config.task == "subtype_classification":
        return SubtypeClassificationEvaluator(split, len(config.filter_to_subtypes))
    return SurvivalEvaluator(split)
