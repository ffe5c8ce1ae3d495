"""Each driver at a tiny size on the CPU, through the whole harness (set-up,
window, check, result line) on the plain routes, against its reference;
and each fault the cell can have, planted underneath the timed path, must
make `correct` come out false."""
from __future__ import annotations

import pytest

from benchmark import faults
from benchmark.tests import tiny

CELLS = {
    "uni.preprocess": tiny.uni,
    "brca.train": lambda: tiny.brca("train_epochs"),
    "brca.predict": lambda: tiny.brca("requests_distinct"),
    "brca.predict-cached": lambda: tiny.brca("requests_repeat"),
}
DRIVER = {"uni.preprocess": "preprocess", "brca.train": "train",
          "brca.predict": "predict", "brca.predict-cached": "predict"}
E2E = {"uni.preprocess": "encode_patches_per_s", "brca.train": "train_slides_per_s",
       "brca.predict": "predict_slides_per_s",
       "brca.predict-cached": "predict_slides_per_s"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_is_correct(cell, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, tr = CELLS[cell]()
    out = tiny.run(cell, cfg, tr, cache=str(tmp_path))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {E2E[cell], "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,fault", sorted(
    (c, f) for c in CELLS for (d, f) in faults.FAULTS if d == DRIVER[c]))
def test_fault_makes_run_incorrect(cell, fault, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, tr = CELLS[cell]()
    with faults.planted(tr["driver"], fault):
        out = tiny.run(cell, cfg, tr, cache=str(tmp_path))
    assert not out["correct"], out["checks"]
