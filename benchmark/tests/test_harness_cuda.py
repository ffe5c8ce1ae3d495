"""Card-only: the control of each kind of cell, at a size a test run can
hold, has to read worse than the program by the factor its limits are set
from, and the traced path has to give every per-layer metric.

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests
"""
from __future__ import annotations

import copy

import pytest

from benchmark import control
from benchmark.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return "cuda"


def _uni_on_card():
    cfg, tr = tiny.uni()
    # the fused and int8 kernels at UNI's widths, two blocks
    cfg["model"].update(embed_dim=1024, depth=2, num_heads=16, mlp_ratio=4.0,
                        compute_dtype="bfloat16", block_impl="fused")
    tr["pipeline"]["batch_size"] = 64
    tr["check"]["limits"]["feature_gap"] = 0.01
    return cfg, tr


@pytest.mark.parametrize("cell", ["uni.preprocess", "brca.train", "brca.predict"])
def test_control_reads_worse_than_the_program(cell, card, tmp_path):
    if cell == "uni.preprocess":
        cfg, tr = _uni_on_card()
    else:
        cfg, tr = tiny.brca("train_epochs" if cell == "brca.train"
                            else "requests_distinct", card=True)
    r = control.readings(cell, cfg, tr, seed=2**31 + 7, seconds=0.5,
                         control=True, device=card)
    assert all(v <= r["limits"][k] for k, v in r["program"].items()), r
    # some control reads three times the program or more, and fails a limit
    assert any(max(nums[k] / max(r["program"][k], 1e-12) for k in nums) >= 3.0
               and any(v > r["limits"][k] for k, v in nums.items())
               for nums in r["control"].values()), r


@pytest.mark.parametrize("cell", ["brca.predict", "brca.train"])
def test_traced_run_gives_its_per_layer_metrics(cell, card, tmp_path):
    cfg, tr = tiny.brca("train_epochs" if cell == "brca.train"
                        else "requests_distinct", card=True)
    b = tiny.bench()
    from benchmark import harness
    out = harness.execute(cell, copy.deepcopy(cfg), tr, 5, 0.5, True,
                          harness.metrics_of(b, cell, "end_to_end"),
                          harness.metrics_of(b, cell, "per_layer"),
                          device=card, cache=str(tmp_path))
    assert out["correct"], out["checks"]
    want = {m["name"] for m in harness.metrics_of(b, cell, "per_layer")}
    assert set(out["metrics"]) == want
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
