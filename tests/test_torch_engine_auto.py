"""`config.engine="auto"` in the port, against the JAX package's
`engine/auto.py`: the same byte estimate, the same decision, the H100's
memory as the default, and `train_loop` on both sides of the threshold."""
import numpy as np
import pytest

from paths_tpu.engine import auto as jauto
from test_torch_train import configs, store  # noqa: F401

from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.engine import auto as tauto
from paths_tpu_torch.train import loop as tloop


def _pads(num_levels, n0=96, rows=64, hw=(8, 8)):
    return {"n0": n0, "rows": [0] + [rows] * (num_levels - 1),
            "grid_hw": [(0, 0)] + [hw] * (num_levels - 1)}


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n0,rows,hw,bs", [
    (96, 64, (8, 8), 4), (4096, 4096, (70, 93), 32), (17, 3, (1, 2), 1)])
def test_estimate_equals_jax(table_dtype, n0, rows, hw, bs):
    jcfg, tcfg = configs("/nonexistent", table_dtype=table_dtype,
                         top_k_patches=[20, 7])
    pads = _pads(tcfg.num_levels, n0, rows, hw)
    want = jauto.estimate_fused_batch_bytes(jcfg, pads, bs)
    assert tauto.estimate_fused_batch_bytes(tcfg, pads, bs) == want > 0


def test_resolve_engine_matches_jax(capsys):
    """Pass-through for fused and streaming; "auto" is fused below the
    budget line and streaming above it, as in JAX, and streaming without
    pads; the decision is printed with the numbers it was made from."""
    jcfg, tcfg = configs("/nonexistent")
    pads = _pads(tcfg.num_levels)
    for engine in ("fused", "streaming"):
        jcfg.engine = tcfg.engine = engine
        assert tauto.resolve_engine(tcfg, pads, 4, hbm=1) == engine
    jcfg.engine = tcfg.engine = "auto"
    need = tauto.RESIDENCY_FACTOR * tauto.estimate_fused_batch_bytes(tcfg,
                                                                     pads, 4)
    edge = int((need + tauto.PARAM_RESERVE) / tauto.HBM_FRACTION)
    for hbm in (1 << 40, edge + 1024, edge - 1024, 0):
        got = tauto.resolve_engine(tcfg, pads, 4, hbm=hbm)
        assert got == jauto.resolve_engine(jcfg, pads, 4, hbm=hbm)
        assert got == ("fused" if hbm > edge else "streaming")
        assert f"-> {got}" in capsys.readouterr().out
    assert tauto.resolve_engine(tcfg, None, 4) == "streaming"
    assert "no shape bounds" in capsys.readouterr().out


def test_hbm_bytes_on_the_cpu_is_an_h100s():
    assert tauto.hbm_bytes("cpu") == tauto.DEFAULT_HBM == 80 << 30
    assert tauto.DEFAULT_HBM != jauto.DEFAULT_HBM


@pytest.mark.parametrize("hbm,expect", [(1 << 40, "fused"), (1, "streaming")])
def test_train_loop_auto_both_sides(tmp_path, monkeypatch, capsys, store, hbm,
                                    expect):
    """engine="auto" trains end to end on both sides of the threshold, with
    the device's memory pinned; the decision is printed and the run takes
    the engine it names."""
    monkeypatch.setattr(tauto, "hbm_bytes", lambda device="cuda": hbm)
    calls = []
    real = tloop.StreamingEngine.loss_and_grad

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tloop.StreamingEngine, "loss_and_grad", spy)
    tmp, _, _ = store
    _, tcfg = configs(tmp, engine="auto", num_epochs=1)
    splits = tdata.load_splits([0.5, 0.25, 0.25], 0, tcfg)
    stats = tloop.train_loop(tcfg, str(tmp_path / "m"), *splits, device="cpu")
    assert np.isfinite(stats["train_loss"][1])
    out = capsys.readouterr().out
    assert f"-> {expect}" in out and f"engine {expect}" in out
    assert bool(calls) == (expect == "streaming")
