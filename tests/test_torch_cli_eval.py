"""The port's `cli.evaluate`, `cli.predict` and `cli.train --profile` on the
CPU, against the JAX package's CLIs on one store and one `model.npz`.

Both packages run in f32 on the CPU and differ only in summation order: the
metrics and the CSV values agree to 1e-5, the slide order and the CSV header
exactly. The split options (`test_only`, `combined`) give the JAX package's
slides and labels exactly.
"""
import csv
import glob
import json
import os

import jax
import numpy as np
import pytest

from paths_tpu.cli.evaluate import main as jevaluate
from paths_tpu.cli.predict import main as jpredict
from paths_tpu.data import dataset as jdata
from paths_tpu.models.recursive import recursive_init
from paths_tpu.train import state as jstate
from test_torch_train import _same_splits, configs, store  # noqa: F401

from paths_tpu_torch.cli.evaluate import main as tevaluate
from paths_tpu_torch.cli.predict import main as tpredict
from paths_tpu_torch.cli.train import main as ttrain
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.data.synthetic import make_signal_metadata
from paths_tpu_torch.engine import streaming as tstream

TOL = 1e-5
SUBTYPES = ["IDC", "ILC"]


def _model_dir(tmp_path, store, task="survival", **kw):
    """A model directory (config.json + JAX-written model.npz) over the
    signal store; the subtype task gets its own metadata."""
    tmp, ids, z = store
    if task != "survival":
        kw["csv_path"] = str(tmp_path / "meta_subtype.csv")
        kw["filter_to_subtypes"] = SUBTYPES
        make_signal_metadata(kw["csv_path"], ids, z, seed=2,
                             subtypes=SUBTYPES)
    jcfg, tcfg = configs(tmp, task=task, **kw)
    d = str(tmp_path / f"model_{task}_{jcfg.engine}")
    jcfg.save(d)
    jstate.save_state(d, recursive_init(jax.random.PRNGKey(6), jcfg))
    return d, jcfg, tcfg


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_csv(got, want):
    assert got[0] == want[0]
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for a, b in zip(g[1:], w[1:]):
            try:
                np.testing.assert_allclose(float(a), float(b), atol=TOL)
            except ValueError:
                assert a == b           # the subtype task's argmax class


@pytest.mark.parametrize("task", ["survival", "subtype_classification"])
def test_evaluate_and_predict_match_jax(tmp_path, store, task):
    d, _, _ = _model_dir(tmp_path, store, task)
    for split in ("test", "train"):
        want = jevaluate(["-m", d, "--split", split])
        got = tevaluate(["-m", d, "--split", split, "--device", "cpu"])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    splits = ("test", "all") if task == "survival" else ("test",)
    for split in splits:
        jcsv, tcsv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
        jpredict(["-m", d, "--split", split, "-o", jcsv, "--batch-size", "3"])
        rows = tpredict(["-m", d, "--split", split, "-o", tcsv,
                         "--batch-size", "3", "--device", "cpu"])
        got, want = _read_csv(tcsv), _read_csv(jcsv)
        assert len(rows) == len(got) - 1
        _same_csv(got, want)
    if task == "survival":
        assert len(got) - 1 == 12     # --split all: every slide


def test_split_options_match_jax(tmp_path, store):
    """`test_only` and `combined` against JAX's (`tests/test_splits_extra.py`):
    the same slides in the same order with the same labels."""
    tmp, ids, z = store
    jcfg, tcfg = configs(tmp)
    for kw in (dict(test_only=True), dict(combined=True)):
        j = jdata.load_splits([0.6, 0.2, 0.2], 0, jcfg, preload=False, **kw)
        t = tdata.load_splits([0.6, 0.2, 0.2], 0, tcfg, preload=False, **kw)
        _same_splits([j], [t])
    assert len(t) == 12
    assert len(tdata.load_splits([0.6, 0.2, 0.2], 0, tcfg, preload=False,
                                 test_only=True)) == 3


def test_iterate_batches_matches_jax(store):
    """`iterate_batches` (JAX `tests/test_dataset.py`): the same seeded
    shuffle, the same collated shapes and values, and the labels."""
    tmp, _, _ = store
    jcfg, tcfg = configs(tmp)
    jds = jdata.load_splits([1.0, 0.0, 0.0], 0, jcfg)[0]
    tds = tdata.load_splits([1.0, 0.0, 0.0], 0, tcfg)[0]
    jb = list(jdata.iterate_batches(jds, 5, shuffle=True, seed=5,
                                    level0_bucket=8))
    tb = list(tdata.iterate_batches(tds, 5, shuffle=True, seed=5,
                                    level0_bucket=8, device="cpu"))
    assert [len(b[2]["survival"]) for b in tb] == [5, 5, 2]
    for (jbag, jtables, jlab), (tbag, ttables, tlab) in zip(jb, tb):
        np.testing.assert_array_equal(tbag.fts.numpy(), np.asarray(jbag.fts))
        np.testing.assert_array_equal(tbag.mask.numpy(), np.asarray(jbag.mask))
        for jt, tt in zip(jtables, ttables):
            np.testing.assert_array_equal(tt.fts.numpy(), np.asarray(jt.fts))
            np.testing.assert_array_equal(tt.index.numpy(), np.asarray(jt.index))
        for k in jlab:
            np.testing.assert_array_equal(tlab[k].numpy(), np.asarray(jlab[k]))


def test_evaluate_honours_the_streaming_engine(tmp_path, store, monkeypatch):
    """A streaming model is evaluated through the streaming engine, with the
    fused model's metrics; "auto" prices the split and takes fused here."""
    calls = []
    real = tstream.StreamingEngine.evaluate

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tstream.StreamingEngine, "evaluate", spy)
    out = {}
    for engine in ("fused", "streaming", "auto"):
        d, _, _ = _model_dir(tmp_path, store, engine=engine)
        calls.clear()
        out[engine] = tevaluate(["-m", d, "--device", "cpu"])
        assert bool(calls) == (engine == "streaming")
    for engine in ("streaming", "auto"):
        for k, v in out["fused"].items():
            np.testing.assert_allclose(out[engine][k], v, rtol=1e-6, err_msg=k)


def test_train_profile_writes_a_trace(tmp_path, store):
    d, _, _ = _model_dir(tmp_path, store, num_epochs=1)
    prof = str(tmp_path / "prof")
    stats = ttrain(["-m", d, "--no-wandb", "--device", "cpu",
                    "--profile", prof])
    assert np.isfinite(stats["train_loss"][1])
    assert stats["host_rss_mb"][1] > 0
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)

