"""The port's streaming engine on the CPU, against the JAX package's
streaming engine and the port's own fused engine.

Inputs come from numpy seeds (the 12-slide signal store of
`test_torch_train.py`) and weights cross over in the JAX package's
`model.npz` layout. Both packages run in f32 on the CPU:

* `lookup_host` is numpy in both, so its outputs are equal element for
  element;
* the streaming loss against JAX's agrees to 1e-6 relative, predictions to
  2e-5 and per-leaf gradients to GRAD_TOL of the largest gradient, the bars
  of `test_torch_train.py::test_end2end_loss_gradients_match_jax`; the
  selections (mask, locs) of every level are equal;
* the port's streaming and fused engines run the same operations on the
  same values (only where the features come from differs), so they agree
  to 1e-6 relative, also in training mode with dropout from one generator;
* whole training runs agree with JAX's to the bars of
  `test_train_loop_matches_jax` (rtol 5e-2 on the loss, 0.1 on the c-index).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from paths_tpu.data import dataset as jdata
from paths_tpu.engine import streaming as jstream
from paths_tpu.engine.tables import build_level_table as j_build_level_table
from paths_tpu.models.recursive import recursive_init
from paths_tpu.train import loop as jloop
from paths_tpu.train import state as jstate
from test_torch_train import GRAD_TOL, _grads_by_key, configs, store  # noqa: F401

from paths_tpu_torch import convert
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.engine import hierarchy as th
from paths_tpu_torch.engine import streaming as tstream
from paths_tpu_torch.engine.tables import build_level_table
from paths_tpu_torch.models.jax_init import fresh_model
from paths_tpu_torch.train import loop as tloop

IDX = [0, 1, 2, 3, 4, 5]


def _jax_dataset(jcfg, ids):
    """A label-free JAX dataset of `ids`."""
    from paths_tpu.data.feature_store import FeatureStore as JStore
    from paths_tpu.serve import serving_dataset

    return serving_dataset(jcfg, JStore(jcfg.preprocess_dir), ids)


def _port_dataset(tcfg, ids):
    from paths_tpu_torch.data.feature_store import FeatureStore

    return tdata.SlideDataset(ids, tcfg, FeatureStore(tcfg.preprocess_dir))


def _labels():
    rng = np.random.default_rng(3)
    labels = {"survival_bin": rng.integers(0, 4, 6).astype(np.int32),
              "censored": np.array([0, 1, 0, 0, 1, 0], np.int32),
              "weight": np.array([1, 1, 1, 1, 1, 0], np.float32)}
    return ({k: jnp.asarray(v) for k, v in labels.items()},
            {k: torch.from_numpy(v) for k, v in labels.items()})


def _host_tables(ds):
    return [[dict(t) for t in ds.slides[i].tables] for i in IDX]


# --------------------------------------------------------------- lookup_host

def test_lookup_host_matches_jax():
    """Random child coordinates over tables with background cells, some out
    of the grid, some of them invalid, and slides whose children are all
    background (the fallback: first the non-background rows, then raw cells
    of an all-background grid)."""
    rng = np.random.default_rng(0)
    d, k = 8, 5
    tables = []
    for j, (h, w) in enumerate([(5, 7), (4, 4), (6, 3), (2, 2)]):
        grid = rng.normal(size=(h, w, d)).astype(np.float32)
        grid[rng.uniform(size=(h, w)) < 0.4] = 0.0
        if j == 3:
            grid[:] = 0.0        # all background
        tables.append(build_level_table(grid, min_rows=4 * k))
        jt = j_build_level_table(grid, min_rows=4 * k)
        for key in tables[-1]:
            np.testing.assert_array_equal(tables[-1][key], jt[key])
    locs = rng.integers(-1, 8, size=(4, 4 * k, 2)).astype(np.int32)
    kvalid = rng.uniform(size=(4, 4 * k)) < 0.7
    kvalid[2] = False            # no valid child: fallback over count rows
    got = tstream.lookup_host(locs, kvalid, tables)
    want = jstream.lookup_host(locs, kvalid, tables)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["use_fallback"].tolist() == [False, False, True, True]
    assert got["mask"][3].sum() == 4       # the 4 raw cells of a 2x2 grid


def test_lookup_host_fallback_all_background():
    """JAX's `test_lookup_host_fallback`: a 2x2 all-background grid and
    out-of-grid children give the 4 raw cells in row-major order."""
    grid = np.zeros((2, 2, 8), np.float32)
    t = build_level_table(grid, min_rows=8)
    child_locs = np.array([[[5, 5], [5, 6], [6, 5], [6, 6]] * 2])
    kvalid = np.ones((1, 8), bool)
    got = tstream.lookup_host(child_locs, kvalid, [t])
    want = jstream.lookup_host(child_locs, kvalid, [t])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["use_fallback"][0] and got["mask"][0].sum() == 4
    np.testing.assert_array_equal(got["locs"][0][:4],
                                  [[0, 0], [0, 1], [1, 0], [1, 1]])


def test_coords_cross_in_one_copy(monkeypatch):
    """The child coordinates and their validity come to the host through
    one device-to-host copy, and unpack to what they were."""
    calls = []
    real = torch.Tensor.cpu

    def spy(self, *a, **kw):
        calls.append(self.shape)
        return real(self, *a, **kw)

    locs = torch.randint(-3, 40, (3, 8, 2))
    kvalid = torch.rand(3, 8) < 0.5
    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    got_locs, got_valid = tstream.coords_to_host(
        {"child_locs": locs, "child_kvalid": kvalid})
    assert len(calls) == 1
    np.testing.assert_array_equal(got_locs, locs.numpy())
    np.testing.assert_array_equal(got_valid, kvalid.numpy())


# --------------------------------------------------------- against JAX's engine

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_streaming_matches_jax(monkeypatch, store, impl):
    """Loss, prediction and per-leaf gradients of one batch through both
    packages' streaming engines; "pallas" runs the JAX kernels in the
    Pallas interpreter and the port's autograd Function on its plain
    versions."""
    monkeypatch.setattr(fa, "INTERPRET", True)
    tmp, ids, _ = store
    jcfg, tcfg = configs(tmp, attention_impl=impl)
    params = recursive_init(jax.random.PRNGKey(1), jcfg)
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    jds, tds = _jax_dataset(jcfg, ids), _port_dataset(tcfg, ids)
    jbag = jdata.collate_bag0(jds, IDX, level0_bucket=32)
    tbag = tdata.collate_bag0(tds, IDX, level0_bucket=32, device="cpu")
    jlab, tlab = _labels()

    jl, jpred, jg = jstream.StreamingEngine(jcfg).loss_and_grad(
        params, jbag, _host_tables(jds), jlab, deterministic=True)
    eng = tstream.StreamingEngine(tcfg, "cpu")
    loss, pred, grads = eng.loss_and_grad(model, tbag, _host_tables(tds),
                                          tlab, training=False)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=2e-5,
                               rtol=0)
    want = jstate._flatten(jg)
    got = _grads_by_key(model)
    assert sorted(got) == sorted(want)
    assert set(grads) == {n for n, p in model.named_parameters()
                          if p.grad is not None}
    scale = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=key)


def test_streaming_selections_match_jax(store):
    """Every level's bag (mask, and locs where the mask is set) and the
    lookups recorded for it equal JAX's."""
    tmp, ids, _ = store
    jcfg, tcfg = configs(tmp)
    params = recursive_init(jax.random.PRNGKey(3), jcfg)
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    jds, tds = _jax_dataset(jcfg, ids), _port_dataset(tcfg, ids)
    jbag = jdata.collate_bag0(jds, IDX, level0_bucket=32)
    tbag = tdata.collate_bag0(tds, IDX, level0_bucket=32, device="cpu")
    jouts, jrec = jstream.StreamingEngine(jcfg).forward(
        params, jbag, _host_tables(jds), record=True)
    with torch.no_grad():
        touts, trec = tstream.StreamingEngine(tcfg, "cpu").forward(
            model, tbag, _host_tables(tds), record=True)
    assert len(trec) == len(jrec) == tcfg.num_levels - 1
    for jo, to in zip(jouts, touts):
        mask = np.asarray(jo["bag"].mask)
        np.testing.assert_array_equal(to["bag"].mask.numpy(), mask)
        np.testing.assert_array_equal(to["bag"].locs.numpy()[mask],
                                      np.asarray(jo["bag"].locs)[mask])
    for jl, tl in zip(jrec, trec):
        for key in ("mask", "locs", "parent", "use_fallback"):
            np.testing.assert_array_equal(tl[key].numpy(), np.asarray(jl[key]),
                                          err_msg=key)
        np.testing.assert_array_equal(tl["fts"].numpy(), np.asarray(jl["fts"]))


# ------------------------------------------------- against the port's fused engine

@pytest.mark.parametrize("dropout,training", [(0.0, False), (0.05, True)])
def test_streaming_matches_fused(store, dropout, training):
    """Same model, same batch: the streaming engine gives the fused
    engine's loss, prediction and gradients, also in training mode at the
    published dropout with one generator seed (the masks are drawn in the
    same level order)."""
    tmp, ids, _ = store
    _, tcfg = configs(tmp, mc=dict(dropout=dropout))
    model = fresh_model(tcfg, 4)
    tds = _port_dataset(tcfg, ids)
    bag, tables = tdata.collate_batch(tds, IDX, level0_bucket=32, device="cpu")
    _, tlab = _labels()

    model.zero_grad()
    lf, aux = th.end2end_loss(model, tcfg, bag, tables, tlab,
                              training=training,
                              generator=torch.Generator().manual_seed(9))
    lf.backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}
    ls, pred, got = tstream.StreamingEngine(tcfg, "cpu").loss_and_grad(
        model, bag, _host_tables(tds), tlab, training=training,
        generator=torch.Generator().manual_seed(9))
    np.testing.assert_allclose(ls.item(), lf.item(), rtol=1e-6)
    np.testing.assert_allclose(pred.numpy(), aux["pred"].detach().numpy(),
                               rtol=1e-6, atol=0)
    assert sorted(got) == sorted(want)
    scale = max(g.abs().max().item() for g in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=name)


# --------------------------------------------------------- the training loop

def test_train_loop_streaming_matches_jax(tmp_path, store):
    """engine="streaming" with lazy slides, 2 epochs, in both packages from
    one model.npz: per-epoch losses and final metrics agree, and every lazy
    slide is unloaded afterwards."""
    from paths_tpu.parallel.mesh import make_mesh

    tmp, _, _ = store
    jcfg, tcfg = configs(tmp, lr=1e-3, engine="streaming")
    params = recursive_init(jax.random.PRNGKey(5), jcfg)
    dirs = {name: str(tmp_path / name) for name in ("jax", "torch")}
    for d in dirs.values():
        jstate.save_state(d, params)
    jsplits = jdata.load_splits([0.7, 0.15, 0.15], jcfg.seed, jcfg,
                                preload=False)
    tsplits = tdata.load_splits([0.7, 0.15, 0.15], tcfg.seed, tcfg,
                                preload=False)
    jstats = jloop.train_loop(jcfg, dirs["jax"], *jsplits, mesh=make_mesh(1),
                              verbose=False)
    tstats = tloop.train_loop(tcfg, dirs["torch"], *tsplits, verbose=False,
                              device="cpu")
    for e in (1, 2):
        np.testing.assert_allclose(tstats["train_loss"][e],
                                   jstats["train_loss"][e], rtol=5e-2)
        assert abs(tstats["train_c-index"][e]
                   - jstats["train_c-index"][e]) <= 0.1
    final = {}
    for name, d in dirs.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            final[name] = json.loads(f.read().splitlines()[-1])
    np.testing.assert_allclose(final["torch"]["test_loss"],
                               final["jax"]["test_loss"], rtol=5e-2)
    assert abs(final["torch"]["test_c-index"]
               - final["jax"]["test_c-index"]) <= 0.1
    for ds in tsplits:
        assert all(s._tables is None and s._level0 is None for s in ds.slides)


def test_train_loop_streaming_equals_fused(tmp_path, store):
    """The same run on the streaming and the fused engine (dropout 0, one
    seed): equal per-epoch losses, as JAX's `test_streaming_train_loop`
    asks (rtol 2e-4)."""
    tmp, _, _ = store
    stats = {}
    for engine in ("fused", "streaming"):
        _, tcfg = configs(tmp, lr=1e-3, engine=engine)
        splits = tdata.load_splits([0.7, 0.15, 0.15], tcfg.seed, tcfg)
        stats[engine] = tloop.train_loop(tcfg, str(tmp_path / engine),
                                         *splits, verbose=False, device="cpu")
    for e in (1, 2):
        np.testing.assert_allclose(stats["streaming"]["train_loss"][e],
                                   stats["fused"]["train_loss"][e], rtol=2e-4)


# ------------------------------------------------------------ shapes and pads

def test_level0_only_pads(store):
    """The level-0-only scan reads the level-0 grids alone, agrees with the
    full scan's n0, leaves lazy slides unloaded, and the full scan's result
    then answers both."""
    tmp, _, _ = store
    _, tcfg = configs(tmp)
    ds = tdata.load_splits([1.0, 0.0, 0.0], 0, tcfg, preload=False)[0]
    l0 = ds.global_pads(level0_only=True)
    assert l0["rows"] == [0] * tcfg.num_levels
    assert all(s._tables is None and s._level0 is None for s in ds.slides)
    full = ds.global_pads()
    assert full["n0"] == l0["n0"] and max(full["rows"]) > 0
    assert ds.global_pads(level0_only=True) is full


def test_streaming_batches_pad_last_batch(store):
    """12 train slides at batch 5: under static shapes (pads) the last
    batch of 2 is padded to 5 with weight-0 duplicates and every batch has
    one level-0 width; without pads it keeps its size."""
    tmp, _, _ = store
    _, tcfg = configs(tmp, batch_size=5)
    ds = tdata.load_splits([1.0, 0.0, 0.0], 0, tcfg)[0]
    pads = ds.global_pads(level0_only=True)
    got = list(tloop._epoch_batches_streaming(
        ds, 5, shuffle=True, seed=1, config=tcfg, pads=pads, device="cpu"))
    assert [len(h) for _, h, _, _, _ in got] == [5, 5, 5]
    widths = {b.fts.shape[1] for b, *_ in got}
    assert len(widths) == 1 and widths.pop() >= pads["n0"]
    assert got[-1][3].tolist() == [1, 1, 0, 0, 0]
    assert got[-1][2]["weight"].tolist() == [1, 1, 0, 0, 0]
    assert got[-1][4][2] is got[-1][4][4]
    natural = list(tloop._epoch_batches_streaming(
        ds, 5, shuffle=True, seed=1, config=tcfg, device="cpu"))
    assert [len(h) for _, h, _, _, _ in natural] == [5, 5, 2]


def test_global_pads_keeps_slides_loaded_before_the_scan(store):
    """A lazy dataset's scan unloads the slides it loaded itself and keeps
    the ones that were loaded before it (JAX's `was_loaded` rule)."""
    tmp, _, _ = store
    _, tcfg = configs(tmp)
    ds = tdata.load_splits([1.0, 0.0, 0.0], 0, tcfg, preload=False)[0]
    assert not ds.cache_slides
    ds.slides[2].materialize()
    ds.global_pads()
    assert ds.slides[2]._tables is not None
    assert all(s._tables is None for i, s in enumerate(ds.slides) if i != 2)
