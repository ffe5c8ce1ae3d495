"""The port's training slice on the CPU, against the JAX package.

Inputs come from numpy seeds and weights cross over in the JAX package's
`model.npz` layout. Both packages run in f32 on the CPU, where they differ
only in summation order:

* a loss and its per-leaf gradients agree to 1e-5 relative to the largest
  gradient of the leaf's tree (summation order through 3 levels);
* AdamW steps agree to 1e-6 on the parameters (the optimizer adds nothing
  but rounding: its first step moves each parameter by about lr * sign(g),
  and lr is 2e-5 here). The exception is an attention's key bias: a shift
  of all of a query's logits leaves the softmax unchanged, so its gradient
  is zero in exact arithmetic, AdamW turns the rounding noise into steps of
  about lr in either direction, and it is held to 2 * lr per step;
* whole training runs agree to rtol 5e-2 per epoch on the loss and 0.1 on
  the c-index, the bars of `tests/test_trajectory_parity.py`;
* splits, bins, labels and metrics are exact.

Dropout draws differ between the packages' generators, so every parity check
runs at dropout 0 or outside training; dropout itself is checked for its
rate, scaling, sites and routing.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from paths_tpu.config import Config as JConfig
from paths_tpu.config import PATHSProcessorConfig as JPConfig
from paths_tpu.data import dataset as jdata
from paths_tpu.data.synthetic import make_signal_metadata as j_signal_metadata
from paths_tpu.data.synthetic import make_signal_store as j_signal_store
from paths_tpu.engine import hierarchy as jh
from paths_tpu.models.recursive import recursive_init
from paths_tpu.train import evaluators as jev
from paths_tpu.train import loop as jloop
from paths_tpu.train import metrics as jmetrics
from paths_tpu.train import state as jstate

from paths_tpu_torch import convert
from paths_tpu_torch.config import Config, PATHSProcessorConfig
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.data.synthetic import make_signal_metadata, make_signal_store
from paths_tpu_torch.engine import hierarchy as th
from paths_tpu_torch.nn import attention as tattn
from paths_tpu_torch.nn import transformer as ttr
from paths_tpu_torch.nn.core import dropout
from paths_tpu_torch.train import evaluators as tev
from paths_tpu_torch.train import loop as tloop
from paths_tpu_torch.train import metrics as tmetrics
from paths_tpu_torch.train import state as tstate

GRAD_TOL = 1e-5     # relative to the largest gradient, f32 on the CPU
PARAM_TOL = 1e-6    # parameters after AdamW steps at lr 2e-5


def param_tol(key, cfg, steps):
    """PARAM_TOL, or 2 * lr per step for a key bias (see the docstring)."""
    return 2 * cfg.lr * steps if key.endswith("/k/b") else PARAM_TOL

MC = dict(patch_embed_dim=32, trans_dim=16, trans_heads=2, trans_layers=1,
          importance_mlp_hidden_dim=8, hierarchical_ctx_mlp_hidden_dim=8,
          pos_encoding_mode="2d", dropout=0.0)


def configs(tmp, **kw):
    """The same small training config in both packages: 3 levels, K=2,
    one static level-0 width (bucket 32)."""
    base = dict(num_levels=3, top_k_patches=2, nbins=4, task="survival",
                num_epochs=2, batch_size=4, level0_bucket=32,
                csv_path=os.path.join(tmp, "meta.csv"),
                preprocess_dir=os.path.join(tmp, "store"),
                wsi_dir=os.path.join(tmp, "brca"))
    mc = {**MC, **kw.pop("mc", {})}
    base.update(kw)
    return (JConfig(model_config=JPConfig(**mc), **base),
            Config(model_config=PATHSProcessorConfig(**mc), **base))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A 12-slide signal store and its metadata, written by the port."""
    tmp = str(tmp_path_factory.mktemp("torch_train"))
    _, tcfg = configs(tmp)
    ids, z = make_signal_store(tcfg.preprocess_dir, tcfg, num_slides=12,
                               base_hw=(3, 3), seed=0)
    make_signal_metadata(tcfg.csv_path, ids, z, seed=0)
    return tmp, ids, z


def test_signal_store_and_metadata_match_jax(tmp_path, store):
    tmp, ids, z = store
    jcfg, _ = configs(str(tmp_path))
    jids, jz = j_signal_store(jcfg.preprocess_dir, jcfg, num_slides=12,
                              base_hw=(3, 3), seed=0)
    j_signal_metadata(jcfg.csv_path, jids, jz, seed=0)
    assert jids == ids
    np.testing.assert_array_equal(jz, z)
    names = sorted(os.listdir(jcfg.preprocess_dir))
    assert names == sorted(os.listdir(os.path.join(tmp, "store")))
    for n in names:
        np.testing.assert_array_equal(
            np.load(os.path.join(jcfg.preprocess_dir, n)),
            np.load(os.path.join(tmp, "store", n)))
    with open(jcfg.csv_path) as a, open(os.path.join(tmp, "meta.csv")) as b:
        assert a.read() == b.read()


# ------------------------------------------------------------------ dropout

def test_dropout_rate_and_scaling():
    x = torch.ones(400_000)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, generator=g, training=True)
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.25) < 3e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert dropout(x, 0.25, generator=g, training=False) is x
    assert dropout(x, 0.0, generator=g, training=True) is x
    with pytest.raises(ValueError):
        dropout(x, 0.25, training=True)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_dropout_sites_of_a_decoder_layer(monkeypatch):
    """Five sites, as in the JAX package: self-attention weights, after the
    self-attention, after the cross-attention (with an empty memory its
    output is the broadcast out-projection bias, and it is still dropped),
    inside the feed-forward after the ReLU, after the feed-forward."""
    layer = ttr.DecoderLayer(16, 2, 64,
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.cross_attn.out.bias.uniform_(-1, 1)
    weights = _count_calls(monkeypatch, tattn, "dropout")
    outputs = _count_calls(monkeypatch, ttr, "dropout")
    x, mem = torch.randn(2, 9, 16), torch.zeros(2, 0, 16)
    g = torch.Generator().manual_seed(1)
    layer(x, mem, rate=0.1, generator=g, training=True)
    assert len(weights) == 1 and weights[0][0][0].shape == (2, 2, 9, 9)
    assert len(outputs) == 4
    bias = layer.cross_attn.out.bias.detach().expand(2, 9, 16)
    assert torch.equal(outputs[1][0][0], bias)
    for args, kwargs in weights + outputs:
        assert args[1] == 0.1 and kwargs == {"generator": g, "training": True}


@pytest.mark.parametrize("training,rate,routed", [
    (True, 0.05, False), (True, 0.0, True), (False, 0.05, True)])
def test_kernel_route_skipped_under_active_dropout(monkeypatch, training, rate,
                                                   routed):
    """Under "pallas" the differentiable kernel route is taken exactly when
    JAX takes its kernel: not while attention dropout is active."""
    calls = _count_calls(monkeypatch, tattn, "masked_flash_attention")
    mha = tattn.MultiheadAttention(16, 2,
                                   generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 11, 16)
    valid = torch.arange(11)[None] < torch.tensor([11, 4, 1])[:, None]
    mha(x, x, x, key_valid=valid, dropout_rate=rate, training=training,
        generator=torch.Generator().manual_seed(2), impl="pallas")
    assert len(calls) == int(routed)


# ------------------------------------------------------- loss and gradients

def _batch(tmp, ids, jcfg, tcfg):
    """One collated batch in both packages, with labels."""
    from paths_tpu.data.feature_store import FeatureStore as JStore
    from paths_tpu.serve import serving_dataset

    from paths_tpu_torch.data.feature_store import FeatureStore

    idx = list(range(6))
    jds = serving_dataset(jcfg, JStore(jcfg.preprocess_dir), ids)
    jbag, jtables, _ = jdata.collate_batch(jds, idx, level0_bucket=32)
    tds = tdata.SlideDataset(ids, tcfg, FeatureStore(tcfg.preprocess_dir))
    tbag, ttables = tdata.collate_batch(tds, idx, level0_bucket=32,
                                        device="cpu")
    rng = np.random.default_rng(3)
    labels = {"survival_bin": rng.integers(0, 4, 6).astype(np.int32),
              "censored": np.array([0, 1, 0, 0, 1, 0], np.int32),
              "weight": np.array([1, 1, 1, 1, 1, 0], np.float32)}
    return ((jbag, jtables, {k: jnp.asarray(v) for k, v in labels.items()}),
            (tbag, ttables, {k: torch.from_numpy(v) for k, v in labels.items()}))


def _grads_by_key(model):
    """Gradients in the JAX layout; a parameter outside the loss's graph
    (the logits heads of the levels before the last) gets zeros, as under
    `jax.grad`."""
    keys = convert.jax_keys(model)
    return {keys[n]: convert.to_jax_layout(
        keys[n], np.zeros(tuple(p.shape), np.float32) if p.grad is None
        else p.grad.numpy()) for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_end2end_loss_gradients_match_jax(monkeypatch, store, impl):
    """Per-leaf gradients of the loss; "pallas" runs the JAX kernels in the
    Pallas interpreter and the port's autograd Function on its plain
    versions. The empty-memory cross-attention out-bias gets its gradient."""
    monkeypatch.setattr(fa, "INTERPRET", True)
    tmp, ids, _ = store
    jcfg, tcfg = configs(tmp, attention_impl=impl)
    params = recursive_init(jax.random.PRNGKey(1), jcfg)
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    (jbag, jtables, jlab), (tbag, ttables, tlab) = _batch(tmp, ids, jcfg, tcfg)

    def jloss(p):
        return jh.end2end_loss(p, jcfg, jbag, jtables, jlab)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    routed = _count_calls(monkeypatch, tattn, "masked_flash_attention")
    loss, aux = th.end2end_loss(model, tcfg, tbag, ttables, tlab)
    loss.backward()
    assert len(routed) == (tcfg.num_levels if impl == "pallas" else 0)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    want = jstate._flatten(jg)
    got = _grads_by_key(model)
    assert sorted(got) == sorted(want)
    scale = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=key)
    bias = "procs/0/agg/transformer/decoder/layers/0/cross_attn/out/b"
    assert np.abs(want[bias]).max() > 0


# ------------------------------------------------------------- the optimizer

@functools.lru_cache(maxsize=None)
def jax_steps(tmp, clip):
    """(config, optax optimizer, jitted update) of the JAX package, built
    once per clip setting so the tests share one compilation."""
    jcfg, _ = configs(tmp, clip_grad_norm=clip)
    tx = jloop.make_optimizer(jcfg)
    return jcfg, tx, jloop.make_step_fns(jcfg, tx)[0]


@pytest.mark.parametrize("clip", [None, 1e-3])
def test_update_steps_match_jax(store, clip):
    """Three steps of the port's `update` against JAX's `make_step_fns`,
    with and without a global-norm clip (1e-3 clips every step here), and
    the learning rate of epochs 1, 2, 3."""
    tmp, ids, _ = store
    jcfg, tx, jupdate = jax_steps(tmp, clip)
    _, tcfg = configs(tmp, clip_grad_norm=clip)
    params = recursive_init(jax.random.PRNGKey(2), jcfg)
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    (jbag, jtables, jlab), (tbag, ttables, tlab) = _batch(tmp, ids, jcfg, tcfg)
    opt_state = tx.init(params)
    opt = tloop.make_optimizer(tcfg, model.parameters())
    tupdate, tevaluate = tloop.make_step_fns(tcfg, opt)
    for e in (1, 2, 3):
        params, opt_state, jl, _ = jupdate(params, opt_state, jbag, jtables,
                                           jlab, jax.random.PRNGKey(0),
                                           jnp.asarray(float(e)))
        tl, _ = tupdate(model, tbag, ttables, tlab, epoch=e)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert opt.param_groups[0]["lr"] == pytest.approx(tcfg.lr * 0.99 ** 2)
    want = jstate._flatten(params)
    for key, got in convert.to_jax_flat(model).items():
        np.testing.assert_allclose(got, want[key], rtol=0, err_msg=key,
                                   atol=param_tol(key, tcfg, 3))
    el, aux = tevaluate(model, tbag, ttables, tlab)
    assert aux["pred"].shape == (6, 4) and not el.requires_grad


@pytest.mark.parametrize("clip", [None, 1e-3])
def test_checkpoints_resume_across_packages(tmp_path, store, clip):
    """JAX trains a step and saves; the port loads model.npz and opt.npz,
    matches them exactly, trains a step and saves; JAX loads that and
    agrees with its own second step."""
    tmp, ids, _ = store
    jcfg, tx, jupdate = jax_steps(tmp, clip)
    _, tcfg = configs(tmp, clip_grad_norm=clip)
    params = recursive_init(jax.random.PRNGKey(4), jcfg)
    (jbag, jtables, jlab), (tbag, ttables, tlab) = _batch(tmp, ids, jcfg, tcfg)
    key = jax.random.PRNGKey(0)
    p1, s1, _, _ = jupdate(params, tx.init(params), jbag, jtables, jlab, key,
                           jnp.asarray(1.0))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstate.save_state(jdir, p1, s1, {"epoch": 2, "train_loss": {1: 0.5}})

    model = tloop.RecursiveModel(tcfg)
    opt = tloop.make_optimizer(tcfg, model.parameters())
    model, opt, stats = tstate.load_state(jdir, model, opt,
                                          clip_grad_norm=clip)
    assert stats == {"epoch": 2, "train_loss": {1: 0.5}}
    for k, v in convert.to_jax_flat(model).items():
        np.testing.assert_array_equal(v, np.asarray(jstate._flatten(p1)[k]))
    want_opt = jstate._flatten(s1)
    got_opt = tstate.optimizer_to_jax_flat(model, opt, clip)
    assert sorted(got_opt) == sorted(want_opt)
    for k, v in want_opt.items():
        np.testing.assert_array_equal(got_opt[k], v, err_msg=k)

    tupdate, _ = tloop.make_step_fns(tcfg, opt)
    tupdate(model, tbag, ttables, tlab, epoch=1)
    tstate.save_state(tdir, model, opt, {"epoch": 3}, clip_grad_norm=clip)
    p2, s2, _, _ = jupdate(p1, s1, jbag, jtables, jlab, key, jnp.asarray(1.0))
    lp, ls, lstats = jstate.load_state(tdir, params, tx.init(params))
    assert lstats == {"epoch": 3}
    got, want = jstate._flatten(lp), jstate._flatten(p2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                   atol=param_tol(k, tcfg, 1))
    # moments hold gradients: GRAD_TOL relative to the largest of their
    # kind; the key bias's are rounding noise; counts and hyperparameters
    # are exact
    got, want = jstate._flatten(ls), jstate._flatten(s2)
    for kind in (".mu/", ".nu/"):
        keys = [k for k in want if kind in k and not k.endswith("/k/b")]
        scale = max(np.abs(want[k]).max() for k in keys)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=0, err_msg=k,
                                       atol=GRAD_TOL * scale)
    for k in want:
        if ".mu/" not in k and ".nu/" not in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-7, err_msg=k)


def test_unported_options_raise(tmp_path, store):
    """The mesh is the process group: `mesh_shape` [2, 1] in one process
    names torchrun with 2 processes, and so does the sequence-parallel
    [1, 2], which needs dp * sp = 2. Data- and sequence-parallel runs:
    `tests/test_torch_dp_train.py`, `tests/test_torch_seq_train.py`."""
    tmp, _, _ = store
    _, tcfg = configs(tmp, mesh_shape=[2, 1])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tloop.train_loop(tcfg, str(tmp_path), None, None, None, device="cpu")
    _, tcfg = configs(tmp, mesh_shape=[1, 2])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tloop.train_loop(tcfg, str(tmp_path), None, None, None, device="cpu")


# ------------------------------------------------------- the training loop

def test_train_loop_matches_jax(tmp_path, store):
    """Both packages train 2 epochs from one model.npz on the same store:
    the port through its CLI on the CPU, JAX through `train_loop` on the
    CLI's splits. Losses per epoch and the final metrics agree, and the
    port's checkpoint loads in JAX."""
    from paths_tpu.parallel.mesh import make_mesh

    from paths_tpu_torch.cli.train import main

    tmp, _, _ = store
    jcfg, tcfg = configs(tmp, lr=1e-3)
    params = recursive_init(jax.random.PRNGKey(5), jcfg)
    dirs = {name: str(tmp_path / name) for name in ("jax", "torch")}
    for d in dirs.values():
        tcfg.save(d)
        jstate.save_state(d, params)
    train, val, test = jdata.load_splits([0.7, 0.15, 0.15], jcfg.seed, jcfg)
    jstats = jloop.train_loop(jcfg, dirs["jax"], train, val, test,
                              mesh=make_mesh(1), verbose=False)
    tstats = main(["-m", dirs["torch"], "--no-wandb", "--device", "cpu"])
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
    tx = jloop.make_optimizer(jcfg)
    _, _, stats = jstate.load_state(dirs["torch"], params, tx.init(params))
    assert stats["epoch"] == 2 and set(stats["train_loss"]) == {1, 2}

    # val batches kept on the device from the first pass give the same run
    tcfg.cache_eval_batches = True
    cached = str(tmp_path / "cached")
    tcfg.save(cached)
    jstate.save_state(cached, params)
    cstats = main(["-m", cached, "--no-wandb", "--device", "cpu"])
    for key in ("train_loss", "val_loss", "val_c-index"):
        assert cstats[key] == tstats[key], key


def test_train_loop_records_host_rss_per_epoch(tmp_path, store, capsys):
    """Each epoch's resident set size lands in train_stats and its line,
    as in the JAX package."""
    tmp, _, _ = store
    _, tcfg = configs(tmp, num_epochs=2)
    splits = tdata.load_splits([0.7, 0.15, 0.15], tcfg.seed, tcfg)
    stats = tloop.train_loop(tcfg, str(tmp_path), *splits, device="cpu")
    assert sorted(stats["host_rss_mb"]) == [1, 2]
    out = capsys.readouterr().out
    for e in (1, 2):
        assert stats["host_rss_mb"][e] > 0
        assert f"rss {stats['host_rss_mb'][e]:.0f}MB" in out
    with open(os.path.join(str(tmp_path), "train_stats.json")) as f:
        assert set(json.load(f)["host_rss_mb"]) == {"1", "2"}


# --------------------------------------------------- metadata, splits, labels

def _write_csv(path, rows):
    from paths_tpu_torch.data.synthetic import _write_metadata

    _write_metadata(path, "\n".join(rows) + "\n")


def _split_pair(jcfg, tcfg, props=(0.5, 0.25, 0.25)):
    """Both packages' splits of one config, without preloading tables."""
    return (jdata.load_splits(props, jcfg.seed, jcfg, preload=False),
            tdata.load_splits(props, tcfg.seed, tcfg, preload=False))


def _same_splits(jsplits, tsplits):
    for j, t in zip(jsplits, tsplits):
        if j is None:
            assert t is None
            continue
        assert t.slide_ids == j.slide_ids
        idx = list(range(len(j)))
        want, got = j.labels(idx), t.labels(idx)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_metadata_and_random_splits_match_pandas(tmp_path, store, seed):
    """A zipped CSV with a row whose slide has no file and a repeated
    case_id: both are dropped as pandas drops them; bins equal `pd.qcut`'s,
    labels `pd.cut`'s, and the random splits `frame.sample`'s."""
    tmp, _, _ = store
    with open(os.path.join(tmp, "meta.csv")) as f:
        rows = f.read().splitlines()
    rows += ["CASE-0099,NOFILE-01Z-00.svs,12.5,0,IDC", rows[3]]
    csv_path = str(tmp_path / "meta.csv.zip")
    _write_csv(csv_path, rows)
    jcfg, tcfg = configs(tmp, csv_path=csv_path, seed=seed)
    from paths_tpu.data.feature_store import FeatureStore as JStore

    from paths_tpu_torch.data.feature_store import FeatureStore

    frame, jbins = jdata.load_metadata(jcfg, JStore(jcfg.preprocess_dir))
    trows, tbins = tdata.load_metadata(tcfg, FeatureStore(tcfg.preprocess_dir))
    np.testing.assert_array_equal(tbins, jbins)
    assert [r["case_id"] for r in trows] == list(frame.case_id)
    months = np.array([r["survival_months"] for r in trows])
    np.testing.assert_array_equal(
        tdata.cut_labels(months, tbins),
        pd.cut(frame.survival_months, jbins, labels=False,
               include_lowest=True))
    _same_splits(*_split_pair(jcfg, tcfg))


@pytest.mark.parametrize("task", ["survival", "subtype_classification"])
def test_hipt_splits_match_jax(tmp_path, store, task):
    """HIPT split files: case pairs (survival, with a val share cut from
    train) or slide triples (subtypes, filtered to two classes)."""
    tmp, ids, z = store
    csv_path = str(tmp_path / "meta.csv")
    subtypes = ["IDC", "ILC"] if task != "survival" else None
    make_signal_metadata(csv_path, ids, z, seed=1, subtypes=subtypes)
    sub = "survival" if task == "survival" else "subtype_classification"
    split_dir = tmp_path / "splits" / sub / "tcga_brca"
    split_dir.mkdir(parents=True)
    if task == "survival":
        lines = [",train,test"] + [
            f"{i},CASE-{i:04d},{f'CASE-{i + 8:04d}' if i < 4 else ''}"
            for i in range(8)]
    else:
        lines = [",train,val,test"] + [
            f"{i},{ids[i]},{ids[i + 6] if i < 3 else ''},"
            f"{ids[i + 9] if i < 3 else ''}" for i in range(6)]
    (split_dir / "splits_0.csv").write_text("\n".join(lines) + "\n")
    kw = dict(csv_path=csv_path, task=task, hipt_splits=True,
              splits_dir=str(tmp_path / "splits"), hipt_val_proportion=0.25)
    if subtypes:
        kw["filter_to_subtypes"] = subtypes
    jcfg, tcfg = configs(tmp, **kw)
    jsplits, tsplits = _split_pair(jcfg, tcfg)
    assert len(tsplits[0]) and len(tsplits[2])
    _same_splits(jsplits, tsplits)


# ---------------------------------------------------- metrics and evaluators

def test_metrics_and_evaluators_match_jax():
    """c-index (with tied times and risks), AUROC (with tied scores) and
    both evaluators over two registered batches, exactly."""
    rng = np.random.default_rng(0)
    n = 40
    events = rng.uniform(size=n) < 0.6
    times = rng.integers(1, 15, n).astype(float)
    risk = np.round(rng.normal(size=n), 1)
    assert (tmetrics.concordance_index_censored(events, times, risk)
            == jmetrics.concordance_index_censored(events, times, risk))
    labels = rng.uniform(size=n) < 0.4
    assert (tmetrics.binary_auroc(risk, labels)
            == jmetrics.binary_auroc(risk, labels))
    with pytest.raises(tmetrics.NoComparablePairs):
        tmetrics.concordance_index_censored(np.zeros(3, bool), np.ones(3),
                                            np.ones(3))

    jcfg, tcfg = configs("/nonexistent", task="subtype_classification",
                         filter_to_subtypes=["IDC", "ILC", "MIX"])
    for task, cfg_pair in (("survival", configs("/nonexistent")),
                           ("subtype_classification", (jcfg, tcfg))):
        results = []
        for cfg, make in ((cfg_pair[0], jev.make_evaluator),
                          (cfg_pair[1], tev.make_evaluator)):
            ev = make(cfg, "val")
            rng = np.random.default_rng(7)   # the same draws for both
            stats = {"val_loss": {}, "val_c-index": {}, "val_AUC": {}}
            for b in range(2):
                batch = {"censored": rng.integers(0, 2, 8) if b else
                         np.array([0, 0, 1, 0, 1, 0, 0, 1]),
                         "survival": rng.uniform(1, 100, 8),
                         "subtype": np.arange(8) % 3}
                pred = rng.uniform(0.05, 0.95, (8, 4 if task == "survival"
                                                else 3))
                ev.register(batch, pred, 0.5 + b)
            results.append((ev.calculate(stats, 3), stats))
        assert results[0] == results[1]
