"""The port's data-parallel training on the CPU: gloo ranks started with
torchrun's environment (`tests/helpers_torch_dp.py`), against one port
process and against the JAX package on the suite's virtual CPU devices.

Every rank runs the same f32 CPU arithmetic on its own block of rows, so a
rank's gradients differ from one process's only in the order the two
blocks' sums are added:

* one update step: the ranks' losses add up to JAX's `make_mesh(2)` step
  within 1e-5 and the parameters agree at `param_tol`, as
  `tests/test_torch_train.py::test_update_steps_match_jax` holds them;
* two ranks against one port process: losses within 1e-6 relative,
  parameters within 1e-6 (a key bias at `param_tol`: its gradient is
  rounding noise that AdamW scales up to about lr a step);
* two epochs against JAX's `make_mesh(2)` run: rtol 5e-2 per epoch, the bar
  of `test_train_loop_matches_jax`;
* every rank ends with the same parameters to the bit, checkpoints and the
  loaded state are the one-process ones to the bit, and `cli.evaluate`'s
  metrics are one process's (the c-index exactly, the loss to 1e-6).

All ranks of the module run in two launches started together (2 and 4
ranks), each rank and each process group with its own timeout.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_torch_dp import launch
from paths_tpu.data import dataset as jdata
from paths_tpu.data.feature_store import FeatureStore as JStore
from paths_tpu.models.recursive import recursive_init
from paths_tpu.parallel.mesh import make_mesh as j_make_mesh
from paths_tpu.parallel.mesh import replicate as j_replicate
from paths_tpu.parallel.mesh import shard_train_batch
from paths_tpu.serve import serving_dataset
from paths_tpu.train import loop as jloop
from paths_tpu.train import state as jstate
from test_torch_train import configs, param_tol

from paths_tpu_torch import convert
from paths_tpu_torch.config import Config
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.data.synthetic import make_signal_metadata, make_signal_store
from paths_tpu_torch.engine.auto import estimate_fused_batch_bytes, resolve_engine
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.parallel.mesh import ProcessMesh
from paths_tpu_torch.train import loop as tloop
from paths_tpu_torch.train import state as tstate

STEP_IDX = list(range(6))
STEP_LABELS = {"survival_bin": [1, 3, 0, 2, 2, 1], "censored": [0, 1, 0, 0, 1, 0],
               "weight": [1, 1, 1, 1, 1, 0]}
PAD_PROPS = [0.6, 0.2, 0.2]   # 7 train slides of 12
RUNS = {  # name -> config changes of the training runs
    "fused": {}, "streaming": {"engine": "streaming"},
    "remat": {"remat": True, "num_epochs": 1},
    "pad2": {"batch_size": 3, "num_epochs": 1},
    "pad4": {"batch_size": 3, "num_epochs": 1}}


def _model_dir(path, tcfg, params):
    tcfg.save(path)
    jstate.save_state(path, params)
    return path


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The store, the initial weights, every rank's results, and the
    one-process port runs from the same directories."""
    tmp = str(tmp_path_factory.mktemp("torch_dp"))
    jcfg, tcfg = configs(tmp)
    ids, z = make_signal_store(tcfg.preprocess_dir, tcfg, num_slides=12,
                               base_hw=(3, 3), seed=0)
    make_signal_metadata(tcfg.csv_path, ids, z, seed=0)
    # host copies: JAX's update donates the arrays it is given
    params = jax.tree_util.tree_map(
        np.asarray, recursive_init(jax.random.PRNGKey(5), jcfg))

    dirs, one = {}, {}
    for name, changes in [("step", {})] + list(RUNS.items()):
        _, c = configs(tmp, **changes)
        dirs[name] = _model_dir(os.path.join(tmp, f"dp_{name}"), c, params)
        one[name] = _model_dir(os.path.join(tmp, f"one_{name}"), c, params)

    train = lambda name, **kw: {"kind": "train", "name": name,  # noqa: E731
                                "dir": dirs[name], **kw}
    jobs2 = [{"kind": "step", "name": "step", "dir": dirs["step"],
              "ids": ids, "idx": STEP_IDX, "labels": STEP_LABELS},
             train("fused"),
             {"kind": "load", "name": "load", "dir": dirs["fused"]},
             {"kind": "evaluate", "name": "evaluate", "dir": dirs["fused"]},
             train("streaming"), train("remat"),
             train("pad2", props=PAD_PROPS)]
    two, four = launch((2, jobs2, os.path.join(tmp, "out2")),
                       (4, [train("pad4", props=PAD_PROPS)],
                        os.path.join(tmp, "out4")))
    ranks = {2: two, 4: four}

    stats = {}
    for name in RUNS:
        c = Config.load(one[name])
        props = PAD_PROPS if name.startswith("pad") else [0.7, 0.15, 0.15]
        splits = tdata.load_splits(props, c.seed, c)
        stats[name] = tloop.train_loop(c, one[name], *splits, device="cpu",
                                       verbose=False)
    return {"tmp": tmp, "ids": ids, "params": params, "jcfg": jcfg,
            "tcfg": tcfg, "dirs": dirs, "one": one, "ranks": ranks,
            "stats": stats}


def _arrays(dp, name, rank, world=2):
    out = os.path.join(dp["tmp"], f"out{world}")
    with np.load(os.path.join(out, f"{name}_rank{rank}.npz")) as f:
        return dict(f)


def _model_flat(d):
    c = Config.load(d)
    return convert.to_jax_flat(tstate.load_model(d, RecursiveModel(c)))


def _close(got, want, tcfg, steps, tol=1e-6):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = param_tol(k, tcfg, steps) if k.endswith("/k/b") else tol
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


def _same_on_every_rank(dp, name, world=2):
    first = _arrays(dp, name, 0, world)
    for r in range(1, world):
        other = _arrays(dp, name, r, world)
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=f"rank {r} {k}")
    return first


def test_update_step_matches_jax_and_one_process(dp):
    """One AdamW step on a 6-slide batch (one padded row) split over two
    ranks, against JAX's update under `make_mesh(2)` and the port's own
    one-process update on the whole batch."""
    jcfg, tcfg = dp["jcfg"], dp["tcfg"]
    mesh = j_make_mesh(2)
    tx = jloop.make_optimizer(jcfg)
    jupdate = jloop.make_step_fns(jcfg, tx, mesh=mesh)[0]
    jds = serving_dataset(jcfg, JStore(jcfg.preprocess_dir), dp["ids"])
    jbag, jtables, _ = jdata.collate_batch(jds, STEP_IDX, level0_bucket=32)
    jlab = {k: jnp.asarray(np.asarray(v, np.float32 if k == "weight"
                                      else np.int32))
            for k, v in STEP_LABELS.items()}
    params = j_replicate(mesh, dp["params"])
    p1, _, jl, _ = jupdate(params, j_replicate(mesh, tx.init(params)),
                           *shard_train_batch(mesh, jbag, jtables, jlab),
                           jax.random.PRNGKey(0), jnp.asarray(1.0))

    ranks = [r["step"]["loss"] for r in dp["ranks"][2]]
    got = _same_on_every_rank(dp, "step")
    np.testing.assert_allclose(sum(ranks), float(jl), rtol=1e-5)
    _close(got, {k: np.asarray(v) for k, v in jstate._flatten(p1).items()},
           tcfg, 1, tol=1e-6)

    model = convert.from_jax_flat(jstate._flatten(dp["params"]), tcfg)
    opt = tloop.make_optimizer(tcfg, model.parameters())
    tds = tdata.SlideDataset(dp["ids"], tcfg, FeatureStore(tcfg.preprocess_dir))
    bag, tables = tdata.collate_batch(tds, STEP_IDX, level0_bucket=32,
                                      device="cpu")
    labels = {k: torch.from_numpy(np.asarray(v)) for k, v in STEP_LABELS.items()}
    labels["weight"] = labels["weight"].float()
    loss, _ = tloop.make_step_fns(tcfg, opt)[0](model, bag, tables, labels,
                                                 epoch=1)
    np.testing.assert_allclose(sum(ranks), loss.item(), rtol=1e-6)
    _close(got, convert.to_jax_flat(model), tcfg, 1)


@pytest.mark.parametrize("engine", ["fused", "streaming", "remat"])
def test_two_ranks_match_one_process(dp, engine):
    """Two epochs on two ranks (one with `remat`, which recomputes each
    level in the backward) against one port process from the same
    directory: per-epoch losses, and the final parameters of every rank."""
    rank0 = dp["ranks"][2][0][engine]
    assert dp["ranks"][2][1][engine] == rank0
    want = dp["stats"][engine]
    epochs = sorted(want["train_loss"])
    for key in ("train_loss", "val_loss"):
        assert sorted(rank0[key]) == [str(e) for e in epochs]
        for e in epochs:
            np.testing.assert_allclose(rank0[key][str(e)], want[key][e],
                                       rtol=1e-6, err_msg=f"{key} {e}")
    got = _same_on_every_rank(dp, engine)
    _close(got, _model_flat(dp["one"][engine]), dp["tcfg"], 2 * len(epochs))


def test_train_loop_matches_jax_on_two_devices(dp, tmp_path):
    """The same two-epoch run in JAX over `make_mesh(2)`: the trajectories
    agree at the bar of the one-device comparison."""
    jcfg = dp["jcfg"]
    d = _model_dir(str(tmp_path / "jax"), dp["tcfg"], dp["params"])
    train, val, test = jdata.load_splits([0.7, 0.15, 0.15], jcfg.seed, jcfg)
    jstats = jloop.train_loop(jcfg, d, train, val, test, mesh=j_make_mesh(2),
                              verbose=False)
    got = dp["ranks"][2][0]["fused"]["train_loss"]
    for e in (1, 2):
        np.testing.assert_allclose(got[str(e)], jstats["train_loss"][e],
                                   rtol=5e-2)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_padding(dp, world):
    """7 train slides at batch 3 over `world` ranks: batches pad to 4 with
    duplicates of weight 0 (the last holds one real slide; at 4 ranks three
    ranks hold only padding). The losses are finite and, as the padded rows
    carry no weight, equal one process's at batch 3; so are the weights."""
    name = f"pad{world}"
    got = dp["ranks"][world][0][name]["train_loss"]["1"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, dp["stats"][name]["train_loss"][1],
                               rtol=1e-6)
    params = _same_on_every_rank(dp, name, world)
    _close(params, _model_flat(dp["one"][name]), dp["tcfg"], 3)


def test_checkpoints_under_dp(dp):
    """Rank 0 alone writes: the metrics file holds one process's lines (a
    second writer would double them) and the checkpoint its keys. Resuming,
    every rank loads that checkpoint and `replicate` leaves each rank with
    the state one process loads from it, to the bit."""
    d = dp["dirs"]["fused"]
    with open(os.path.join(d, "metrics.jsonl")) as f, \
            open(os.path.join(dp["one"]["fused"], "metrics.jsonl")) as g:
        assert len(f.read().splitlines()) == len(g.read().splitlines()) == 5
    c = Config.load(d)
    model = RecursiveModel(c)
    opt = tloop.make_optimizer(c, model.parameters())
    model, opt, stats = tstate.load_state(d, model, opt)
    assert stats["epoch"] == 2
    want = {**convert.to_jax_flat(model),
            **tstate.optimizer_to_jax_flat(model, opt, None)}
    got = _same_on_every_rank(dp, "load")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_cli_evaluate_two_ranks(dp, capsys):
    """`cli.evaluate` on two ranks gives one process's metrics over the
    same checkpoint."""
    from paths_tpu_torch.cli.evaluate import main

    ranks = [r["evaluate"] for r in dp["ranks"][2]]
    assert ranks[0] == ranks[1]
    want = main(["-m", dp["dirs"]["fused"], "--split", "test",
                 "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.split("\n", 1)[1]) == want
    assert sorted(ranks[0]) == sorted(want)
    assert ranks[0]["test_c-index"] == want["test_c-index"]
    np.testing.assert_allclose(ranks[0]["test_loss"], want["test_loss"],
                               rtol=1e-6)


def test_engine_auto_prices_a_ranks_share(dp):
    """Under "auto" a rank prices its own share of the batch, ceil(B / W)
    rows, against its own card: a card that cannot hold the fused batch of
    4 slides holds a rank's 2 at W = 2 (JAX prices the global batch against
    one device, so it would stream here)."""
    _, auto = configs(dp["tmp"], engine="auto")
    ds = tdata.load_splits([0.7, 0.15, 0.15], auto.seed, auto)[0]
    pads = ds.global_pads()
    share = tloop.rank_batch(4, ProcessMesh(1, 2))
    assert share == 2 and tloop.rank_batch(3, ProcessMesh(0, 4)) == 1
    need = [3.0 * estimate_fused_batch_bytes(auto, pads, b) for b in (2, 4)]
    hbm = int(((need[0] + need[1]) / 2 + (512 << 20)) / 0.85)
    assert resolve_engine(auto, pads, share, hbm=hbm, verbose=False) == "fused"
    assert resolve_engine(auto, pads, 4, hbm=hbm, verbose=False) == "streaming"
