"""The port's sequence parallelism on the CPU (`mesh_shape` [dp, sp>1]):
gloo ranks started with torchrun's environment (`tests/helpers_torch_dp.py`)
against the JAX package on the suite's virtual CPU devices, where GSPMD
partitions what the port partitions by hand (`engine/hierarchy.py`).

Bars, as the JAX package's own sequence-parallel tests set them
(`tests/test_patch_sharding.py`) and the data-parallel ones of the port:

* level 0 under [1, 4] and [2, 2]: logits and the gathered importance
  within 1e-5 of JAX's `recursive_apply` over `make_mesh_2d` on the plain
  route, 2e-5 on the kernel route (the kernels' plain versions on the CPU)
  under both schedules; `end2end_loss` under [2, 2] at rtol 1e-5;
* one update step under [1, 2] and [2, 2]: the world's summed gradients
  within 1e-6 of one process's (absolute; the key biases, rounding noise,
  at `param_tol`), the parameters after AdamW likewise, and every rank's
  parameters equal to the bit;
* the ring step on JAX's seed-0 initial weights (`models/jax_init.py::
  fresh_model`, what a new run trains from) over level-0 bags of 576
  patches: f32 against one process within GRAD_RTOL (1e-4) of each
  tensor's largest gradient (a key bias: of the model's), as the card's
  [seq-train] holds it; in f64 (the plain versions sum in f64) the same
  gap falls to rounding scale, under 1e-8 of that bar; and JAX's own ring
  step on those weights (`ring_flash_attention` over the virtual devices)
  parts from its one-device step as far, within the bar, so the gap is the
  schedule's rounding, not the port's;
* a [1, 2] `train_loop` on the ring schedule against JAX's [2, 4] run at
  rtol 5e-4 per epoch; the streaming engine and remat under [1, 2] within
  1e-6 of it; dropout 0.05 (the plain route) with the ranks' parameters
  equal to the bit; `cli.evaluate` under [1, 2] equal to one process's (the
  c-index exactly, the loss within 1e-6).

Both world sizes (2 and 4 ranks) launch together, every rank and group with
its own timeout, while JAX computes its side.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from helpers_torch_dp import launch
from paths_tpu.data import dataset as jdata
from paths_tpu.data.feature_store import FeatureStore as JStore
from paths_tpu.engine.hierarchy import end2end_loss as j_end2end_loss
from paths_tpu.models.recursive import recursive_apply as j_recursive_apply
from paths_tpu.models.recursive import recursive_init
from paths_tpu.parallel.mesh import make_mesh_2d
from paths_tpu.parallel.mesh import replicate as j_replicate
from paths_tpu.parallel.mesh import shard_bag_patches as j_shard_bag_patches
from paths_tpu.parallel.seq_attention import SeqSharding as JSeqSharding
from paths_tpu.train import loop as jloop
from paths_tpu.train import state as jstate
from test_hierarchy import jax_inputs, make_grids
from test_model_parity import small_config
from test_torch_train import configs, param_tol

from paths_tpu_torch import convert
from paths_tpu_torch.config import Config, PATHSProcessorConfig
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.data.synthetic import make_signal_metadata, make_signal_store
from paths_tpu_torch.engine.auto import estimate_fused_batch_bytes, resolve_engine
from paths_tpu_torch.models.batch import seq_block_width
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.train import loop as tloop
from paths_tpu_torch.train import state as tstate

STEP_IDX = list(range(6))
STEP_LABELS = {"survival_bin": [1, 3, 0, 2, 2, 1], "censored": [0, 1, 0, 0, 1, 0],
               "weight": [1, 1, 1, 1, 1, 1]}
KERNEL = "pallas"   # the kernel route; the kernels' plain versions on the CPU
ROUTES = [("xla", "gathered"), (KERNEL, "gathered"), (KERNEL, "ring")]
MESHES = ([1, 4], [2, 2])
RUNS = {  # name -> config changes of the [1, 2] training runs
    "ring": {"attention_impl": KERNEL, "seq_attention": "ring"},
    "streaming": {"attention_impl": KERNEL, "seq_attention": "ring",
                  "engine": "streaming"},
    "remat": {"attention_impl": KERNEL, "seq_attention": "ring",
              "remat": True},
    "dropout": {"attention_impl": KERNEL, "num_epochs": 1,
                "mc": {"dropout": 0.05}}}


def _model_dir(path, tcfg, params):
    tcfg.save(path)
    jstate.save_state(path, params)
    return path


def _level0_case(tmp):
    """test_patch_sharding's case with the LSTM: 2 slides, n0 = 8, so at
    sp 4 a block is 3 rows and the last rank holds only padding. Writes the
    port's config per mesh, JAX's parameters and the inputs."""
    jcfg = small_config(lstm=True)
    rng = np.random.default_rng(0)
    dims = [(2, 4), (4, 8), (8, 16)]
    slides = [make_grids(rng, dims, jcfg.model_config.patch_embed_dim,
                         bg_fraction=0.0) for _ in range(2)]
    bag0, tables = jax_inputs(slides, jcfg)
    params = recursive_init(jax.random.PRNGKey(0), jcfg)
    flat = os.path.join(tmp, "level0_params.npz")
    np.savez(flat, **{k: np.asarray(v)
                      for k, v in jstate._flatten(params).items()})
    arrays = {"fts": bag0.fts, "locs": bag0.locs, "mask": bag0.mask,
              "parent": bag0.parent_inds, "ctx_slide": bag0.ctx_slide,
              "ctx_patch": bag0.ctx_patch,
              "label_survival_bin": np.array([1, 0]),
              "label_censored": np.array([0, 1])}
    for i, t in enumerate(tables):
        arrays.update({f"t{i}_{f.name}": getattr(t, f.name)
                       for f in dataclasses.fields(t)})
    arrays = {k: (np.asarray(v).astype(np.int64)
                  if np.issubdtype(np.asarray(v).dtype, np.integer)
                  else np.asarray(v)) for k, v in arrays.items()}
    inputs = os.path.join(tmp, "level0_inputs.npz")
    np.savez(inputs, **arrays)
    dirs = {}
    for ms in MESHES:
        d = os.path.join(tmp, "level0_" + "x".join(map(str, ms)))
        Config(model_config=PATHSProcessorConfig(
            **dataclasses.asdict(jcfg.model_config)),
            num_levels=3, top_k_patches=[2, 2], nbins=4, task="survival",
            mesh_shape=ms).save(d)
        dirs[tuple(ms)] = d
    labels = {"survival_bin": jnp.asarray([1, 0]),
              "censored": jnp.asarray([0, 1])}
    return {"jcfg": jcfg, "params": params, "bag0": bag0, "tables": tables,
            "labels": labels, "flat": flat, "inputs": inputs, "dirs": dirs}


def _jax_level0(case):
    """JAX's level 0 over make_mesh_2d for each mesh and route, and its
    whole-recursion loss."""
    jcfg, params, bag0 = case["jcfg"], case["params"], case["bag0"]
    want = {}
    fa.INTERPRET = True
    try:
        for ms in MESHES:
            mesh = make_mesh_2d(*ms)
            p, b = j_replicate(mesh, params), j_shard_bag_patches(mesh, bag0)
            for impl, schedule in ROUTES:
                cfg = dataclasses.replace(jcfg, attention_impl=impl,
                                          seq_attention=schedule)
                seq = JSeqSharding(mesh, impl=schedule)
                out = jax.jit(lambda p, b, cfg=cfg, seq=seq: j_recursive_apply(
                    p, cfg, 0, b, seq_mesh=seq))(p, b)
                want[(tuple(ms), impl, schedule)] = {
                    "logits": np.asarray(out["logits"]),
                    "importance": np.asarray(out["importance"])}
    finally:
        fa.INTERPRET = False
    loss, _ = j_end2end_loss(params, jcfg, bag0, case["tables"],
                             case["labels"])
    return want, float(loss)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """The stores, the initial weights, every rank's results, and JAX's."""
    tmp = str(tmp_path_factory.mktemp("torch_seq"))
    jcfg, tcfg = configs(tmp)
    ids, z = make_signal_store(tcfg.preprocess_dir, tcfg, num_slides=12,
                               base_hw=(3, 3), seed=0)
    make_signal_metadata(tcfg.csv_path, ids, z, seed=0)
    params = jax.tree_util.tree_map(
        np.asarray, recursive_init(jax.random.PRNGKey(5), jcfg))
    case = _level0_case(tmp)

    dirs = {}
    for name, changes in [("step12", {"attention_impl": KERNEL}),
                          ("step22", {"attention_impl": KERNEL,
                                      "seq_attention": "ring"})] + list(
            RUNS.items()):
        ms = [2, 2] if name == "step22" else [1, 2]
        _, c = configs(tmp, mesh_shape=ms, **changes)
        dirs[name] = _model_dir(os.path.join(tmp, f"seq_{name}"), c, params)
    step = lambda name: {"kind": "step", "name": name,  # noqa: E731
                         "dir": dirs[name], "ids": ids, "idx": STEP_IDX,
                         "labels": STEP_LABELS, "grads": True}
    level0 = lambda ms, **kw: {  # noqa: E731
        "kind": "level0", "name": "level0_" + "x".join(map(str, ms)),
        "dir": case["dirs"][tuple(ms)], "params": case["flat"],
        "inputs": case["inputs"], "routes": ROUTES, **kw}
    fresh = _fresh_case(tmp)
    jobs2 = [step("step12")] + fresh["jobs"] + [
        {"kind": "train", "name": name, "dir": dirs[name]} for name in RUNS
    ] + [{"kind": "evaluate", "name": "evaluate", "dir": dirs["ring"]}]
    jobs4 = [level0([1, 4]), level0([2, 2], tables=True), step("step22")]
    ranks = {}
    thread = threading.Thread(target=lambda: ranks.update(zip((2, 4), launch(
        (2, jobs2, os.path.join(tmp, "out2")),
        (4, jobs4, os.path.join(tmp, "out4"))))))
    thread.start()

    # JAX meanwhile: level 0 on both meshes, and the [2, 4] trajectory
    want_level0, want_loss = _jax_level0(case)
    fresh["jax"] = _jax_fresh(fresh)
    jring = dataclasses.replace(jcfg, mesh_shape=[2, 4])
    d = _model_dir(os.path.join(tmp, "jax_24"), tcfg, params)
    splits = jdata.load_splits([0.7, 0.15, 0.15], jring.seed, jring)
    jstats = jloop.train_loop(jring, d, *splits, verbose=False)
    thread.join()
    assert sorted(ranks) == [2, 4], "the ranks did not finish"
    return {"tmp": tmp, "ids": ids, "params": params, "tcfg": tcfg,
            "fresh": fresh,
            "dirs": dirs, "ranks": ranks, "case": case,
            "want_level0": want_level0, "want_loss": want_loss,
            "jstats": jstats}


FRESH_IDX = [0, 1]
FRESH_LABELS = {"survival_bin": [1, 3], "censored": [0, 1], "weight": [1, 1]}
GRAD_RTOL = 1e-4


def _fresh_case(tmp):
    """The fresh-weights case: 4 signal slides of 24 x 24 level-0 patches
    (every cell tissue; bags of 576 patches in 768 rows), the model
    directories of the ring step under [1, 2] in f32 and in f64 from
    `fresh_model(config, 0)`, and their rank jobs."""
    from paths_tpu_torch.models.jax_init import fresh_model

    base = dict(level0_bucket=256, preprocess_dir=os.path.join(tmp, "fresh"),
                csv_path=os.path.join(tmp, "fresh.csv"))
    _, c = configs(tmp, **base)
    ids, z = make_signal_store(c.preprocess_dir, c, num_slides=4,
                               base_hw=(24, 24), seed=0, tissue_fraction=1.0,
                               size_jitter=1)
    make_signal_metadata(c.csv_path, ids, z, seed=0)
    model = fresh_model(c, 0)
    dirs, jobs = {}, []
    for dt in ("float32", "float64"):
        _, c = configs(tmp, mesh_shape=[1, 2], attention_impl=KERNEL,
                       seq_attention="ring", compute_dtype=dt, table_dtype=dt,
                       **base)
        dirs[dt] = os.path.join(tmp, f"fresh_{dt}")
        c.save(dirs[dt])
        tstate.save_state(dirs[dt], model)
        jobs.append({"kind": "step", "name": f"fresh_{dt}", "dir": dirs[dt],
                     "ids": ids, "idx": FRESH_IDX, "labels": FRESH_LABELS,
                     "grads": True})
    return {"ids": ids, "base": base, "dirs": dirs, "jobs": jobs,
            "flat": convert.to_jax_flat(model)}


def _jax_fresh(fresh):
    """JAX's f32 gradients of the fresh case's batch from the same weights:
    one device, and the ring over make_mesh_2d(1, 2)."""
    from paths_tpu.parallel.mesh import shard_train_batch
    from paths_tpu.serve import serving_dataset
    from paths_tpu.train.state import _unflatten

    jcfg, _ = configs("/nonexistent", attention_impl=KERNEL, **fresh["base"])
    params = _unflatten(recursive_init(jax.random.PRNGKey(0), jcfg),
                        fresh["flat"])
    jds = serving_dataset(jcfg, JStore(jcfg.preprocess_dir), fresh["ids"])
    bag, tables, _ = jdata.collate_batch(jds, FRESH_IDX, level0_bucket=256)
    labels = {k: jnp.asarray(np.asarray(v, np.float32 if k == "weight"
                                        else np.int32))
              for k, v in FRESH_LABELS.items()}
    out = {}
    fa.INTERPRET = True
    try:
        for name, ms in (("one", None), ("ring", [1, 2])):
            seq, args = None, (params, bag, tables, labels)
            if ms is not None:
                mesh = make_mesh_2d(*ms)
                seq = JSeqSharding(mesh, impl="ring")
                args = (j_replicate(mesh, params),
                        *shard_train_batch(mesh, bag, tables, labels))
            grads = jax.jit(jax.grad(
                lambda p, b, t, lab, seq=seq: j_end2end_loss(
                    p, jcfg, b, t, lab, seq_mesh=seq)[0]))(*args)
            out[name] = {k: np.asarray(v)
                         for k, v in jstate._flatten(grads).items()}
    finally:
        fa.INTERPRET = False
    return out


def _arrays(seq, name, rank, world):
    with np.load(os.path.join(seq["tmp"], f"out{world}",
                              f"{name}_rank{rank}.npz")) as f:
        return dict(f)


def _same_on_every_rank(seq, name, world, prefix=""):
    """Rank 0's arrays (those under `prefix`), after checking every other
    rank holds the same bits."""
    first = _arrays(seq, name, 0, world)
    for r in range(1, world):
        other = _arrays(seq, name, r, world)
        for k, v in first.items():
            if k.startswith(prefix):
                np.testing.assert_array_equal(other[k], v,
                                              err_msg=f"rank {r} {k}")
    return first


@pytest.mark.parametrize("route", ROUTES, ids=["-".join(r) for r in ROUTES])
@pytest.mark.parametrize("ms", MESHES, ids=["1x4", "2x2"])
def test_level0_matches_jax(seq, ms, route):
    """Each rank's logits (the whole bag's, sent from sequence index 0) and
    gathered importance against JAX's level 0 on the same mesh: the rows of
    the rank's data index."""
    impl, schedule = route
    world, dp = ms[0] * ms[1], ms[0]
    want = seq["want_level0"][(tuple(ms), impl, schedule)]
    atol = 1e-5 if impl == "xla" else 2e-5
    name, key = "level0_" + "x".join(map(str, ms)), f"{impl}_{schedule}"
    b = want["logits"].shape[0]
    for r in range(world):
        got = _arrays(seq, name, r, world)
        rows = slice((r // ms[1]) * b // dp, (r // ms[1] + 1) * b // dp)
        np.testing.assert_allclose(got[f"{key}_logits"],
                                   want["logits"][rows], atol=atol)
        np.testing.assert_allclose(got[f"{key}_importance"],
                                   want["importance"][rows], atol=atol)


@pytest.mark.parametrize("route", ROUTES, ids=["-".join(r) for r in ROUTES])
def test_end2end_loss_matches_jax(seq, route):
    """`end2end_loss` through all 3 levels under [2, 2]: the two data
    indices' losses (each over the global batch's weight) add up to JAX's."""
    impl, schedule = route
    key = f"{impl}_{schedule}_loss"
    ranks = [r["level0_2x2"] for r in seq["ranks"][4]]
    got = sum(r[key] for r in ranks if r["seq_index"] == 0)
    assert ranks[0][key] == ranks[1][key] and ranks[2][key] == ranks[3][key]
    np.testing.assert_allclose(got, seq["want_loss"], rtol=1e-5)


def _one_process_step(seq):
    """The port's one-process AdamW step on the whole 6-slide batch."""
    tcfg = seq["tcfg"]
    model = convert.from_jax_flat(jstate._flatten(seq["params"]), tcfg)
    opt = tloop.make_optimizer(tcfg, model.parameters())
    ds = tdata.SlideDataset(seq["ids"], tcfg, FeatureStore(tcfg.preprocess_dir))
    bag, tables = tdata.collate_batch(ds, STEP_IDX, level0_bucket=32,
                                      device="cpu")
    labels = {k: torch.from_numpy(np.asarray(v))
              for k, v in STEP_LABELS.items()}
    labels["weight"] = labels["weight"].float()
    loss, _ = tloop.make_step_fns(tcfg, opt)[0](model, bag, tables, labels,
                                                 epoch=1)
    grads = {"grad/" + n: p.grad.numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss), {**convert.to_jax_flat(model), **grads}


@pytest.mark.parametrize("name,world", [("step12", 2), ("step22", 4)])
def test_update_step_matches_one_process(seq, name, world):
    """One AdamW step on a 6-slide batch: gathered schedule under [1, 2],
    ring under [2, 2]. The data indices' losses add up to one process's, the
    world's gradients and the stepped parameters agree with one process's,
    and every rank holds the same bits."""
    want_loss, want = _one_process_step(seq)
    ranks = [r[name] for r in seq["ranks"][world]]
    np.testing.assert_allclose(
        sum(r["loss"] for r in ranks if r["seq_index"] == 0), want_loss,
        rtol=1e-6)
    got = _same_on_every_rank(seq, name, world)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = (param_tol(k, seq["tcfg"], 1) if k.endswith(("/k/b", "k.bias"))
                else 1e-6)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


def test_train_loop_matches_jax_2x4(seq):
    """Two epochs of `train_loop` under [1, 2] on the ring schedule against
    JAX's `mesh_shape` [2, 4] run from the same weights (JAX's own bar)."""
    got = seq["ranks"][2][0]["ring"]["train_loss"]
    assert seq["ranks"][2][1]["ring"] == seq["ranks"][2][0]["ring"]
    for e in (1, 2):
        np.testing.assert_allclose(got[str(e)], seq["jstats"]["train_loss"][e],
                                   rtol=5e-4)
    _same_on_every_rank(seq, "ring", 2)


@pytest.mark.parametrize("name", ["streaming", "remat"])
def test_streaming_and_remat_match_fused(seq, name):
    """The streaming engine and remat under [1, 2] give the fused run's
    losses (train and val) and parameters, on every rank."""
    want = seq["ranks"][2][0]["ring"]
    got = seq["ranks"][2][0][name]
    assert seq["ranks"][2][1][name] == got
    for key in ("train_loss", "val_loss"):
        assert sorted(got[key]) == sorted(want[key])
        for e in want[key]:
            np.testing.assert_allclose(got[key][e], want[key][e], rtol=1e-6,
                                       err_msg=f"{key} {e}")
    params = _same_on_every_rank(seq, name, 2)
    ref = _arrays(seq, "ring", 0, 2)
    for k, v in ref.items():
        atol = param_tol(k, seq["tcfg"], 4) if k.endswith("/k/b") else 1e-6
        np.testing.assert_allclose(params[k], v, rtol=0, atol=atol,
                                   err_msg=k)


def test_dropout_ranks_agree(seq):
    """At the published dropout 0.05 (the plain route: attention dropout
    exists there only) the ranks of the group draw the same masks from their
    data index's stream, so their parameters stay equal to the bit."""
    got = seq["ranks"][2][0]["dropout"]
    assert seq["ranks"][2][1]["dropout"] == got
    assert np.isfinite(got["train_loss"]["1"])
    assert got["train_loss"]["1"] != seq["ranks"][2][0]["ring"]["train_loss"]["1"]
    _same_on_every_rank(seq, "dropout", 2)


def test_cli_evaluate_under_1x2(seq, capsys):
    """`cli.evaluate` under [1, 2] gives one process's metrics over the same
    checkpoint (the c-index exactly, the loss within 1e-6)."""
    from paths_tpu_torch.cli.evaluate import main

    ranks = [r["evaluate"] for r in seq["ranks"][2]]
    assert ranks[0] == ranks[1]
    d = os.path.join(seq["tmp"], "evaluate_one")
    c = Config.load(seq["dirs"]["ring"])
    c.mesh_shape = None
    c.save(d)
    tstate.save_state(d, tstate.load_model(seq["dirs"]["ring"],
                                           RecursiveModel(c)))
    want = main(["-m", d, "--split", "test", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == want
    assert sorted(ranks[0]) == sorted(want)
    assert ranks[0]["test_c-index"] == want["test_c-index"]
    np.testing.assert_allclose(ranks[0]["test_loss"], want["test_loss"],
                               rtol=1e-6)


def test_engine_auto_prices_a_sequence_ranks_share(seq):
    """Under sp = 2 a rank prices m = ceil((n0 + 1) / 2) level-0 rows, plus
    the gathered schedule's K and V of the whole sequence, so a card that
    cannot hold one process's fused batch holds a sequence rank's share."""
    _, auto = configs(seq["tmp"], engine="auto", level0_bucket=4096)
    ds = tdata.load_splits([0.7, 0.15, 0.15], auto.seed, auto)[0]
    pads = ds.global_pads()
    whole = estimate_fused_batch_bytes(auto, pads, 4)
    share = {impl: estimate_fused_batch_bytes(
        dataclasses.replace(auto, seq_attention=impl), pads, 4, sp=2)
        for impl in ("gathered", "ring")}
    mc = auto.model_config
    assert seq_block_width(4096, 2) == 2049
    assert (share["gathered"] - share["ring"]
            == 4 * 2 * 2 * 2049 * mc.trans_dim * 4 * mc.trans_layers)
    assert share["ring"] < whole
    hbm = int(((3.0 * share["gathered"] + 3.0 * whole) / 2 + (512 << 20))
              / 0.85)
    assert resolve_engine(auto, pads, 4, hbm=hbm, verbose=False,
                          sp=2) == "fused"
    assert resolve_engine(auto, pads, 4, hbm=hbm, verbose=False) == "streaming"


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_collated_block_is_the_whole_bags_block(seq, sp):
    """`collate_bag0(seq=(s, sp))` collates exactly rank s's block of the
    whole bag (`shard_bag_patches`): the special token's masked row on rank
    0, patch s m + j - 1 in row j, masked zero rows past the last patch."""
    from paths_tpu_torch.models.batch import shard_bag_patches

    ds = tdata.SlideDataset(seq["ids"], seq["tcfg"],
                            FeatureStore(seq["tcfg"].preprocess_dir))
    idx = [0, 3, 5]
    whole = tdata.collate_bag0(ds, idx, level0_bucket=32, device="cpu")
    n = whole.fts.shape[1]
    for s in range(sp):
        got = tdata.collate_bag0(ds, idx, level0_bucket=32, device="cpu",
                                 seq=(s, sp))
        want = shard_bag_patches(whole, s, sp)
        assert got.patch_width == want.patch_width == n
        assert got.fts.shape[1] == seq_block_width(n, sp)
        for f in ("fts", "locs", "mask", "parent_inds", "ctx_slide",
                  "ctx_patch"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=0, msg=f)
    assert int(sum(tdata.collate_bag0(ds, idx, level0_bucket=32,
                                      device="cpu", seq=(s, sp)).mask.sum()
                   for s in range(sp))) == int(whole.mask.sum())


def test_mesh_layout_and_schedule_names():
    """Rank r of a [dp, sp] mesh sits at data index r // sp and sequence
    index r % sp and collates its data index's rows; `seq_attention` must
    name a schedule."""
    from paths_tpu_torch.parallel.mesh import ProcessMesh

    mesh = ProcessMesh(rank=5, size=8, seq=4)
    assert (mesh.data_index, mesh.seq_index) == (1, 1)
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.rows(6) == slice(3, 6)
    assert tloop.seq_block(mesh) == (1, 4)
    cfg = Config(model_config=PATHSProcessorConfig())
    assert tloop.dropout_seed(cfg, mesh) == tloop.dropout_seed(
        cfg, ProcessMesh(rank=4, size=8, seq=4))
    assert tloop.dropout_seed(cfg, mesh) != tloop.dropout_seed(
        cfg, ProcessMesh(rank=1, size=8, seq=4))
    with pytest.raises(ValueError, match="gathered"):
        Config(model_config=PATHSProcessorConfig(), seq_attention="allgather")


@pytest.mark.parametrize("index", [0, 1])
def test_dropout_shard_keeps_its_block(index):
    """`nn.core.dropout`'s shard: each rank of a group draws sp masks of its
    block's shape in turn and keeps the one at its sequence index, so the
    group's generators end in the same state and the blocks' masks
    differ."""
    from paths_tpu_torch.nn.core import dropout

    x = torch.ones(2, 3, 5, 7)
    gen = torch.Generator().manual_seed(3)
    got = dropout(x, 0.5, generator=gen, training=True, shard=(index, 2))
    ref = torch.Generator().manual_seed(3)
    draws = [torch.rand(x.shape, generator=ref) < 0.5 for _ in range(2)]
    torch.testing.assert_close(got, torch.where(draws[index], x / 0.5, 0.0),
                               rtol=0, atol=0)
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(gen.get_state(), ref.get_state())


def _grad_ratio(got, want):
    """(worst ratio, tensor) of max |got - want| to GRAD_RTOL of the
    tensor's largest `want` (a key bias: of the model's largest), over the
    tensors of `want` (those absent from `got` must be zero there): the
    card's `chip_smoke.py::grad_mismatch`."""
    scale = max(np.abs(w).max() for w in want.values())
    worst = (0.0, "")
    for k, w in want.items():
        if k not in got:
            assert not np.abs(w).any(), k
            continue
        ref = scale if k.endswith(("k.bias", "/k/b")) else np.abs(w).max()
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        worst = max(worst, (err / (GRAD_RTOL * ref) if ref else 0.0, k))
    return worst


def _fresh_one_process(seq, dt):
    """The port's one-process step of the fresh case in `dt`: gradients by
    parameter name."""
    from paths_tpu_torch.models.jax_init import fresh_model

    fresh = seq["fresh"]
    _, c = configs(seq["tmp"], attention_impl=KERNEL, compute_dtype=dt,
                   table_dtype=dt, **fresh["base"])
    model = fresh_model(c, 0).to(getattr(torch, dt))
    opt = tloop.make_optimizer(c, model.parameters())
    ds = tdata.SlideDataset(fresh["ids"], c, FeatureStore(c.preprocess_dir))
    bag, tables = tdata.collate_batch(ds, FRESH_IDX, level0_bucket=256,
                                      device="cpu")
    labels = {k: torch.tensor(v) for k, v in FRESH_LABELS.items()}
    labels["weight"] = labels["weight"].to(getattr(torch, dt))
    tloop.make_step_fns(c, opt)[0](model, bag, tables, labels, epoch=1)
    return {n: p.grad.numpy() for n, p in model.named_parameters()
            if p.grad is not None}


def test_ring_step_on_fresh_weights_is_f32_rounding(seq):
    """The ring step's gradient gap, on JAX's seed-0 initial weights: the ring
    step under [1, 2] against one process within GRAD_RTOL in f32; the same
    comparison in f64 under 1e-8 of the bar (rounding scale: the f32 gap is
    f32 rounding of the schedule, not a fault); JAX's own ring step parts
    from its one-device step within the bar too, and the port's ring step is
    within the bar of JAX's. Prints the figures."""
    keys = {t: j for t, j in convert.jax_keys(
        convert.from_jax_flat(seq["fresh"]["flat"], seq["tcfg"])).items()}
    ratios = {}
    for dt in ("float32", "float64"):
        want = _fresh_one_process(seq, dt)
        got = {n[len("grad/"):]: v for n, v in _same_on_every_rank(
            seq, f"fresh_{dt}", 2, "grad/").items() if n.startswith("grad/")}
        ratios[dt] = _grad_ratio(got, want)
    jax_grads = seq["fresh"]["jax"]
    tk = {j: t for t, j in keys.items()}
    by_name = lambda g: {tk[k]: (v.T if k.endswith("/w") else v)  # noqa: E731
                         for k, v in g.items() if k in tk}
    ratios["jax ring vs jax one"] = _grad_ratio(by_name(jax_grads["ring"]),
                                                by_name(jax_grads["one"]))
    port_ring = {n[len("grad/"):]: v for n, v in _arrays(
        seq, "fresh_float32", 0, 2).items() if n.startswith("grad/")}
    ratios["port ring vs jax ring"] = _grad_ratio(
        port_ring, by_name(jax_grads["ring"]))
    print("ring step on fresh_model weights, worst gradient as a share of "
          f"GRAD_RTOL: {ratios}")
    assert ratios["float32"][0] <= 1.0
    assert ratios["float64"][0] <= 1e-8
    assert ratios["jax ring vs jax one"][0] <= 1.0
    assert ratios["port ring vs jax ring"][0] <= 1.0
