"""The bf16 configuration (`compute_dtype` and `table_dtype` "bfloat16")
across processes: the port's `[dp]` and `[dp, sp]` meshes (gloo ranks started
with torchrun's environment, `tests/helpers_torch_dp.py`) against JAX's bf16
programs partitioned over `make_mesh` / `make_mesh_2d` on the suite's virtual
CPU devices. Weights cross over in the `model.npz` layout; widths are small
(32-d features, `trans_dim` 64 over 2 heads of 32), 3 levels and 5.

JAX runs as `tests/test_torch_bf16.py`'s `strict` compiles it (XLA's excess
precision off: every bf16 result rounded), except the package's own
`train_loop`, which is jitted as users run it (JIT_BAR).

Where a partitioned program rounds. XLA's CPU backend sums a bf16 all-reduce
in f32 and rounds the sum once (the all-reduce of a weight's bf16 partial
products sits before the convert to the f32 parameter); the port's repairs
put its sums there too (`parallel/mesh.py::all_reduce_grads` with
`models/recursive.py::narrow_params`; `parallel/seq_attention.py`'s group
sums in f32), and the two op cases below hold both to the bit. Past those,
GSPMD splits level 0's per-patch work over the patches while the port splits
the sequence [special token, patches] into blocks, so a weight's partial
products are cut at other rows and round apart: the whole model is held to
bars, not bits.

Bars, in u = 2^-8 (bf16's unit roundoff), as `tests/test_torch_bf16.py`
sets them and for the same reasons:

* FWD_BAR 4u: level-0 logits of their largest, importances absolute,
  losses relative.
* GRAD_BAR 12u of each gradient's `_scale` (its own largest; a key bias's,
  zero in exact arithmetic, the model's; another bias's, its layer's), plus
  the tensor's spread between JAX's own programs of the same step: JAX's
  [2], [1, 2] and [2, 2] programs part by up to four GRAD_BARs, and its
  5-level [1, 2] and one-device programs by up to ten, at the levels that
  GSPMD also splits over the model axis where the port runs them whole on
  each rank, so the partial products round on other rows. A difference JAX
  shows between two of its meshes is not the port's.
* AdamW's first step moves an element by about lr whatever its gradient's
  size: the stepped parameters are held to 2 lr and 2 f32 ulps (an element
  whose gradient sign is rounding noise may move either way; each package
  rounds its update once), and every element whose JAX gradient exceeds its
  bar moves in JAX's direction.
* JIT_BAR 8u relative on `train_loop`'s epoch losses against JAX's jitted
  [2, 4] run.
* The streaming engine and remat equal the fused run to the bit;
  `cli.evaluate` under [1, 2] equals one process to FWD_BAR (its c-index
  exactly); the 5-level f32 ring step's gradients are within GRAD_RTOL
  (1e-4) of each tensor's largest of one process's step.
"""
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from helpers_torch_dp import launch
from paths_tpu.data import dataset as jdata
from paths_tpu.data.feature_store import FeatureStore as JStore
from paths_tpu.engine import hierarchy as jh
from paths_tpu.models.recursive import recursive_apply as j_recursive_apply
from paths_tpu.models.recursive import recursive_init
from paths_tpu.parallel.mesh import make_mesh, make_mesh_2d, shard_train_batch
from paths_tpu.parallel.mesh import replicate as j_replicate
from paths_tpu.parallel.mesh import shard_bag_patches as j_shard_bag_patches
from paths_tpu.parallel.seq_attention import SeqSharding as JSeqSharding
from paths_tpu.serve import serving_dataset
from paths_tpu.train import loop as jloop
from paths_tpu.train import state as jstate
from test_torch_bf16 import BF16, FWD_BAR, GRAD_BAR, JIT_BAR, strict, within
from test_torch_train import configs

from paths_tpu_torch import convert
from paths_tpu_torch.config import Config
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.data.synthetic import make_signal_metadata, make_signal_store
from paths_tpu_torch.train import state as tstate

WIDE = {"trans_dim": 64, "trans_heads": 2}   # head_dim 32, as the flagship's
GRAD_RTOL = 1e-4
KERNEL = "pallas"   # the kernel route; the kernels' plain versions on the CPU
STEP_IDX = list(range(6))
STEP_LABELS = {"survival_bin": [1, 3, 0, 2, 2, 1], "censored": [0, 1, 0, 0, 1, 0],
               "weight": [1, 1, 1, 1, 1, 1]}
STEP5_IDX = list(range(4))
STEP5_LABELS = {k: v[:4] for k, v in STEP_LABELS.items()}
# name -> (mesh_shape, seq_attention) of the one-step cases at 3 levels
STEPS = {"dp2": ([2], "gathered"), "seq12": ([1, 2], "gathered"),
         "seq22": ([2, 2], "ring")}
LEVEL0 = {"1x4": [1, 4], "2x2": [2, 2]}
SCHEDULES = ("gathered", "ring")
RUNS = {  # name -> config changes of the [1, 2] bf16 training runs (ring)
    "ring": {}, "streaming": {"engine": "streaming"}, "remat": {"remat": True}}


def _cfgs(tmp, store="store", **kw):
    """Both packages' configs at WIDE widths on `store`."""
    return configs(tmp, mc=WIDE, preprocess_dir=os.path.join(tmp, store),
                   csv_path=os.path.join(tmp, store + ".csv"), **kw)


def _model_dir(path, tcfg, params):
    tcfg.save(path)
    jstate.save_state(path, params)
    return path


def _jbatch(jcfg, ids, idx, labels):
    """JAX's collated batch of `idx` with the given labels."""
    jds = serving_dataset(jcfg, JStore(jcfg.preprocess_dir), ids)
    bag, tables, _ = jdata.collate_batch(jds, idx, level0_bucket=32)
    return bag, tables, {
        k: jnp.asarray(np.asarray(v, np.float32 if k == "weight" else np.int32))
        for k, v in labels.items()}


def _jax_step(jcfg, params, batch, ms, schedule):
    """JAX's partitioned step, op by op: the loss and gradients over the
    mesh `ms` (sequence-parallel for ms[1] > 1; None: one device), and
    AdamW's update."""
    import optax

    seq, args = None, (params, *batch)
    if ms is not None:
        mesh = make_mesh_2d(*ms) if len(ms) > 1 else make_mesh(ms[0])
        seq = JSeqSharding(mesh, impl=schedule) if len(ms) > 1 else None
        args = (j_replicate(mesh, params), *shard_train_batch(mesh, *batch))
    loss, grads = strict(jax.value_and_grad(
        lambda p, b, t, lab: jh.end2end_loss(p, jcfg, b, t, lab,
                                             seq_mesh=seq)[0]), *args)
    flat = {k: jnp.asarray(v) for k, v in jstate._flatten(params).items()}
    grads = {k: jnp.asarray(v) for k, v in jstate._flatten(grads).items()}
    tx = jloop.make_optimizer(jcfg)
    upd, _ = tx.update(grads, tx.init(flat), flat)
    stepped = optax.apply_updates(flat, upd)
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()},
            {k: np.asarray(v) for k, v in stepped.items()})


def _level0_inputs(tmp, jcfg, ids):
    """The whole level-0 bag of the first 2 slides, as `_level0` reads it
    (f32 arrays; each side casts to bf16)."""
    bag, _, _ = _jbatch(jcfg, ids, [0, 1], {})
    arrays = {"fts": bag.fts, "locs": bag.locs, "mask": bag.mask,
              "parent": bag.parent_inds, "ctx_slide": bag.ctx_slide,
              "ctx_patch": bag.ctx_patch}
    arrays = {k: (np.asarray(v).astype(np.int64)
                  if np.issubdtype(np.asarray(v).dtype, np.integer)
                  else np.asarray(v)) for k, v in arrays.items()}
    path = os.path.join(tmp, "level0_inputs.npz")
    np.savez(path, **arrays)
    return path, bag


def _jax_level0(jcfg, params, bag):
    """JAX's bf16 level 0 over each mesh and schedule, op by op."""
    bf = jnp.bfloat16
    bag = dataclasses.replace(bag, fts=bag.fts.astype(bf),
                              ctx_slide=bag.ctx_slide.astype(bf),
                              ctx_patch=bag.ctx_patch.astype(bf))
    want = {}
    for name, ms in LEVEL0.items():
        mesh = make_mesh_2d(*ms)
        p, b = j_replicate(mesh, params), j_shard_bag_patches(mesh, bag)
        for schedule in SCHEDULES:
            seq = JSeqSharding(mesh, impl=schedule)
            out = strict(lambda p, b, seq=seq: j_recursive_apply(
                p, jcfg, 0, b, seq_mesh=seq), p, b)
            want[name, schedule] = {"logits": np.asarray(out["logits"]),
                                    "importance": np.asarray(
                                        out["importance"].astype(jnp.float32))}
    return want


def _spread(grads):
    """Per tensor, the largest difference between JAX's own programs of one
    step (`grads`: each program's gradients)."""
    return {k: max(np.abs(a[k] - b[k]).max() for a in grads for b in grads)
            for k in grads[0]}


def _op_inputs(tmp):
    """The affine case's x (8 rows a rank of 2), w, b, g, and the sums
    case's (4, 4096) parts, all bf16 values held as f32."""
    rng = np.random.default_rng(11)

    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    affine = {"x": bf(rng.normal(size=(16, 64)) * 2),
              "w": rng.normal(size=(32, 64)).astype(np.float32) / 8,
              "b": rng.normal(size=32).astype(np.float32),
              "g": bf(rng.normal(size=(16, 32)))}
    sums = {"parts": bf(rng.normal(size=(4, 4096)) * np.exp(
        rng.normal(size=(4, 4096))))}
    paths = {}
    for name, arrays in (("affine", affine), ("sums", sums)):
        paths[name] = os.path.join(tmp, f"{name}_inputs.npz")
        np.savez(paths[name], **arrays)
    return paths, affine, sums


def _jax_ops(affine, sums):
    """JAX's partitioned affine gradient over make_mesh(2) and the group
    sums of bf16 parts over make_mesh(4), op by op."""
    from jax import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    bf = jnp.bfloat16
    mesh = make_mesh(2)
    rows = NamedSharding(mesh, P("data"))
    x, g = (jax.device_put(jnp.asarray(affine[k]), rows) for k in "xg")
    w, b = (jax.device_put(jnp.asarray(affine[k]), NamedSharding(mesh, P()))
            for k in "wb")
    dw, db = strict(jax.grad(lambda w, b, x, g: jnp.sum(
        (x.astype(bf) @ w.T.astype(bf) + b.astype(bf)).astype(jnp.float32)
        * g), argnums=(0, 1)), w, b, x, g)
    mesh4 = make_mesh(4)
    parts = jax.device_put(jnp.asarray(sums["parts"]).astype(bf),
                           NamedSharding(mesh4, P("data")))
    total, scattered = strict(shard_map(
        lambda p: (jax.lax.psum(p, "data"),
                   jax.lax.psum_scatter(p[0], "data", tiled=True)),
        mesh=mesh4, in_specs=P("data"), out_specs=(P(), P("data")),
        check_vma=False), parts)
    return {"w": np.asarray(dw), "b": np.asarray(db),
            "sum": np.asarray(total.astype(jnp.float32))[0],
            "scatter": np.asarray(scattered.astype(jnp.float32))}


@pytest.fixture(scope="module")
def seqbf(tmp_path_factory):
    """The stores, the initial weights, every rank's results and JAX's."""
    tmp = str(tmp_path_factory.mktemp("torch_seq_bf16"))
    jcfg, tcfg = _cfgs(tmp, **BF16)
    ids, z = make_signal_store(tcfg.preprocess_dir, tcfg, num_slides=12,
                               base_hw=(4, 4), seed=0)
    make_signal_metadata(tcfg.csv_path, ids, z, seed=0)
    jcfg5, tcfg5 = _cfgs(tmp, "store5", num_levels=5, **BF16)
    ids5, z5 = make_signal_store(tcfg5.preprocess_dir, tcfg5, num_slides=4,
                                 base_hw=(3, 3), seed=1)
    make_signal_metadata(tcfg5.csv_path, ids5, z5, seed=1)
    params = jax.tree_util.tree_map(
        np.asarray, recursive_init(jax.random.PRNGKey(5), jcfg))
    params5 = jax.tree_util.tree_map(
        np.asarray, recursive_init(jax.random.PRNGKey(6), jcfg5))
    ops, affine, sums = _op_inputs(tmp)
    l0_inputs, l0_bag = _level0_inputs(
        tmp, _cfgs(tmp)[0], ids)

    dirs = {}
    for name, (ms, schedule) in STEPS.items():
        _, c = _cfgs(tmp, mesh_shape=ms, attention_impl=KERNEL,
                     seq_attention=schedule, **BF16)
        dirs[name] = _model_dir(os.path.join(tmp, f"step_{name}"), c, params)
    for name, changes in RUNS.items():
        _, c = _cfgs(tmp, mesh_shape=[1, 2], attention_impl=KERNEL,
                     seq_attention="ring", **changes, **BF16)
        dirs[name] = _model_dir(os.path.join(tmp, f"run_{name}"), c, params)
    for dt, fields in (("f32", {}), ("bf16", BF16)):
        _, c = _cfgs(tmp, "store5", num_levels=5, mesh_shape=[1, 2],
                     attention_impl=KERNEL, seq_attention="ring", **fields)
        dirs[f"five_{dt}"] = _model_dir(os.path.join(tmp, f"five_{dt}"), c,
                                        params5)
    for name, ms in LEVEL0.items():
        d = os.path.join(tmp, f"level0_{name}")
        _cfgs(tmp, mesh_shape=ms, **BF16)[1].save(d)
        dirs[f"level0_{name}"] = d
    flat = os.path.join(tmp, "params.npz")
    np.savez(flat, **jstate._flatten(params))

    def step(name, d, ids, idx, labels):
        return {"kind": "step", "name": name, "dir": d, "ids": ids,
                "idx": idx, "labels": labels, "grads": True}

    jobs2 = [{"kind": "affine", "name": f"affine_{n}", "inputs": ops["affine"],
              "narrow": n == "narrow"} for n in ("narrow", "wide")]
    jobs2 += [step(n, dirs[n], ids, STEP_IDX, STEP_LABELS)
              for n in ("dp2", "seq12")]
    jobs2 += [step(f"five_{dt}", dirs[f"five_{dt}"], ids5, STEP5_IDX,
                   STEP5_LABELS) for dt in ("f32", "bf16")]
    jobs2 += [{"kind": "train", "name": n, "dir": dirs[n]} for n in RUNS]
    jobs2 += [{"kind": "evaluate", "name": "evaluate", "dir": dirs["ring"]}]
    jobs4 = [{"kind": "sums", "name": "sums", "inputs": ops["sums"]},
             step("seq22", dirs["seq22"], ids, STEP_IDX, STEP_LABELS)]
    jobs4 += [{"kind": "level0", "name": f"level0_{n}",
               "dir": dirs[f"level0_{n}"], "params": flat,
               "inputs": l0_inputs,
               "routes": [(KERNEL, s) for s in SCHEDULES]} for n in LEVEL0]
    ranks = {}
    thread = threading.Thread(target=lambda: ranks.update(zip((2, 4), launch(
        (2, jobs2, os.path.join(tmp, "out2")),
        (4, jobs4, os.path.join(tmp, "out4"))))))
    thread.start()

    # JAX meanwhile, its programs on a pool of threads (XLA compiles and runs
    # with the interpreter's lock released)
    jk = dataclasses.replace(jcfg, attention_impl=KERNEL)
    j5 = dataclasses.replace(jcfg5, attention_impl=KERNEL)
    jring = dataclasses.replace(jk, mesh_shape=[2, 4], seq_attention="ring")

    def train():
        d = _model_dir(os.path.join(tmp, "jax_24"), tcfg, params)
        splits = jdata.load_splits([0.7, 0.15, 0.15], jring.seed, jring)
        return jloop.train_loop(jring, d, *splits, verbose=False)

    batch = _jbatch(jk, ids, STEP_IDX, STEP_LABELS)
    b5 = _jbatch(j5, ids5, STEP5_IDX, STEP5_LABELS)
    tasks = {name: (_jax_step, jk, params, batch, ms, schedule)
             for name, (ms, schedule) in STEPS.items()}
    tasks.update({"five_bf16": (_jax_step, j5, params5, b5, [1, 2], "ring"),
                  "five_one": (_jax_step, j5, params5, b5, None, None),
                  "level0": (_jax_level0, jk, params, l0_bag),
                  "ops": (_jax_ops, affine, sums), "train": (train,)})
    fa.INTERPRET = True
    try:
        with ThreadPoolExecutor(4) as pool:
            futures = {n: pool.submit(*t) for n, t in tasks.items()}
            want = {n: f.result() for n, f in futures.items()}
    finally:
        fa.INTERPRET = False
    spread = _spread([want[n][1] for n in STEPS])
    want["spread"] = {n: spread for n in STEPS}
    want["spread"]["five_bf16"] = _spread([want["five_bf16"][1],
                                           want.pop("five_one")[1]])
    thread.join()
    assert sorted(ranks) == [2, 4], "the ranks did not finish"
    flat3, flat5 = jstate._flatten(params), jstate._flatten(params5)
    return {"tmp": tmp, "ranks": ranks, "want": want, "dirs": dirs,
            "ids5": ids5, "params5": params5,
            "flat": {n: flat5 if n.startswith("five") else flat3
                     for n in dirs}}


def _arrays(seqbf, name, rank, world):
    with np.load(os.path.join(seqbf["tmp"], f"out{world}",
                              f"{name}_rank{rank}.npz")) as f:
        return dict(f)


def _same_on_every_rank(seqbf, name, world):
    """Rank 0's arrays, after checking every rank holds the same bits."""
    first = _arrays(seqbf, name, 0, world)
    for r in range(1, world):
        other = _arrays(seqbf, name, r, world)
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=f"rank {r} {k}")
    return first


# ------------------------------------------------------ the repaired sums

def test_weight_gradient_sum_rounds_as_jax(seqbf):
    """A bf16 affine map's weight gradient summed over [2]: with the sum
    rounded to bf16 (`all_reduce_grads`' `narrow`) equal to the bit to JAX's
    partitioned program; a rank's f32 sum left unrounded differs from it on
    most elements. The bias's cotangent JAX sums over the rows in bf16, the
    port in f32 (`tests/test_torch_bf16.py::test_bf16_ops_round_as_jax`):
    within GRAD_BAR."""
    want = seqbf["want"]["ops"]
    got = _same_on_every_rank(seqbf, "affine_narrow", 2)
    np.testing.assert_array_equal(got["w"], want["w"])
    within(got["b"], want["b"], GRAD_BAR, "bias gradient")
    unrounded = _arrays(seqbf, "affine_wide", 0, 2)["w"]
    share = float((unrounded != want["w"]).mean())
    print(f"unrounded sum: {share:.3f} of the weight gradient differs")
    assert share > 0.25


def test_group_sums_of_bf16_round_as_jax(seqbf):
    """The sequence group's sums of bf16 partials over 4 ranks (`sum_`,
    `reduce_` into index 0, `scatter_sum`) equal JAX's `psum` /
    `psum_scatter` op by op to the bit: summed in f32 and rounded once
    (gloo alone would round after every add)."""
    want = seqbf["want"]["ops"]
    n = want["scatter"].shape[0] // 4
    for r in range(4):
        got = _arrays(seqbf, "sums", r, 4)
        np.testing.assert_array_equal(got["sum"], want["sum"])
        np.testing.assert_array_equal(got["scatter"],
                                      want["scatter"][r * n:(r + 1) * n])
        if r == 0:
            np.testing.assert_array_equal(got["reduce"], want["sum"])


# ------------------------------------------------------------- level 0

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", list(LEVEL0))
def test_level0_bf16_matches_jax(seqbf, name, schedule):
    """Each rank's level-0 logits (the whole bag's) and gathered importance
    in bf16 against JAX's partitioned level 0 on the same mesh, op by op:
    the rows of the rank's data index, to FWD_BAR."""
    ms = LEVEL0[name]
    want = seqbf["want"]["level0"][name, schedule]
    b, dp = want["logits"].shape[0], ms[0]
    for r in range(ms[0] * ms[1]):
        got = _arrays(seqbf, f"level0_{name}", r, ms[0] * ms[1])
        rows = slice((r // ms[1]) * b // dp, (r // ms[1] + 1) * b // dp)
        within(got[f"{KERNEL}_{schedule}_logits"], want["logits"][rows],
               FWD_BAR, f"rank {r} logits")
        within(got[f"{KERNEL}_{schedule}_importance"],
               want["importance"][rows], FWD_BAR, f"rank {r} importance",
               absolute=True)


def test_end2end_loss_bf16_under_2x2(seqbf):
    """`end2end_loss` through 3 levels under [2, 2] (ring) in bf16, from the
    step's forward: the ranks of a data index agree to the bit, and the two
    data indices' losses (each over the global batch's weight) add up to
    JAX's partitioned loss within FWD_BAR."""
    ranks = [r["seq22"] for r in seqbf["ranks"][4]]
    assert [r["seq_index"] for r in ranks] == [0, 1, 0, 1]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert ranks[2]["loss"] == ranks[3]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"] + ranks[2]["loss"],
                               seqbf["want"]["seq22"][0], rtol=FWD_BAR)


# ------------------------------------------------------------ one step

def _scale(grads, k, model_max):
    """What a gradient's bar is a share of: its own largest value; a key
    bias's, the model's largest (zero in exact arithmetic); another bias's,
    its layer's largest (weight or bias): the bias's cotangent is a sum over
    every row of the level, which JAX takes in bf16 arithmetic and the port
    in f32 (`tests/test_torch_bf16.py::test_bf16_ops_round_as_jax`), and
    where the rows cancel, its own value says nothing of that sum's
    rounding, while the weight's products over the same cotangents do."""
    if k.endswith("/k/b"):
        return model_max
    own = np.abs(grads[k]).max()
    if k.endswith("/b") and k[:-1] + "w" in grads:
        return max(own, np.abs(grads[k[:-1] + "w"]).max())
    return own


def _hold_step(seqbf, name, world, grad_bar):
    """The data indices' losses against JAX's loss (FWD_BAR relative), the
    world's gradients against JAX's partitioned gradients (`grad_bar` of
    each gradient's `_scale`, plus in bf16 the tensor's spread between
    JAX's own programs of the step), the
    stepped parameters within 2 lr (and 2 f32 ulps) of JAX's AdamW step
    and, where JAX's
    gradient exceeds its bar, moved in JAX's direction; every rank the same
    bits. Prints the worst gradient."""
    from paths_tpu_torch.models.recursive import RecursiveModel

    jl, jgrads, jstepped = seqbf["want"][name]
    ranks = [r[name] for r in seqbf["ranks"][world]]
    np.testing.assert_allclose(
        sum(r["loss"] for r in ranks if r["seq_index"] == 0), jl,
        rtol=FWD_BAR)
    got = _same_on_every_rank(seqbf, name, world)
    cfg = Config.load(seqbf["dirs"][name])
    keys = convert.jax_keys(RecursiveModel(cfg))   # torch name -> JAX key
    grads = {keys[n[len("grad/"):]]: v for n, v in got.items()
             if n.startswith("grad/")}
    grads = {k: v.T if k.endswith("/w") else v for k, v in grads.items()}
    start = seqbf["flat"][name]
    spread = seqbf["want"]["spread"].get(name, {})
    model_max = max(np.abs(g).max() for g in jgrads.values())
    worst, moved = (0.0, ""), 0
    for k, jg in jgrads.items():
        if k not in grads:    # outside the loss's graph in the port
            assert not np.abs(jg).any(), f"{k}: JAX's gradient is not zero"
            continue
        bar = grad_bar * _scale(jgrads, k, model_max) + spread.get(k, 0.0)
        err = np.abs(grads[k] - jg).max()
        worst = max(worst, (err / bar if bar else 0.0, k))
        assert err <= bar, f"{k}: gradient at {err / bar:.2f} of its bar"
        moved_apart = np.abs(got[k] - jstepped[k])
        assert np.all(moved_apart <= 2 * cfg.lr
                      + 2 * np.spacing(np.abs(start[k]))), k
        big = np.abs(jg) > bar
        np.testing.assert_array_equal(np.sign(got[k] - start[k])[big],
                                      np.sign(jstepped[k] - start[k])[big],
                                      err_msg=k)
        moved += int(big.sum())
    print(f"{name}: worst gradient at {worst[0]:.3f} of its bar ({worst[1]}); "
          f"{moved} elements above their bar move in JAX's direction")


@pytest.mark.parametrize("name,world", [("dp2", 2), ("seq12", 2),
                                        ("seq22", 4)])
def test_step_bf16_matches_jax_partitioned(seqbf, name, world):
    """One bf16 AdamW step on a 6-slide batch under [2], [1, 2] (gathered)
    and [2, 2] (ring) against JAX's step partitioned over the same mesh
    (`_hold_step`, GRAD_BAR)."""
    _hold_step(seqbf, name, world, GRAD_BAR)


def test_five_level_ring_step_bf16_matches_jax(seqbf):
    """Five levels (the flagship's depth) under [1, 2] on the ring in bf16:
    one step against JAX's partitioned ring step (`_hold_step`, GRAD_BAR
    plus the spread between JAX's [1, 2] and one-device programs, which
    part at the deeper levels by up to ten GRAD_BARs: GSPMD splits them
    over the model axis, the port runs them whole on each rank)."""
    _hold_step(seqbf, "five_bf16", 2, GRAD_BAR)


def test_five_level_ring_step_f32_matches_one_process(seqbf):
    """Five levels under [1, 2] on the ring in f32: the world's gradients
    within GRAD_RTOL of each tensor's largest (a key bias: of the model's)
    of one process's step on the same batch, and the ranks' losses add up
    to its loss (1e-6 relative)."""
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.train import loop as tloop

    cfg = Config.load(seqbf["dirs"]["five_f32"])
    cfg.mesh_shape = None
    model = convert.from_jax_flat(jstate._flatten(seqbf["params5"]), cfg)
    opt = tloop.make_optimizer(cfg, model.parameters())
    ds = tdata.SlideDataset(seqbf["ids5"], cfg,
                            FeatureStore(cfg.preprocess_dir))
    bag, tables = tdata.collate_batch(ds, STEP5_IDX, level0_bucket=32,
                                      device="cpu")
    labels = {k: torch.tensor(v) for k, v in STEP5_LABELS.items()}
    labels["weight"] = labels["weight"].float()
    loss, _ = tloop.make_step_fns(cfg, opt)[0](model, bag, tables, labels,
                                                epoch=1)
    want = {n: p.grad.numpy() for n, p in model.named_parameters()
            if p.grad is not None}
    ranks = [r["five_f32"] for r in seqbf["ranks"][2]]
    np.testing.assert_allclose(sum(r["loss"] for r in ranks
                                   if r["seq_index"] == 0), float(loss),
                               rtol=1e-6)
    got = _same_on_every_rank(seqbf, "five_f32", 2)
    model_max = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        scale = model_max if n.endswith("k.bias") else np.abs(w).max()
        np.testing.assert_allclose(got["grad/" + n], w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=n)


# ------------------------------------------------------------ training

def test_train_loop_bf16_matches_jax_2x4(seqbf):
    """Two epochs of `train_loop` in bf16 under [1, 2] on the ring against
    JAX's jitted bf16 [2, 4] run from the same weights: epoch losses within
    JIT_BAR; the ranks' parameters equal to the bit."""
    got = seqbf["ranks"][2][0]["ring"]["train_loss"]
    assert seqbf["ranks"][2][1]["ring"] == seqbf["ranks"][2][0]["ring"]
    want = seqbf["want"]["train"]["train_loss"]
    for e in (1, 2):
        assert np.isfinite(got[str(e)])
        np.testing.assert_allclose(got[str(e)], want[e], rtol=JIT_BAR)
    _same_on_every_rank(seqbf, "ring", 2)


@pytest.mark.parametrize("name", ["streaming", "remat"])
def test_streaming_and_remat_bf16_equal_fused(seqbf, name):
    """The streaming engine and remat under [1, 2] in bf16 give the fused
    run's losses (train and val) and parameters to the bit, on every rank."""
    want = seqbf["ranks"][2][0]["ring"]
    got = seqbf["ranks"][2][0][name]
    assert seqbf["ranks"][2][1][name] == got
    assert got["train_loss"] == want["train_loss"]
    assert got["val_loss"] == want["val_loss"]
    params = _same_on_every_rank(seqbf, name, 2)
    for k, v in _arrays(seqbf, "ring", 0, 2).items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)


def test_cli_evaluate_bf16_under_1x2(seqbf):
    """`cli.evaluate` in bf16 under [1, 2] (ring) against one process on the
    trained checkpoint: the c-index exactly, the loss within FWD_BAR."""
    from paths_tpu_torch.cli.evaluate import main
    from paths_tpu_torch.models.recursive import RecursiveModel

    ranks = [r["evaluate"] for r in seqbf["ranks"][2]]
    assert ranks[0] == ranks[1]
    d = os.path.join(seqbf["tmp"], "evaluate_one")
    c = Config.load(seqbf["dirs"]["ring"])
    c.mesh_shape = None
    c.save(d)
    tstate.save_state(d, tstate.load_model(seqbf["dirs"]["ring"],
                                           RecursiveModel(c)))
    want = main(["-m", d, "--split", "test", "--device", "cpu"])
    assert sorted(ranks[0]) == sorted(want)
    assert ranks[0]["test_c-index"] == want["test_c-index"]
    np.testing.assert_allclose(ranks[0]["test_loss"], want["test_loss"],
                               rtol=FWD_BAR)


def test_engine_auto_prices_a_bf16_sequence_ranks_share(tmp_path):
    """Under sp = 2 in bf16 a rank prices its block of level-0 rows with the
    features at 2 bytes and, under the gathered schedule, the whole
    sequence's K and V at 2 bytes (bf16 compute) per decoder layer: half the
    f32 configuration's K/V."""
    from paths_tpu_torch.engine.auto import (
        estimate_fused_batch_bytes,
        resolve_engine,
    )
    from paths_tpu_torch.models.batch import seq_block_width

    pads = {"n0": 4096, "rows": [0, 4096, 4096],
            "grid_hw": [(0, 0), (70, 93), (140, 186)]}
    share, whole = {}, {}
    for name, fields in (("bf16", BF16), ("f32", {})):
        _, c = _cfgs(str(tmp_path), engine="auto", level0_bucket=4096,
                     **fields)
        whole[name] = estimate_fused_batch_bytes(c, pads, 4)
        for impl in SCHEDULES:
            share[name, impl] = estimate_fused_batch_bytes(
                dataclasses.replace(c, seq_attention=impl), pads, 4, sp=2)
    m, mc = seq_block_width(4096, 2), c.model_config
    kv = 4 * 2 * 2 * m * mc.trans_dim * mc.trans_layers
    assert share["bf16", "gathered"] - share["bf16", "ring"] == 2 * kv
    assert share["f32", "gathered"] - share["f32", "ring"] == 4 * kv
    assert share["bf16", "ring"] < whole["bf16"] < whole["f32"]
    _, auto = _cfgs(str(tmp_path), engine="auto", level0_bucket=4096,
                    seq_attention="ring", **BF16)
    hbm = int(((3.0 * share["bf16", "ring"] + 3.0 * whole["bf16"]) / 2
               + (512 << 20)) / 0.85)
    assert resolve_engine(auto, pads, 4, hbm=hbm, verbose=False,
                          sp=2) == "fused"
    assert resolve_engine(auto, pads, 4, hbm=hbm, verbose=False) == "streaming"
