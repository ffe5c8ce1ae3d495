"""The bf16 configuration of the hierarchical model (`compute_dtype` and
`table_dtype` "bfloat16") in the port, against the JAX package on the CPU.

Weights cross over in the JAX package's `model.npz` layout, inputs are numpy
from fixed seeds, and the attention runs on `attention_impl` "pallas" (the
Pallas kernels in interpret mode against the port's plain flash versions)
unless a case says otherwise.

Where the port rounds. A JAX program rounds every op's result to its dtype;
the port rounds at the same points (`nn/core.py`: a product before its bias,
the logistic as XLA expands it, JAX's gradient rules for the logistic and
tanh; `ops/pos_encoding.py`: the frequency factor; `nn/attention.py`: the
attention context summed in f32). Both sum products in f32, so what is left
between them is the order of f32 sums, which changes a bf16 rounding rarely.

Two ways of running JAX. `strict` compiles a JAX function with XLA's excess
precision off, which gives the numbers of the program run op by op (each
result rounded to its dtype) in one compilation. The package's own jitted
programs (its train step, `train_loop`, `ServingSession`) let XLA keep a
bf16 result at f32 where an f32 op consumes it, which moves their outputs
from the op-by-op values.

Bars, with u = 2^-8, bf16's unit roundoff (an ulp of a value is at most 2u
of it):

* FWD_BAR = 4u, against JAX op by op: outputs to 4u of their own largest,
  importances (in [0, 1]) to 4u absolute. A changed rounding moves a value
  by one ulp (2u of it); the LayerNorms and the Xavier-scaled layers carry
  it to the output at a gain of about 1; the bar admits two such changes.
  And at most CHANGED = 1% of the outputs may differ at all: with the same
  rounding points an output differs only where an f32 sum taken in another
  order lands on the other side of a bf16 rounding boundary, which is rare,
  while a rounding point placed elsewhere changes a quarter or more of them
  (the bias added before the product's rounding: 27%; torch's bf16 sigmoid
  in place of XLA's expansion: 30%).
* GRAD_BAR = 12u of each gradient's own largest, against JAX op by op. The
  forward agrees to FWD_BAR; the backward adds rounding points that the two
  frameworks place differently: where a value's cotangents are summed (a
  decoder layer's input feeds q, k, v and the residual: 3 bf16 adds) and
  where a fused torch backward rounds once where JAX's rules round at each
  op (about 3 on the deepest path). Six such points at an ulp (2u) each
  make 12u, which stays below JAX's own 5% loss gap between f32 and bf16
  (`tests/test_lazy_dataset.py::test_bf16_tables`). A key bias, zero in
  exact arithmetic, is held to the model's largest gradient instead.
* JIT_BAR = 8u, against the package's jitted programs: on top of the
  op-by-op agreement, XLA skips a rounding where a bf16 result meets an f32
  op, moving the value by at most half an ulp (u of it); the last level's
  logits sit behind about 8 such points (the LSTM's 3 state updates, the
  importances' cast, the LayerNorms' 3 residual inputs per decoder layer and
  the final norm), carried at a gain of about 1.

Top-K flips. The importances are a bf16 sigmoid, so a top-K sees exact ties
(broken to the lowest index in both packages) and near ties, where one
changed rounding reorders two patches; the next level then reads other
children and the slide's outputs part for a reason that is not a fault.
`compare_levels` counts and prints such flips, requires each to be a near
tie (JAX's importances of the two patches within FWD_BAR) and holds every
other slide's outputs to the bar. Any other difference in a bag fails.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from paths_tpu.data import dataset as jdata
from paths_tpu.data.feature_store import FeatureStore as JStore
from paths_tpu.engine import hierarchy as jh
from paths_tpu.models.batch import PatchBag as JBag
from paths_tpu.models.processor import processor_apply as j_processor_apply
from paths_tpu.models.recursive import recursive_init
from paths_tpu.ops.masking import masked_topk as j_masked_topk
from paths_tpu.serve import ServingSession as JSession
from paths_tpu.serve import serving_dataset
from paths_tpu.train import loop as jloop
from paths_tpu.train import state as jstate
from test_torch_models import _random_bag, model_pair, small_configs
from test_torch_train import _batch, _grads_by_key, configs, store  # noqa: F401

from paths_tpu_torch import convert
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.data.synthetic import make_synthetic_store
from paths_tpu_torch.engine import hierarchy as th
from paths_tpu_torch.engine import streaming as tstream
from paths_tpu_torch.models.batch import PatchBag
from paths_tpu_torch.models.processor import processor_apply
from paths_tpu_torch.ops.masking import masked_topk
from paths_tpu_torch.serve import ServingSession
from paths_tpu_torch.train import loop as tloop

U = 2.0 ** -8
FWD_BAR = 4 * U
GRAD_BAR = 12 * U
JIT_BAR = 8 * U
CHANGED = 0.01
BF16 = dict(compute_dtype="bfloat16", table_dtype="bfloat16")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(fa, "INTERPRET", True)


def strict(fn, *args):
    """`fn(*args)` compiled with XLA's excess precision off: the numbers of
    the JAX program run op by op."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def within(got, want, bar, what, absolute=False):
    """|got - want| <= bar x the largest |want| (or bar, `absolute`)."""
    got, want = f32(got), f32(want)
    scale = 1.0 if absolute else max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale if got.size else 0.0
    assert err <= bar, f"{what}: {err / U:.2f} u of its scale (bar {bar / U:.0f} u)"
    return err


def changed_share(pairs) -> float:
    """The share of elements that differ at all over (got, want) pairs."""
    pairs = [(f32(g), f32(w)) for g, w in pairs]
    return (sum(int((g != w).sum()) for g, w in pairs)
            / max(sum(w.size for _, w in pairs), 1))


def compare_levels(jouts, touts, config, bar, label, changed=None):
    """Level by level: each slide's bag (mask, locs, parents) equals JAX's,
    or differs after a top-K flip at a near tie one level up (JAX's
    importances of the patch JAX kept and the one the port kept within
    `bar`); on the slides whose bags have agreed so far, importances are
    within `bar` absolute and logits within `bar` of the largest, and with
    `changed` at most that share of their importances, logits and contexts
    differ at all. Prints the flips; returns the per-slide agreement over
    all levels."""
    b = touts[0]["bag"].mask.shape[0]
    agree = np.ones(b, bool)
    flips, pairs = [], []
    for lvl, (jo, to) in enumerate(zip(jouts, touts)):
        if lvl:
            same = np.ones(b, bool)
            for f in ("mask", "locs", "parent_inds"):
                same &= (np.asarray(getattr(jo["bag"], f))
                         == getattr(to["bag"], f).numpy()).reshape(b, -1).all(1)
            prev_j, prev_t = jouts[lvl - 1], touts[lvl - 1]
            k = min(config.top_k_patches[lvl - 1], prev_t["bag"].mask.shape[1])
            jidx = np.asarray(j_masked_topk(prev_j["importance"],
                                            prev_j["bag"].mask, k)[0])
            tidx = masked_topk(prev_t["importance"], prev_t["bag"].mask,
                               k)[0].numpy()
            jimp = f32(prev_j["importance"])
            for s in np.flatnonzero(agree & ~same):
                at = np.flatnonzero(jidx[s] != tidx[s])
                assert at.size, (f"{label}: level {lvl} slide {s}: the bag "
                                 "differs from JAX's under the same top-K")
                p = at[0]
                gap = abs(jimp[s, jidx[s, p]] - jimp[s, tidx[s, p]])
                assert gap <= bar, (f"{label}: level {lvl - 1} slide {s}: "
                                    f"top-K flip where JAX's importances are "
                                    f"{gap / U:.2f} u apart, not a near tie")
                flips.append((lvl - 1, int(s), float(gap)))
            agree &= same
        if agree.any():
            within(to["importance"][agree], f32(jo["importance"])[agree], bar,
                   f"{label} level {lvl} importance", absolute=True)
            within(to["logits"][agree], f32(jo["logits"])[agree], bar,
                   f"{label} level {lvl} logits")
            pairs += [(f32(to[k])[agree], f32(jo[k])[agree])
                      for k in ("importance", "logits", "ctx_slide",
                                "ctx_patch")]
    if changed is not None:
        share = changed_share(pairs)
        assert share <= changed, f"{label}: {share:.4f} of the outputs differ"
    print(f"{label}: {len(flips)} top-K flip(s) at near ties "
          f"(level, slide, gap): {flips}; {int(agree.sum())} of {b} slides "
          "agree at every level")
    return agree


# ------------------------------------------------------------- rounding points

@pytest.mark.parametrize("op", ["affine", "sigmoid", "tanh"])
def test_bf16_ops_round_as_jax(op):
    """The port's bf16 affine map, logistic and tanh, and their gradients,
    equal to the bit to JAX's op by op on 4096 random values each: the same
    rounding points (module docstring), so no sum in another order is left
    to move one (each product sums 16 terms). One exception: JAX sums a
    bias's cotangent over the rows in bf16 arithmetic (`lax.reduce_sum` at
    the cotangent's dtype), the port in f32 with one rounding: the port's
    bias gradient is that f32 sum rounded, to the bit."""
    from paths_tpu_torch.nn import core

    rng = np.random.default_rng(7)
    x = (rng.normal(size=(256, 16)) * 3).astype(np.float32)
    w = (rng.normal(size=(16, 16)) / 4).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    g = rng.normal(size=(256, 16)).astype(np.float32)
    bf = jnp.bfloat16
    jfn = {"affine": lambda x, w, b: x @ w + b,
           "sigmoid": lambda x, w, b: jax.nn.sigmoid(x),
           "tanh": lambda x, w, b: jnp.tanh(x)}[op]
    jargs = [jnp.asarray(a).astype(bf) for a in (x, w, b)]
    want, vjp = strict(lambda *a: jax.vjp(jfn, *a), *jargs)
    want_grads = strict(lambda c: vjp(c), jnp.asarray(g).astype(bf))
    targs = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (x, w, b)]
    tx, tw, tb = targs
    got = {"affine": lambda: core.affine(tx, tw.t(), tb),
           "sigmoid": lambda: core.sigmoid(tx),
           "tanh": lambda: core.tanh(tx)}[op]()
    got.backward(torch.from_numpy(g).bfloat16())
    np.testing.assert_array_equal(f32(got), f32(want))
    if op == "affine":
        rows = f32(torch.from_numpy(g).bfloat16()).astype(np.float64).sum(0)
        want_grads = (*want_grads[:2], rows.astype(np.float32))
        np.testing.assert_array_equal(f32(tb.grad),
                                      f32(torch.from_numpy(want_grads[2])
                                          .bfloat16()))
        targs = targs[:2]
    for t, wg in zip(targs, want_grads):
        if t.grad is not None:
            np.testing.assert_array_equal(f32(t.grad), f32(wg))


# --------------------------------------------------------------- processor

@pytest.mark.parametrize("lstm", [True, False])
@pytest.mark.parametrize("pe", ["1d", "2d"])
@pytest.mark.parametrize("depth", [0, 1])
def test_processor_bf16_matches_jax(lstm, pe, depth):
    """One level's processor in bf16 on the plain attention route, against
    JAX run op by op: logits, slide and patch contexts to FWD_BAR of their
    largest, importances to FWD_BAR absolute, and at most CHANGED of all
    their elements different at all."""
    jcfg, tcfg = small_configs(lstm=lstm, pos_encoding_mode=pe)
    jcfg.compute_dtype = tcfg.compute_dtype = "bfloat16"
    params, model = model_pair(jcfg, tcfg, seed=depth)
    arrays = _random_bag(np.random.default_rng(depth), 3, 12, depth,
                         tcfg.model_config.ctx_dim(),
                         tcfg.model_config.patch_embed_dim)
    want = j_processor_apply(
        params["procs"][depth], jcfg.model_config, jcfg, depth,
        JBag(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        lstm_params=params.get("lstm"))
    with torch.no_grad():
        got = processor_apply(
            model.procs[depth], tcfg.model_config, tcfg, depth,
            PatchBag(**{k: torch.from_numpy(v).long()
                        if k in ("locs", "parent_inds") else torch.from_numpy(v)
                        for k, v in arrays.items()}),
            lstm=getattr(model, "lstm", None))
    for key in ("logits", "ctx_slide", "ctx_patch"):
        assert got[key].dtype == getattr(torch, str(want[key].dtype)), key
        within(got[key], want[key], FWD_BAR, key)
    within(got["importance"], want["importance"], FWD_BAR, "importance",
           absolute=True)
    share = changed_share((got[k], want[k]) for k in got)
    assert share <= CHANGED, f"{share:.4f} of the outputs differ"


# -------------------------------------------------- the whole forward pass

@functools.lru_cache(maxsize=None)
def _forward_store(tmp):
    _, tcfg = small_configs()
    return make_synthetic_store(tmp, tcfg, num_slides=8, base_hw=(6, 8),
                                seed=5)


def _forward_pair(tmp, impl, seed=0, **cfg):
    """Both packages' configs, models and one collated batch of the 8-slide
    forward store (level-0 bags of 24-50 patches, K 4, 3 levels)."""
    jcfg, tcfg = small_configs(impl, pos_encoding_mode="2d")
    for c in (jcfg, tcfg):
        for k, v in cfg.items():
            setattr(c, k, v)
    ids = _forward_store(tmp)
    params, model = model_pair(jcfg, tcfg, seed=seed)
    jds = serving_dataset(jcfg, JStore(tmp), ids)
    jbag, jtables, _ = jdata.collate_batch(jds, range(len(ids)),
                                           level0_bucket=16)
    tds = tdata.SlideDataset(ids, tcfg, FeatureStore(tmp))
    tbag, ttables = tdata.collate_batch(tds, range(len(ids)),
                                        level0_bucket=16, device="cpu")
    return jcfg, tcfg, params, model, (jbag, jtables), (tbag, ttables)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_bf16_level_by_level(tmp_path_factory, impl):
    """All levels of one batch with both fields bf16, against JAX op by op
    (`compare_levels` at FWD_BAR and CHANGED): the bags, with flips allowed
    at near ties only, then the outputs of the slides that agree."""
    tmp = str(tmp_path_factory.getbasetemp() / "bf16_forward")
    jcfg, tcfg, params, model, (jbag, jtables), (tbag, ttables) = \
        _forward_pair(tmp, impl, **BF16)
    assert tbag.fts.dtype == torch.bfloat16 and jbag.fts.dtype == jnp.bfloat16
    jouts = strict(lambda p, b, t: jh.end2end_forward(p, jcfg, b, t),
                   params, jbag, jtables)
    with torch.no_grad():
        touts = th.end2end_forward(model, tcfg, tbag, ttables)
    agree = compare_levels(jouts, touts, tcfg, FWD_BAR, f"forward {impl}",
                           changed=CHANGED)
    assert agree.any()
    hazards = torch.sigmoid(touts[-1]["logits"])
    within(hazards[agree], jax.nn.sigmoid(jouts[-1]["logits"])[agree],
           FWD_BAR, "hazards")


# ------------------------------------------------ the loss and its gradients

@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(tmp, ids, seed):
    """JAX's bf16 loss and gradients op by op on the batch of
    `test_torch_train.py`, cached for the gradient and AdamW cases."""
    jcfg, _ = configs(tmp, attention_impl="pallas", **BF16)
    params = recursive_init(jax.random.PRNGKey(seed), jcfg)
    batch = _batches(tmp, ids, jcfg)[0]
    fa.INTERPRET = True
    loss, grads = strict(jax.value_and_grad(
        lambda p: jh.end2end_loss(p, jcfg, *batch)[0]), params)
    return params, float(loss), jstate._flatten(grads)


def _batches(tmp, ids, jcfg=None, tcfg=None):
    """`test_torch_train._batch` (both packages' batch of 6 slides with
    labels) for whichever config is given; the other is bf16."""
    jb, tb = configs(tmp, **BF16)
    return _batch(tmp, list(ids), jcfg or jb, tcfg or tb)


def _grad_bars(want):
    """GRAD_BAR x each gradient's own largest; a key bias's to the model's."""
    model_max = max(np.abs(w).max() for w in want.values())
    return {k: GRAD_BAR * (model_max if k.endswith("/k/b")
                           else np.abs(w).max()) for k, w in want.items()}


def test_end2end_loss_and_gradients_bf16_match_jax(store):
    """`end2end_loss` with both fields bf16 on the kernel route: the loss to
    FWD_BAR relative, every gradient to GRAD_BAR of its own largest, against
    JAX op by op."""
    tmp, ids, _ = store
    params, jl, want = _jax_loss_and_grads(tmp, tuple(ids), 1)
    _, tcfg = configs(tmp, attention_impl="pallas", **BF16)
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    tbag, ttables, tlab = _batches(tmp, ids, tcfg=tcfg)[1]
    assert tbag.fts.dtype == torch.bfloat16
    loss, _ = th.end2end_loss(model, tcfg, tbag, ttables, tlab)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), jl, rtol=FWD_BAR)
    got = _grads_by_key(model)
    assert sorted(got) == sorted(want)
    bars = _grad_bars(want)
    worst = max((np.abs(got[k] - w).max() / bars[k], k) for k, w in want.items()
                if bars[k] > 0)
    print(f"worst gradient at {worst[0]:.3f} of its bar: {worst[1]}")
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=bars[k], err_msg=k)


# ------------------------------------------------------------- the optimizer

def test_adamw_step_bf16_moves_as_jax(store):
    """One step of the port's `update` in bf16 against JAX's AdamW
    (`make_optimizer`) applied to JAX's op-by-op gradients: every element
    whose JAX gradient exceeds its GRAD_BAR moves in JAX's direction (the
    first AdamW step moves an element by about lr * sign(g), so an element
    whose gradient sign is rounding noise may move either way), and every
    parameter stays f32. JAX's jitted step is not the yardstick here: XLA's
    excess precision moves its gradients by up to 18u of a tensor's largest
    from the op-by-op ones."""
    import optax

    tmp, ids, _ = store
    params, jl, grads = _jax_loss_and_grads(tmp, tuple(ids), 1)
    jcfg, tcfg = configs(tmp, attention_impl="pallas", **BF16)
    tx = jloop.make_optimizer(jcfg)
    jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
    flat = jstate._flatten(params)
    jp = {k: jnp.asarray(v) for k, v in flat.items()}
    upd, _ = tx.update(jgrads, tx.init(jp), jp)
    want = {k: np.asarray(v) for k, v in optax.apply_updates(jp, upd).items()}

    model = convert.from_jax_flat(flat, tcfg)
    opt = tloop.make_optimizer(tcfg, model.parameters())
    tupdate, _ = tloop.make_step_fns(tcfg, opt)
    tbag, ttables, tlab = _batches(tmp, ids, tcfg=tcfg)[1]
    tl, _ = tupdate(model, tbag, ttables, tlab, epoch=1)
    np.testing.assert_allclose(tl.item(), jl, rtol=FWD_BAR)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = convert.to_jax_flat(model)
    bars = _grad_bars(grads)
    moved = 0
    for k, g in grads.items():
        big = np.abs(g) > bars[k]
        dj = np.sign(want[k] - flat[k])[big]
        dt = np.sign(got[k] - flat[k])[big]
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(dt, dj, err_msg=k)
        moved += int(big.sum())
    print(f"{moved} of {sum(g.size for g in grads.values())} elements above "
          "their gradient bar move in JAX's direction")


# --------------------------------------------------------- the training loop

def test_train_loop_bf16_one_epoch(tmp_path, store):
    """One epoch of `train_loop` with both fields bf16 in both packages from
    one model.npz (the counterpart of `test_train_bf16_compute`): finite
    losses, f32 parameters, and the port's epoch loss within JIT_BAR of
    JAX's jitted run."""
    from paths_tpu.parallel.mesh import make_mesh

    tmp, _, _ = store
    jcfg, tcfg = configs(tmp, num_epochs=1, attention_impl="pallas", **BF16)
    params = recursive_init(jax.random.PRNGKey(5), jcfg)
    dirs = {name: str(tmp_path / name) for name in ("jax", "torch")}
    for d in dirs.values():
        jstate.save_state(d, params)
    jsplits = jdata.load_splits([0.7, 0.15, 0.15], jcfg.seed, jcfg)
    tsplits = tdata.load_splits([0.7, 0.15, 0.15], tcfg.seed, tcfg)
    jstats = jloop.train_loop(jcfg, dirs["jax"], *jsplits, mesh=make_mesh(1),
                              verbose=False)
    tstats = tloop.train_loop(tcfg, dirs["torch"], *tsplits, verbose=False,
                              device="cpu")
    assert np.isfinite(tstats["train_loss"][1])
    np.testing.assert_allclose(tstats["train_loss"][1],
                               jstats["train_loss"][1], rtol=JIT_BAR)
    from paths_tpu_torch.train.state import load_state

    model, _, _ = load_state(dirs["torch"], tloop.RecursiveModel(tcfg))
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ------------------------------------------------------------ bf16 tables

@pytest.mark.parametrize("n0,rows,hw,bs", [(96, 64, (8, 8), 4),
                                           (4096, 4096, (70, 93), 32)])
def test_engine_auto_prices_the_bf16_configuration_as_jax(n0, rows, hw, bs):
    """`engine: auto` prices a fused batch of the bf16 configuration as JAX
    does: the features and contexts at 2 bytes, the index arrays as in f32,
    and `compute_dtype` no part of one process's residency."""
    from paths_tpu.engine import auto as jauto

    from paths_tpu_torch.engine import auto as tauto

    pads = {"n0": n0, "rows": [0, rows, rows], "grid_hw": [(0, 0), hw, hw]}
    got = {}
    for name, fields in (("bf16", BF16), ("f32", {})):
        jcfg, tcfg = configs("/nonexistent", top_k_patches=[20, 7], **fields)
        got[name] = tauto.estimate_fused_batch_bytes(tcfg, pads, bs)
        assert got[name] == jauto.estimate_fused_batch_bytes(jcfg, pads, bs)
    assert 0.5 * got["f32"] < got["bf16"] < 0.6 * got["f32"]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_bf16_tables(store, compute):
    """`table_dtype` bf16 (the counterpart of `test_bf16_tables`): collated
    features are bf16; the loss equals JAX's on the same bf16 tables (f32
    compute: to 1e-5 relative, the f32 bar; bf16 compute: FWD_BAR against
    JAX op by op) and stays within JAX's 5% of the port's f32-table loss;
    the streaming engine gives the fused engine's loss, prediction and
    gradients to the bit."""
    tmp, ids, _ = store
    jcfg, tcfg = configs(tmp, attention_impl="pallas", compute_dtype=compute,
                         table_dtype="bfloat16")
    params = recursive_init(jax.random.PRNGKey(0), jcfg)
    (jbag, jtables, jlab), (tbag, ttables, tlab) = _batches(tmp, ids, jcfg,
                                                            tcfg)
    assert tbag.fts.dtype == torch.bfloat16
    assert all(t.fts.dtype == torch.bfloat16 for t in ttables)
    jl = float(strict(lambda p: jh.end2end_loss(p, jcfg, jbag, jtables,
                                                jlab)[0], params))
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    lf, aux = th.end2end_loss(model, tcfg, tbag, ttables, tlab)
    lf.backward()
    np.testing.assert_allclose(lf.item(), jl,
                               rtol=1e-5 if compute == "float32" else FWD_BAR)

    _, tcfg32 = configs(tmp, attention_impl="pallas", compute_dtype=compute)
    bag32, tables32, _ = _batches(tmp, ids, tcfg=tcfg32)[1]
    with torch.no_grad():
        l32, _ = th.end2end_loss(model, tcfg32, bag32, tables32, tlab)
    assert abs(lf.item() - l32.item()) / abs(l32.item()) < 0.05

    want = {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}
    ds = tdata.SlideDataset(list(ids), tcfg, FeatureStore(tcfg.preprocess_dir))
    host = [[dict(t) for t in ds.slides[i].tables] for i in range(6)]
    ls, pred, got = tstream.StreamingEngine(tcfg, "cpu").loss_and_grad(
        model, tbag, host, tlab)
    assert ls.item() == lf.item()
    assert torch.equal(pred, aux["pred"].detach())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name


# ---------------------------------------------------------------- sessions

def test_serving_sessions_bf16_match_jax(tmp_path_factory):
    """`ServingSession` with both fields bf16 on the fused and the streaming
    engine, each against JAX's session on the same engine (jitted programs,
    so JIT_BAR): the hazards of the slides whose bags agree with JAX's
    jitted forward at every level (`compare_levels`, flips at near ties
    allowed) within JIT_BAR; the fused session's hazards are its forward's,
    and the streaming session's equal them to the bit."""
    tmp = str(tmp_path_factory.getbasetemp() / "bf16_forward")
    jcfg, tcfg, params, model, _, _ = _forward_pair(tmp, "pallas", seed=2,
                                                    **BF16)
    ids = _forward_store(tmp)
    sessions = {}
    for engine in ("fused", "streaming"):
        d = str(tmp_path_factory.mktemp(f"bf16_session_{engine}"))
        jcfg.preprocess_dir, jcfg.engine = tmp, engine
        jcfg.save(d)
        jstate.save_state(d, params)
        sessions[engine] = (JSession(d, batch_size=len(ids), cache_batches=0),
                            ServingSession(d, batch_size=len(ids),
                                           device="cpu"))
    jcfg.engine = "fused"

    # the fused sessions' one batch through both packages' forwards
    jfused, tfused = sessions["fused"]
    jbag, jtables, _ = jdata.collate_batch(jfused._dataset, range(len(ids)),
                                           pads=jfused._pads)
    tbag, ttables = tdata.collate_batch(tfused._dataset, range(len(ids)),
                                        pads=tfused._pads, device="cpu")
    jouts = jax.jit(lambda p, b, t: jh.end2end_forward(p, jcfg, b, t))(
        params, jbag, jtables)
    with torch.no_grad():
        touts = th.end2end_forward(model, tcfg, tbag, ttables)
    agree = compare_levels(jouts, touts, tcfg, JIT_BAR, "sessions")
    hazards = {}
    for engine, (jsess, sess) in sessions.items():
        hazards[engine] = np.array([r["hazards"] for r in sess.predict(ids)],
                                   np.float32)
        want = np.array([r["hazards"] for r in jsess.predict(ids)])
        within(hazards[engine][agree], want[agree], JIT_BAR,
               f"{engine} session hazards")
    np.testing.assert_array_equal(hazards["fused"], f32(torch.sigmoid(
        touts[-1]["logits"])))
    np.testing.assert_array_equal(hazards["streaming"], hazards["fused"])
