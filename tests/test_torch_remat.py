"""Remat (`config.remat`: each level's forward recomputed in the backward)
in the port on the CPU, against the port without remat and against JAX.

Within the port the recompute repeats the same operations on the same
values, so loss, gradients and the parameters after AdamW are equal to the
bit with and without remat, also with dropout (its masks come from an
explicit generator, which the recompute sets back and then forward again).
Against JAX with remat the bars are `tests/test_torch_train.py`'s: a loss to
1e-6 relative and gradients to 1e-5 of the largest gradient (JAX's own remat
test holds its two runs to 1e-6, `tests/test_hierarchy.py`), whole runs to
5e-2 on the loss per epoch.
"""
import copy
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from paths_tpu.data import dataset as jdata
from paths_tpu.engine import hierarchy as jh
from paths_tpu.models.recursive import recursive_init
from paths_tpu.train import loop as jloop
from paths_tpu.train import state as jstate
from test_torch_train import GRAD_TOL, _batch, _grads_by_key, configs, store  # noqa: F401

from paths_tpu_torch import convert
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.engine import hierarchy as th
from paths_tpu_torch.kernels import flash_attention as tfa
from paths_tpu_torch.train import loop as tloop


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tfa, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, name, spy)
    return calls


def _two_steps(tcfg, params, batch, remat):
    """Two optimizer steps from JAX's `params` with one generator: the
    losses and, per step, the gradients and parameters in the JAX layout."""
    c = copy.deepcopy(tcfg)
    c.remat = remat
    model = convert.from_jax_flat(jstate._flatten(params), c)
    opt = tloop.make_optimizer(c, model.parameters())
    update, _ = tloop.make_step_fns(c, opt)
    gen = torch.Generator().manual_seed(7)
    bag, tables, labels = batch
    steps = []
    for _ in range(2):
        loss, _ = update(model, bag, tables, labels, gen, epoch=1)
        steps.append((loss.item(), _grads_by_key(model),
                      convert.to_jax_flat(model)))
    return steps


@pytest.mark.parametrize("impl,dropout", [("xla", 0.0), ("xla", 0.05),
                                          ("pallas", 0.0), ("pallas", 0.05)])
def test_remat_leaves_steps_unchanged(monkeypatch, store, impl, dropout):
    """Two steps with and without remat: losses, gradients and parameters
    equal to the bit. On the kernel route at dropout 0 the recompute runs
    the flash forward again (twice per decoder layer per level per step);
    the backward runs once either way; at dropout 0.05 the plain route runs,
    as in JAX."""
    tmp, ids, _ = store
    jcfg, tcfg = configs(tmp, attention_impl=impl, mc=dict(dropout=dropout))
    params = recursive_init(jax.random.PRNGKey(3), jcfg)
    _, batch = _batch(tmp, ids, jcfg, tcfg)
    runs = {}
    for remat in (False, True):
        fwd = _spy(monkeypatch, "masked_flash_attention_fwd")
        dq = _spy(monkeypatch, "masked_flash_attention_bwd_dq")
        runs[remat] = _two_steps(tcfg, params, batch, remat)
        per = tcfg.num_levels * tcfg.model_config.trans_layers
        routed = impl == "pallas" and dropout == 0.0
        assert len(fwd) == 2 * per * (1 + remat) * routed
        assert len(dq) == 2 * per * routed
    for (la, ga, pa), (lb, gb, pb) in zip(runs[False], runs[True]):
        assert la == lb
        for k in ga:
            np.testing.assert_array_equal(gb[k], ga[k], err_msg=k)
            np.testing.assert_array_equal(pb[k], pa[k], err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_gradients_match_jax_remat(monkeypatch, store, impl):
    """The port with remat against JAX with remat (`jax.checkpoint` per
    level), at dropout 0."""
    monkeypatch.setattr(fa, "INTERPRET", True)
    tmp, ids, _ = store
    jcfg, tcfg = configs(tmp, attention_impl=impl, remat=True)
    params = recursive_init(jax.random.PRNGKey(1), jcfg)
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    (jbag, jtables, jlab), (tbag, ttables, tlab) = _batch(tmp, ids, jcfg, tcfg)

    def jloss(p):
        return jh.end2end_loss(p, jcfg, jbag, jtables, jlab)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    loss, _ = th.end2end_loss(model, tcfg, tbag, ttables, tlab, training=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    want, got = jstate._flatten(jg), _grads_by_key(model)
    scale = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=key)


def test_train_loop_with_remat_matches_jax(tmp_path, store):
    """One epoch of `train_loop` with `remat: true` in both packages from
    one model.npz: the epoch's loss and the test metrics within the bars of
    `test_train_loop_matches_jax`, and the port's run equal to the bit to
    its run without remat."""
    from paths_tpu.parallel.mesh import make_mesh

    tmp, _, _ = store
    jcfg, tcfg = configs(tmp, lr=1e-3, num_epochs=1, remat=True)
    params = recursive_init(jax.random.PRNGKey(5), jcfg)
    dirs = {n: str(tmp_path / n) for n in ("jax", "torch", "plain")}
    for d in dirs.values():
        jstate.save_state(d, params)
    train, val, test = jdata.load_splits([0.7, 0.15, 0.15], jcfg.seed, jcfg)
    jstats = jloop.train_loop(jcfg, dirs["jax"], train, val, test,
                              mesh=make_mesh(1), verbose=False)
    splits = tdata.load_splits([0.7, 0.15, 0.15], tcfg.seed, tcfg)
    tstats = tloop.train_loop(tcfg, dirs["torch"], *splits, device="cpu",
                              verbose=False)
    np.testing.assert_allclose(tstats["train_loss"][1],
                               jstats["train_loss"][1], rtol=5e-2)
    pstats = tloop.train_loop(dataclasses.replace(tcfg, remat=False),
                              dirs["plain"], *splits, device="cpu",
                              verbose=False)
    assert pstats["train_loss"] == tstats["train_loss"]
    final = {}
    for name, d in dirs.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            final[name] = json.loads(f.read().splitlines()[-1])
    np.testing.assert_allclose(final["torch"]["test_loss"],
                               final["jax"]["test_loss"], rtol=5e-2)
    assert abs(final["torch"]["test_c-index"]
               - final["jax"]["test_c-index"]) <= 0.1
    assert final["plain"]["test_loss"] == final["torch"]["test_loss"]
