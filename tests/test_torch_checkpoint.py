"""The reference `model.pt` / `train_stats.pkl` route of the port on the CPU,
against the JAX package.

A `model.pt` holds `RecursiveModel.state_dict()` of the original PyTorch
PATHS. Maps between it and the port go through the JAX flat layout and move
no bit: a checkpoint written by JAX's `save_torch_checkpoint` (or by a
reference model's `state_dict()`) loads into the port with the values JAX
loads, the port's exporter loads in JAX equal to the bit, and a round trip
through the port changes nothing. Hazards of the two packages' sessions over
one `model.pt` agree to 1e-6 (f32 on the CPU, different summation order).
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from helpers_torch import TorchRecursive, to_numpy_sd
from paths_tpu import convert as jconvert
from paths_tpu.data.synthetic import make_synthetic_store
from paths_tpu.models.recursive import recursive_init
from paths_tpu.serve import ServingSession as JSession
from paths_tpu.train import state as jstate
from test_model_parity import torch_kwargs
from test_torch_models import small_configs

from paths_tpu_torch import convert
from paths_tpu_torch.models.jax_init import fresh_model
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.serve import ServingSession
from paths_tpu_torch.train import state as tstate

HAZARD_TOL = 1e-6


def _pair(lstm, seed=0):
    jcfg, tcfg = small_configs(pos_encoding_mode="2d", lstm=lstm)
    params = recursive_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params


def _same_flat(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("lstm", [True, False])
def test_jax_written_model_pt_serves_as_jax(tmp_path, lstm):
    """A model directory holding config.json and a `model.pt` written by
    JAX's exporter: the port's session loads the weights JAX loads, and its
    hazards equal JAX's session's over the same store."""
    jcfg, tcfg, params = _pair(lstm)
    store = str(tmp_path / "store")
    ids = make_synthetic_store(store, jcfg, num_slides=4, base_hw=(3, 4),
                               seed=3)
    jcfg.preprocess_dir = store
    d = str(tmp_path / "model")
    jcfg.save(d)
    jconvert.save_torch_checkpoint(os.path.join(d, "model.pt"), params, jcfg)
    assert sorted(os.listdir(d)) == ["config.json", "model.pt"]

    model = tstate.load_model(d, RecursiveModel(tcfg))
    _same_flat(convert.to_jax_flat(model), jstate._flatten(params))
    got = ServingSession(d, batch_size=4, device="cpu").predict(ids)
    want = JSession(d, batch_size=4, cache_batches=0).predict(ids)
    for a, b in zip(got, want):
        assert a["slide_id"] == b["slide_id"]
        np.testing.assert_allclose(a["hazards"], b["hazards"],
                                   atol=HAZARD_TOL, rtol=0)


@pytest.mark.parametrize("lstm", [True, False])
def test_port_export_loads_in_jax_bitwise(tmp_path, lstm):
    """The port's exporter: contiguous f32 CPU tensors in the reference's
    key space, which JAX's loader (strict on its keys) reads equal to the
    bit; a round trip through the port is the identity."""
    jcfg, tcfg, _ = _pair(lstm)
    model = fresh_model(tcfg, 4)
    path = str(tmp_path / "model.pt")
    convert.save_torch_checkpoint(path, model)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        assert v.device.type == "cpu", k
    want = convert.to_jax_flat(model)
    jparams = jconvert.load_torch_checkpoint(path, jcfg)
    _same_flat(jstate._flatten(jparams), want)
    assert sorted(sd) == sorted(jconvert.recursive_to_torch(jparams, jcfg))
    back = convert.load_torch_checkpoint(path, RecursiveModel(tcfg))
    _same_flat(convert.to_jax_flat(back), want)


@pytest.mark.parametrize("lstm", [True, False])
def test_reference_state_dict_round_trips(tmp_path, lstm):
    """A state dict of a reference-layout model (`helpers_torch`'s mirror of
    the original modules), saved with `torch.save`: the port loads what JAX
    loads, and its exporter gives the same keys and values back."""
    jcfg, tcfg, _ = _pair(lstm)
    torch.manual_seed(0)
    ref = TorchRecursive(jcfg.num_levels, lstm=lstm, **torch_kwargs(jcfg))
    path = str(tmp_path / "model.pt")
    torch.save(ref.state_dict(), path)
    model = convert.load_torch_checkpoint(path, RecursiveModel(tcfg))
    _same_flat(convert.to_jax_flat(model),
               jstate._flatten(jconvert.load_torch_checkpoint(path, jcfg)))
    want = to_numpy_sd(ref)
    got = convert.recursive_to_torch(model)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _same_flat(convert.to_jax_flat(convert.recursive_from_torch(want, tcfg)),
               convert.to_jax_flat(model))


def test_train_stats_pkl_resumes_as_jax(tmp_path):
    """A reference `train_stats.pkl` resumes the epoch and the metric
    histories (integer epoch keys), as in JAX; `train_stats.json` is read
    first when both are there."""
    jcfg, tcfg, params = _pair(True)
    ref_stats = {"epoch": 17, "train_loss": {1: 1.5, 16: 0.2},
                 "train_c-index": {16: 0.9}, "val_loss": {}}
    with open(tmp_path / "train_stats.pkl", "wb") as f:
        pickle.dump(ref_stats, f)
    _, _, want = jstate.load_state(str(tmp_path), params, config=jcfg)
    _, _, got = tstate.load_state(str(tmp_path), RecursiveModel(tcfg))
    assert got == want == ref_stats

    with open(tmp_path / "train_stats.json", "w") as f:
        json.dump({"epoch": 3, "train_loss": {"2": 0.7}}, f)
    _, _, want = jstate.load_state(str(tmp_path), params, config=jcfg)
    _, _, got = tstate.load_state(str(tmp_path), RecursiveModel(tcfg))
    assert got == want == {"epoch": 3, "train_loss": {2: 0.7}}


def test_npz_wins_over_model_pt(tmp_path):
    jcfg, tcfg, params = _pair(True, seed=1)
    jstate.save_state(str(tmp_path), params)
    other = fresh_model(tcfg, 9)
    convert.save_torch_checkpoint(str(tmp_path / "model.pt"), other)
    model, _, stats = tstate.load_state(str(tmp_path), RecursiveModel(tcfg))
    _same_flat(convert.to_jax_flat(model), jstate._flatten(params))
    assert stats == {"epoch": 1}


def test_missing_reference_key_raises(tmp_path):
    _, tcfg, _ = _pair(True)
    model = fresh_model(tcfg, 0)
    sd = convert.recursive_to_torch(model)
    del sd["lstm.forget_gate.0.weight"]
    with pytest.raises(KeyError):
        convert.recursive_from_torch(sd, tcfg)
    with pytest.raises(FileNotFoundError):
        tstate.load_model(str(tmp_path), RecursiveModel(tcfg))
