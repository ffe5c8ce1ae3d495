"""The port's serving export (`paths_tpu_torch.export`, `cli.export`) on the
CPU, against its live forward and the JAX package's `make_serving_fn`.

One model directory (config.json and a JAX-written model.npz over a
synthetic store) is exported three ways by `cli.export --platforms cpu`:
weights as arguments, frozen, and with a symbolic batch axis. The config
takes the kernel route (`attention_impl: "pallas"`), so the CPU program
calls the operator `paths_torch::flash_attention_fwd` (on the CPU, the
plain flash version). An artifact runs the port's own ops on the same
inputs, so it equals the live forward to the bit; the JAX package's forward
is held to `TOL`, as in `tests/test_torch_serve.py` (f32 on the CPU,
different summation order). Artifacts are shared through a module fixture:
tracing is the slow part.
"""
import copy
import csv
import functools
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from paths_tpu import export as jexport
from paths_tpu.data import dataset as jdata
from paths_tpu.data.synthetic import make_synthetic_metadata, make_synthetic_store
from paths_tpu.models.recursive import recursive_init
from paths_tpu.train.state import save_state
from test_train_loop import tiny_train_config

from paths_tpu_torch import export as texport
from paths_tpu_torch.cli.export import main as texport_main
from paths_tpu_torch.cli.predict import main as tpredict
from paths_tpu_torch.config import Config
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.kernels import flash_attention as tfa
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.serve import ServingSession
from paths_tpu_torch.train.state import load_model

TOL = 1e-5
OP = "paths_torch.flash_attention_fwd"
FLAVOURS = {"args": [], "frozen": ["--freeze"], "poly": ["--poly-batch"]}


def _model_dir(root, seed=0, **kw):
    """config.json (kernel route) and a JAX-written model.npz over a
    6-slide synthetic store; returns (dir, JAX config, port config)."""
    model_kw = kw.pop("model_kw", {})
    jcfg = tiny_train_config(root, attention_impl="pallas", **kw)
    for k, v in model_kw.items():
        setattr(jcfg.model_config, k, v)
    ids = make_synthetic_store(jcfg.preprocess_dir, jcfg, num_slides=6,
                               base_hw=(3, 3))
    make_synthetic_metadata(
        jcfg.csv_path, ids,
        subtypes=(jcfg.filter_to_subtypes
                  if jcfg.task == "subtype_classification" else None))
    d = os.path.join(root, "model")
    jcfg.save(d)
    save_state(d, recursive_init(jax.random.PRNGKey(seed), jcfg), None,
               {"epoch": 1})
    return d, jcfg, Config.load(d)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_export"))
    d, jcfg, tcfg = _model_dir(root)
    paths = {}
    for name, flags in FLAVOURS.items():
        paths[name] = os.path.join(root, f"{name}.pt2z")
        texport_main(["-m", d, "-o", paths[name], "--batch-size", "4",
                      "--platforms", "cpu"] + flags)
    model = load_model(d, RecursiveModel(tcfg)).eval().requires_grad_(False)
    return root, d, jcfg, tcfg, model, paths


@functools.lru_cache(maxsize=None)
def _load(path):
    """Loaded once per artifact: loading parses the whole graph."""
    with open(path, "rb") as f:
        return texport.load_serving(f.read())


def _batch(tcfg, pads, indices):
    """Port inputs collated at an artifact's exact pads, as dicts."""
    ds = tdata.load_splits([1.0, 0.0, 0.0], 0, tcfg)[0]
    bag, tables = tdata.collate_batch(ds, indices, level0_bucket=1,
                                      row_bucket=1, grid_bucket=1, pads=pads,
                                      device="cpu")
    return texport.bag_to_dict(bag), texport.tables_to_dicts(tables)


def _live(tcfg, model, bag_d, tab_d):
    with torch.inference_mode():
        return texport.make_serving_fn(tcfg)(model, bag_d, tab_d)


def _call(exp, *args):
    with torch.inference_mode():
        return exp.call(*args)


def _xla(jcfg):
    jcfg = copy.deepcopy(jcfg)
    jcfg.attention_impl = "xla"
    return jcfg


def _jax_pred(jcfg, params, pads, indices):
    """JAX's `make_serving_fn` on the same slides at the same pads (its XLA
    attention route)."""
    jcfg = _xla(jcfg)
    ds = jdata.load_splits([1.0, 0.0, 0.0], seed=0, config=jcfg)[0]
    bag, tables, _ = jdata.collate_batch(ds, indices, level0_bucket=1,
                                         row_bucket=1, grid_bucket=1,
                                         pads=pads)
    out = jax.jit(jexport.make_serving_fn(jcfg))(
        params, jexport.bag_to_dict(bag), jexport.tables_to_dicts(tables))
    return np.asarray(out["pred"])


def test_roundtrip_matches_live_and_jax(exported):
    """Weights as arguments: equal to the port's live forward to the bit,
    within TOL of JAX's on the same weights; the graph calls the flash
    operator once per decoder layer per level."""
    root, d, jcfg, tcfg, model, paths = exported
    exp = _load(paths["args"])
    assert exp.platforms == ["cpu"]
    frozen, batch, pads = texport.artifact_signature(exp)
    assert (frozen, batch) == (False, 4)
    bag_d, tab_d = _batch(tcfg, pads, [0, 1, 2, 3])
    out = _call(exp, dict(model.named_parameters()), bag_d, tab_d)
    live = _live(tcfg, model, bag_d, tab_d)
    for k in ("pred", "logits"):
        torch.testing.assert_close(out[k], live[k], rtol=0, atol=0)
    assert len(out["importances"]) == tcfg.num_levels
    for a, b in zip(out["importances"], live["importances"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    nodes = [n for n in exp.program("cpu").graph.nodes
             if OP in str(n.target)]
    assert len(nodes) == tcfg.num_levels * tcfg.model_config.trans_layers
    params = recursive_init(jax.random.PRNGKey(0), jcfg)
    np.testing.assert_allclose(out["pred"].numpy(),
                               _jax_pred(jcfg, params, pads, [0, 1, 2, 3]),
                               atol=TOL, rtol=0)


def test_frozen_weights(exported):
    """The frozen artifact takes no params: the weights are the program's,
    and its output equals the weights-as-args artifact's."""
    _, _, _, tcfg, model, paths = exported
    frozen_exp, args_exp = _load(paths["frozen"]), _load(paths["args"])
    frozen, batch, pads = texport.artifact_signature(frozen_exp)
    assert frozen and batch == 4
    assert texport.artifact_signature(args_exp)[2] == pads
    bag_d, tab_d = _batch(tcfg, pads, [2, 3, 4, 5])
    got = _call(frozen_exp, bag_d, tab_d)["pred"]
    want = _call(args_exp, dict(model.named_parameters()), bag_d,
                 tab_d)["pred"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert len(frozen_exp.program().state_dict) == len(
        dict(model.named_parameters()))
    assert not args_exp.program().state_dict
    # nor the example batch: a flagship one is 1.7 GiB of tables
    assert args_exp.program().example_inputs is None


def test_cli_platforms(exported, tmp_path):
    """`--platforms` takes cuda and cpu: a cuda program needs a card, and a
    platform the port does not build for raises."""
    _, d, _, _, _, _ = exported
    out = str(tmp_path / "x.pt2z")
    with pytest.raises(ValueError, match="tpu"):
        texport_main(["-m", d, "-o", out, "--platforms", "tpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            texport_main(["-m", d, "-o", out])
    assert not os.path.exists(out)


def test_poly_batch(exported):
    """One artifact with a symbolic batch axis serves batch sizes never seen
    at export, equal to the live forward; its pads are the fixed one's."""
    _, _, _, tcfg, model, paths = exported
    exp = _load(paths["poly"])
    frozen, batch, pads = texport.artifact_signature(exp)
    assert not frozen and batch is None
    assert pads == texport.artifact_signature(_load(paths["args"]))[2]
    params = dict(model.named_parameters())
    for idx in ([1], [0, 2, 5]):
        bag_d, tab_d = _batch(tcfg, pads, idx)
        out = _call(exp, params, bag_d, tab_d)
        assert out["pred"].shape[0] == len(idx)
        torch.testing.assert_close(out["pred"],
                                   _live(tcfg, model, bag_d, tab_d)["pred"],
                                   rtol=0, atol=0)


def test_artifact_signature_matches_jax(exported):
    """The port's signature of an artifact equals JAX's `artifact_signature`
    of JAX's export of the same first batch, pads included."""
    _, d, jcfg, tcfg, _, paths = exported
    train, val, test = jdata.load_splits([0.7, 0.15, 0.15], jcfg.seed, jcfg)
    pads = jdata.union_pads(*(s.global_pads() for s in (train, val, test)
                              if s is not None))
    bag, tables, _ = jdata.collate_batch(
        train, list(range(4)), level0_bucket=jcfg.level0_bucket, pads=pads)
    jcfg_x = _xla(jcfg)
    params = recursive_init(jax.random.PRNGKey(0), jcfg_x)
    jexp = jexport.load_serving(jexport.export_serving(jcfg_x, params, bag,
                                                       tables))
    assert (texport.artifact_signature(_load(paths["args"]))
            == jexport.artifact_signature(jexp))


@pytest.mark.parametrize("variant", [
    dict(task="subtype_classification", filter_to_subtypes=["IDC", "ILC"]),
    dict(model_kw=dict(pos_encoding_mode="1d")),
    dict(model_kw=dict(lstm=False, hierarchical_ctx=False)),
], ids=["subtype", "pe1d", "rnn"])
def test_export_model_variants(tmp_path, variant):
    """Configurations the flagship does not use: the subtype task, 1d
    positional encoding, the RNN context instead of the LSTM; each artifact
    equals its live forward to the bit (`tests/test_export.py`'s check)."""
    d, jcfg, tcfg = _model_dir(str(tmp_path), seed=3, **dict(variant))
    model = load_model(d, RecursiveModel(tcfg)).eval().requires_grad_(False)
    ds = tdata.load_splits([1.0, 0.0, 0.0], 0, tcfg)[0]
    pads = tdata.union_pads(ds.global_pads())
    bag, tables = tdata.collate_batch(ds, [0, 1], level0_bucket=1,
                                      row_bucket=1, grid_bucket=1, pads=pads,
                                      device="cpu")
    exp = texport.load_serving(texport.export_serving(tcfg, model, bag,
                                                      tables))
    bag_d, tab_d = texport.bag_to_dict(bag), texport.tables_to_dicts(tables)
    got = _call(exp, dict(model.named_parameters()), bag_d, tab_d)["pred"]
    torch.testing.assert_close(got, _live(tcfg, model, bag_d, tab_d)["pred"],
                               rtol=0, atol=0)


def test_flash_op_checks_and_exports():
    """The operator passes `torch.library.opcheck` (schema, fake shapes and
    types, dispatch) in f32 and bf16, and a module that calls it exports on
    the CPU as one node that runs the plain version."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 70, 32, generator=g) for _ in range(3))
    ln = torch.tensor([70, 9], dtype=torch.int32)
    for dt, bk in ((torch.float32, 128), (torch.bfloat16, 64)):
        torch.library.opcheck(tfa.flash_attention_fwd,
                              (q.to(dt), k.to(dt), v.to(dt), ln, bk))

    class M(torch.nn.Module):
        def forward(self, q, k, v, ln):
            return tfa.flash_attention_fwd(q * 2, k, v, ln, 128)

    ep = torch.export.export(M(), (q, k, v, ln))
    assert sum(OP in str(n.target) for n in ep.graph.nodes) == 1
    out, lse = ep.module()(q, k, v, ln)
    want = tfa.flash_attention_reference(q * 2, k, v, ln, 128)
    torch.testing.assert_close(out, want[0], rtol=0, atol=0)
    torch.testing.assert_close(lse, want[1], rtol=0, atol=0)
    assert lse.dtype == torch.float32


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_session_artifact_matches_live(exported, flavour):
    """`ServingSession(artifact=...)` against the live session over the same
    store: requests of 1, 3 and 6 slides (a fixed artifact always runs its
    batch of 4; the poly one pads to 1, 4, 4+2)."""
    _, d, _, _, _, paths = exported
    sess = ServingSession(d, artifact=paths[flavour], device="cpu",
                          cache_batches=0)
    live = ServingSession(d, device="cpu", cache_batches=0)
    assert sess.info()["backend"] == ("frozen-artifact" if flavour == "frozen"
                                      else "artifact")
    assert (sess._params is None) == (flavour == "frozen")
    ids = live.slide_ids
    for req in (ids[:1], ids[1:4], ids):
        assert sess.predict(req) == live.predict(req)


def test_session_rejects_slides_beyond_the_artifact(exported, tmp_path):
    """A slide preprocessed after the export, larger than its pads: the
    request raises the ValueError that names it; the others still serve."""
    root, d, jcfg, _, _, paths = exported
    big = str(tmp_path / "big")
    make_synthetic_store(big, jcfg, num_slides=7, base_hw=(6, 6), seed=9)
    store = str(tmp_path / "store")
    shutil.copytree(jcfg.preprocess_dir, store)
    for fn in os.listdir(big):
        if fn.startswith("SYN-0006"):
            shutil.copy(os.path.join(big, fn), store)
    sess = ServingSession(d, store_root=store, artifact=paths["args"],
                          device="cpu", cache_batches=0)
    with pytest.raises(ValueError, match="SYN-0006-01Z-00.*Re-export"):
        sess.predict(["SYN-0006-01Z-00"])
    assert len(sess.predict(["SYN-0000-01Z-00"])) == 1


def test_cli_predict_artifact_matches_live(exported, tmp_path):
    _, d, _, _, _, paths = exported
    outs = {}
    for name, extra in (("live", []), ("artifact", ["--artifact",
                                                    paths["args"]])):
        outs[name] = str(tmp_path / f"{name}.csv")
        tpredict(["-m", d, "--split", "all", "-o", outs[name],
                  "--device", "cpu"] + extra)
    rows = [list(csv.reader(open(outs[n], newline=""))) for n in outs]
    assert rows[0] == rows[1] and len(rows[0]) == 7


def test_cli_serve_artifact_over_http(exported, monkeypatch):
    """`cli.serve --artifact`: a prediction over HTTP equals the session's
    (the live one: an artifact session's equal it, as tested above)."""
    import http.client
    import json

    from paths_tpu_torch.cli import serve as tserve

    _, d, _, _, _, paths = exported
    servers = []
    real = tserve.make_server

    def capture(*args, **kwargs):
        servers.append(real(*args, **kwargs))
        return servers[-1]

    monkeypatch.setattr(tserve, "make_server", capture)
    t = threading.Thread(target=tserve.main, args=(
        ["-m", d, "--artifact", paths["frozen"], "--device", "cpu",
         "--port", "0"],), daemon=True)
    t.start()
    for _ in range(600):
        if servers:
            break
        t.join(0.1)
    server = servers[0]
    try:
        conn = http.client.HTTPConnection(*server.server_address[:2],
                                          timeout=60)
        sess = ServingSession(d, device="cpu")
        ids = sess.slide_ids[:3]
        conn.request("POST", "/predict", body=json.dumps({"slide_ids": ids}))
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read())["predictions"] == sess.predict(ids)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["backend"] == (
            "frozen-artifact")
        conn.close()
    finally:
        server.shutdown()
        t.join(30)
