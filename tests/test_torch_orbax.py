"""Orbax checkpoints in the port without JAX (`paths_tpu_torch.train.orbax`,
`train/ocdbt.py`, `train/zarr.py`, `native/zstd.py`) on the CPU, against the
JAX package's Orbax backend.

A checkpoint that JAX's `save_state(backend="orbax")` writes (an OCDBT store,
zstd through the host's libzstd) is read by the port equal to the bit:
every parameter, AdamW's moments and counts and the hyperparameters, with
and without the gradient-norm clip's chain. A checkpoint the port writes is
restored by JAX's `load_state` equal to the bit, with the `_METADATA` tree
JAX writes for the same state. The OCDBT reader and the zarr decoder are
also held to tensorstore's own stores: deeper b-trees, uncompressed and
zstd nodes, chunked arrays and chunks elided at the fill value.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from paths_tpu.models.recursive import recursive_init
from paths_tpu.train import loop as jloop
from paths_tpu.train import state as jstate
from test_torch_train import configs, store  # noqa: F401

from paths_tpu_torch import convert
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.native import zstd
from paths_tpu_torch.train import loop as tloop
from paths_tpu_torch.train import ocdbt, orbax, zarr
from paths_tpu_torch.train import state as tstate

CLIPS = [None, 1e-3]


def _jax_state(tmp, clip, seed=0, count=7):
    """JAX params and an AdamW state with random moments and both counts at
    `count`, as after `count` steps."""
    jcfg, _ = configs(tmp, clip_grad_norm=clip)
    params = recursive_init(jax.random.PRNGKey(seed), jcfg)
    opt = jloop.make_optimizer(jcfg).init(params)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 10_000))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "count" in name:
            return jnp.asarray(count, leaf.dtype)
        if ".mu" in name or ".nu" in name:
            return jax.random.uniform(next(keys), leaf.shape, leaf.dtype)
        return leaf

    return jcfg, params, jax.tree_util.tree_map_with_path(fill, opt)


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("clip", CLIPS)
def test_jax_written_orbax_reads_bitwise(tmp_path, store, clip):
    """`read_orbax` of JAX's checkpoint gives JAX's npz flat dicts; the
    port's `load_state` then holds those weights, moments and count."""
    tmp, _, _ = store
    jcfg, params, opt = _jax_state(tmp, clip)
    jstate.save_state(str(tmp_path), params, opt, {"epoch": 4},
                      backend="orbax")
    assert ocdbt.read_store(str(tmp_path / "orbax"))   # OCDBT, as JAX writes
    got_params, got_opt = orbax.read_orbax(str(tmp_path / "orbax"))
    _same(got_params, jstate._flatten(params))
    _same(got_opt, jstate._flatten(opt))

    _, tcfg = configs(tmp, clip_grad_norm=clip)
    model = tloop.RecursiveModel(tcfg)
    optimizer = tloop.make_optimizer(tcfg, model.parameters())
    model, optimizer, stats = tstate.load_state(
        str(tmp_path), model, optimizer, clip_grad_norm=clip)
    assert stats == {"epoch": 4}
    _same(convert.to_jax_flat(model), jstate._flatten(params))
    _same(tstate.optimizer_to_jax_flat(model, optimizer, clip),
          jstate._flatten(opt))


@pytest.mark.parametrize("clip", CLIPS)
def test_port_written_orbax_restores_in_jax(tmp_path, store, clip):
    """The port's `save_state(backend="orbax")`: JAX's `load_state` restores
    it equal to the bit, into a full template and params-only, and its
    `_METADATA` tree is the one JAX writes for the same state."""
    tmp, _, _ = store
    jcfg, params, opt = _jax_state(tmp, clip, seed=2)
    _, tcfg = configs(tmp, clip_grad_norm=clip)
    model = convert.from_jax_flat(jstate._flatten(params), tcfg)
    optimizer = tloop.make_optimizer(tcfg, model.parameters())
    tstate.load_optimizer_jax_flat(model, optimizer, jstate._flatten(opt),
                                   clip)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tstate.save_state(str(tdir), model, optimizer, {"epoch": 5},
                      clip_grad_norm=clip, backend="orbax")
    assert sorted(os.listdir(tdir)) == ["orbax", "train_stats.json"]

    template = recursive_init(jax.random.PRNGKey(9), jcfg)
    tx = jloop.make_optimizer(jcfg)
    lp, lo, stats = jstate.load_state(str(tdir), template, tx.init(template))
    assert stats == {"epoch": 5}
    _same(jstate._flatten(lp), jstate._flatten(params))
    _same(jstate._flatten(lo), jstate._flatten(opt))
    lp, none, _ = jstate.load_state(str(tdir), template)
    assert none is None
    _same(jstate._flatten(lp), jstate._flatten(params))

    jstate.save_state(str(jdir), params, opt, backend="orbax")
    with open(tdir / "orbax" / "_METADATA") as f:
        got = json.load(f)["tree_metadata"]
    with open(jdir / "orbax" / "_METADATA") as f:
        want = json.load(f)["tree_metadata"]
    assert got == want


def test_bf16_leaf(tmp_path):
    """A bfloat16 leaf: JAX's is read as a torch bfloat16 tensor of the
    same bits, and the port's is restored by JAX with its bits."""
    x = jax.random.normal(jax.random.PRNGKey(0), (3, 5)).astype(jnp.bfloat16)
    params = {"a": {"w": x, "b": jnp.arange(4, dtype=jnp.float32)}}
    jstate.save_state(str(tmp_path / "jax"), params, backend="orbax")
    got, opt = orbax.read_orbax(str(tmp_path / "jax" / "orbax"))
    assert opt is None and got["a/w"].dtype == torch.bfloat16
    bits = np.asarray(x).view(np.uint16)
    np.testing.assert_array_equal(got["a/w"].view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    np.testing.assert_array_equal(got["a/b"], np.arange(4, dtype=np.float32))

    orbax.write_orbax(str(tmp_path / "port" / "orbax"), got)
    template = {"a": {"w": jnp.zeros((3, 5), jnp.bfloat16),
                      "b": jnp.zeros(4, jnp.float32)}}
    back, _, _ = jstate.load_state(str(tmp_path / "port"), template)
    assert back["a"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"]["w"]).view(np.uint16),
                                  bits)


@pytest.mark.parametrize("backend,newer", [
    ("npz", "orbax"), ("orbax", "npz"), (None, "orbax"), (None, "npz")])
def test_both_present_rule(tmp_path, store, backend, newer):
    """`orbax/` beside `model.npz`: the configured backend decides, else the
    newer; the port loads the weights JAX loads."""
    tmp, _, _ = store
    jcfg, _ = configs(tmp, checkpoint_backend=backend or "npz")
    jcfg.checkpoint_backend = backend
    p_orbax = recursive_init(jax.random.PRNGKey(1), jcfg)
    p_npz = recursive_init(jax.random.PRNGKey(2), jcfg)
    jstate.save_state(str(tmp_path), p_orbax, backend="orbax")
    jstate.save_state(str(tmp_path), p_npz)
    stamp = {"orbax": 2_000_000_000, "npz": 1_000_000_000}
    if newer == "npz":
        stamp = {"orbax": 1_000_000_000, "npz": 2_000_000_000}
    for root, _, files in os.walk(tmp_path / "orbax"):
        for f in files:
            os.utime(os.path.join(root, f), (stamp["orbax"],) * 2)
    os.utime(tmp_path / "model.npz", (stamp["npz"],) * 2)

    want, _, _ = jstate.load_state(str(tmp_path), p_npz, config=jcfg)
    _, tcfg = configs(tmp)
    model = tstate.load_model(str(tmp_path), tloop.RecursiveModel(tcfg),
                              backend)
    _same(convert.to_jax_flat(model), jstate._flatten(want))
    chosen = backend or newer
    np.testing.assert_array_equal(
        convert.to_jax_flat(model)["procs/0/classification/w"],
        np.asarray((p_orbax if chosen == "orbax"
                    else p_npz)["procs"][0]["classification"]["w"]))


def test_train_loop_resumes_from_jax_orbax(tmp_path, store):
    """A port `train_loop` under `checkpoint_backend: "orbax"` over a
    directory JAX saved at epoch 2: it trains epoch 2 only, starting from
    JAX's weights and optimizer state (the count goes on from 7), and
    writes its checkpoint to `orbax/`."""
    tmp, _, _ = store
    _, params, opt = _jax_state(tmp, None, seed=4)
    jstate.save_state(str(tmp_path), params, opt,
                      {"epoch": 2, "train_loss": {1: 0.5}}, backend="orbax")
    _, tcfg = configs(tmp, checkpoint_backend="orbax", num_epochs=2)
    train, val, test = tdata.load_splits([0.7, 0.15, 0.15], tcfg.seed, tcfg)
    stats = tloop.train_loop(tcfg, str(tmp_path), train, val, test,
                             verbose=False, device="cpu")
    assert set(stats["train_loss"]) == {1, 2}
    assert stats["train_loss"][1] == 0.5
    assert not os.path.exists(tmp_path / "model.npz")
    _, got = orbax.read_orbax(str(tmp_path / "orbax"))
    steps = -(-len(train) // tcfg.batch_size[0])
    assert int(got[".count"]) == 7 + steps
    assert int(got[".inner_state/0/.count"]) == 7 + steps


def test_missing_libzstd_raises_the_documented_error(tmp_path, monkeypatch):
    """Without libzstd a JAX-written (zstd) checkpoint raises the error that
    names the library; the port's own uncompressed format still reads."""
    params = {"w": jnp.ones((2, 3))}
    jstate.save_state(str(tmp_path / "jax"), params, backend="orbax")
    orbax.write_orbax(str(tmp_path / "port"), {"w": np.ones((2, 3),
                                                            np.float32)})
    monkeypatch.setattr(zstd, "find_library", lambda: None)
    zstd._lib.cache_clear()
    try:
        assert not zstd.available()
        with pytest.raises(zstd.ZstdUnavailable,
                           match="libzstd.*Orbax checkpoint reader"):
            orbax.read_orbax(str(tmp_path / "jax" / "orbax"))
        got, _ = orbax.read_orbax(str(tmp_path / "port"))
        np.testing.assert_array_equal(got["w"], np.ones((2, 3), np.float32))
    finally:
        monkeypatch.undo()
        zstd._lib.cache_clear()
    assert zstd.available()


@pytest.mark.parametrize("compression,node_bytes", [
    (None, 150), ({"id": "zstd", "level": 7}, 150), ({"id": "zstd"}, 4096)])
def test_ocdbt_reader_matches_tensorstore(tmp_path, compression, node_bytes):
    """Stores tensorstore writes: small nodes make a b-tree several levels
    deep, 40 commits a version tree, values inline and out of line."""
    spec = ts.KvStore.Spec(f"file://{tmp_path}/|ocdbt:").to_json()
    spec["config"] = {"max_decoded_node_bytes": node_bytes,
                      "max_inline_value_bytes": 6,
                      "compression": compression}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    for i in range(40):
        kv.write(f"commit{i:02d}", bytes(rng.integers(0, 255, i))).result()
    tx = ts.Transaction()
    for i in range(300):
        kv.with_transaction(tx).write(
            f"k{i:04d}/{'ab' * (i % 5)}",
            bytes(rng.integers(0, 255, i % 17))).result()
    tx.commit_async().result()
    want = {k: kv.read(k).result().value for k in kv.list().result()}
    assert ocdbt.read_store(str(tmp_path)) == want


@pytest.mark.parametrize("dtype,order", [
    ("<f4", "C"), ("<i4", "F"), ("bfloat16", "C"), ("<f8", "C")])
def test_zarr_chunks_and_fill_value(tmp_path, dtype, order):
    """A zarr v2 array of ragged chunks, some equal to the fill value (which
    tensorstore does not store), zstd-compressed: read as tensorstore
    reads it."""
    shape, chunks = (7, 10), (3, 4)
    data = np.arange(70, dtype=np.float64).reshape(shape) - 20
    data[3:6, 4:8] = 5   # one whole chunk equal to the fill value
    spec = ts.Spec(f"file://{tmp_path}/arr/|zarr2:").to_json()
    spec.update(create=True, metadata={
        "dtype": dtype, "shape": list(shape), "chunks": list(chunks),
        "order": order, "fill_value": 5,
        "compressor": {"id": "zstd", "level": 1}})
    arr = ts.open(spec).result()
    arr.write(data.astype(arr.dtype.numpy_dtype)).result()
    want = arr.read().result()
    n_chunks = len([f for f in os.listdir(tmp_path / "arr") if f[0] != "."])
    assert n_chunks < 9   # the fill-value chunk was elided

    def get(key):
        path = tmp_path / key
        return path.read_bytes() if path.is_file() else None

    got = zarr.read_array(get, "arr")
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_zstd_roundtrip():
    """One frame and frames back to back, with and without the size."""
    data = bytes(np.random.default_rng(0).integers(0, 4, 100_000, np.uint8))
    frame = zstd.compress(data, 3)
    assert len(frame) < len(data)
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(frame + zstd.compress(b"tail")) == data + b"tail"
    with pytest.raises(ValueError):
        zstd.decompress(frame[:-3])


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "orbax_jax")


def _fixture_state():
    """The small state of the committed JAX-written checkpoint: a list of
    blocks, a bfloat16 leaf and an injected AdamW state with moments."""
    import optax

    rng = np.random.default_rng(0)
    params = {"blocks": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                          "b": np.arange(4, dtype=np.float32) - k}
                         for k in range(2)],
              "scale": jnp.asarray(np.arange(5) / 4, jnp.bfloat16)}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    opt = optax.inject_hyperparams(optax.adamw)(
        learning_rate=1e-3, weight_decay=1e-2).init(params)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    opt = jax.tree_util.tree_map_with_path(
        lambda p, x: (jax.random.uniform(next(keys), x.shape).astype(x.dtype)
                      if ".mu" in jax.tree_util.keystr(p)
                      or ".nu" in jax.tree_util.keystr(p) else x), opt)
    return params, opt


def _expected(params, opt) -> dict:
    """Flat `params/<key>` and `opt/<key>` arrays, bfloat16 as float32."""
    out = {}
    for prefix, tree in (("params", params), ("opt", opt)):
        for k, v in jstate._flatten(tree).items():
            v = np.asarray(v)
            out[f"{prefix}/{k}"] = (v.astype(np.float32)
                                    if v.dtype == jnp.bfloat16 else v)
    return out


def write_fixture(root: str = FIXTURE) -> None:
    """Write `tests/fixtures/orbax_jax` with JAX's Orbax backend:
    `PYTHONPATH=.:tests python tests/test_torch_orbax.py` (the card's `chip_smoke.py` reads it,
    where neither JAX nor tensorstore is installed)."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    params, opt = _fixture_state()
    jstate.save_state(root, params, opt, backend="orbax")
    np.savez(os.path.join(root, "expected.npz"), **_expected(params, opt))


def test_committed_jax_fixture_reads():
    """The committed JAX-written checkpoint: the port reads the state it was
    written from, JAX restores the same, and `expected.npz` beside it (what
    `chip_smoke.py` holds the card host's reader to) is that state."""
    params, opt = _fixture_state()
    want = _expected(params, opt)
    with np.load(os.path.join(FIXTURE, "expected.npz")) as z:
        _same(dict(z.items()), want)
    got_p, got_o = orbax.read_orbax(os.path.join(FIXTURE, "orbax"))
    got = {f"params/{k}": v for k, v in got_p.items()}
    got.update({f"opt/{k}": v for k, v in got_o.items()})
    _same({k: v.float().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}, want)
    lp, lo, _ = jstate.load_state(FIXTURE, *_fixture_state())
    _same(_expected(lp, lo), want)


if __name__ == "__main__":
    write_fixture()
