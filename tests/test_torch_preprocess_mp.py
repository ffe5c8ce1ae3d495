"""The port's multi-process decode (`process_slides(decode_workers >= 2)`) and
JPEG-tiled slides through the preprocess pipeline, against the port's
single-producer path and the JAX package's pipeline on the CPU, with the
exact dummy encoder of `test_torch_preprocess.py` (grids bit-equal)."""
import queue
import shutil

import numpy as np
import pytest
import torch

from paths_tpu.data.feature_store import FeatureStore as JStore
from paths_tpu.preprocess import pipeline as jpipe
from paths_tpu_torch.data.feature_store import FeatureStore as TStore
from paths_tpu_torch.native import build as nbuild
from paths_tpu_torch.preprocess import pipeline as tpipe
from paths_tpu_torch.preprocess import wsi as twsi
from test_torch_preprocess import DIM, j_encode, make_fake_slide, t_encode


@pytest.fixture(scope="module")
def decoders():
    """The port's native decoder built where the host can (the spawn children
    and the parent then both decode through it), else PIL on both."""
    if shutil.which("g++") is None or nbuild.build_jpeg(verbose=False) is None:
        return "pil"
    return "native"


def _slides(tmp_path, decoders):
    """Two .npy slides and one .tiles pyramid of a third."""
    d = tmp_path / "slides"
    d.mkdir()
    items = []
    for i in range(3):
        img, _ = make_fake_slide(rows=512 + 128 * i, cols=768, seed=i)
        if i < 2:
            np.save(str(d / f"s{i}.npy"), img)
            items.append((str(d / f"s{i}.npy"), f"s{i}"))
        else:
            path = twsi.write_tiled_jpeg(img, str(d / f"s{i}.tiles"),
                                         base_power=10.0, tile=128, quality=95)
            assert (twsi.open_wsi(path)._native is not None) == (decoders == "native")
            items.append((path, f"s{i}"))
    return items


POWERS = [2.5, 5.0, 10.0]
KW = dict(patch_size=64, batch_size=8, threads=2, default_power=10.0,
          device="cpu")


def _grids(store, items):
    return {(sid, p): np.asarray(store.load(sid, p))
            for _, sid in items for p in POWERS}


def test_decode_workers_equal_single_producer(tmp_path, decoders):
    """decode_workers=2 (spawn children, one queue) at load_mode 0 and 1 gives
    the grids of decode_workers=0 bit for bit, .tiles slide included. The
    only test here that spawns processes."""
    items = _slides(tmp_path, decoders)
    want = {}
    for lm in (0, 1):
        store = TStore(str(tmp_path / f"serial{lm}"), create=True)
        tpipe.process_slides(items, t_encode, DIM, POWERS, store,
                             load_mode=lm, **KW)
        want[lm] = _grids(store, items)
    assert all(np.array_equal(want[0][k], want[1][k]) for k in want[0])
    for lm in (0, 1):
        store = TStore(str(tmp_path / f"mp{lm}"), create=True)
        stats = {}
        tpipe.process_slides(items, t_encode, DIM, POWERS, store,
                             decode_workers=2, load_mode=lm, stats=stats, **KW)
        got = _grids(store, items)
        assert got.keys() == want[lm].keys()
        for k in got:
            assert got[k].dtype == want[lm][k].dtype
            assert np.array_equal(got[k], want[lm][k]), (lm, k)
        assert stats["h2d_bytes"] > 0
    tissue = sum(int((np.abs(g).sum(-1) > 0).sum()) for g in want[0].values())
    assert tissue > 50


def test_tiles_slide_matches_jax_pipeline(tmp_path, decoders, monkeypatch):
    """A .tiles slide through the port's pipeline equals the JAX package's
    pipeline bit for bit (both decode through PIL here; the native decoders
    are held to each other in test_torch_native.py), and its tissue
    selection is within 15% of the .npy slide's (JPEG moves marginal cells
    only)."""
    from paths_tpu.native import jpeg as jjpeg
    from paths_tpu_torch.native import jpeg as njpeg

    items = _slides(tmp_path, decoders)
    monkeypatch.setattr(jjpeg, "_tried", True)
    monkeypatch.setattr(jjpeg, "_lib", None)
    monkeypatch.setattr(njpeg, "available", lambda: False)
    tiles = [it for it in items if it[0].endswith(".tiles")]
    jstore = JStore(str(tmp_path / "jax"), create=True)
    tstore = TStore(str(tmp_path / "torch"), create=True)
    kw = {k: v for k, v in KW.items() if k != "device"}
    jpipe.process_slides(tiles, j_encode, DIM, POWERS, jstore, **kw)
    tpipe.process_slides(tiles, t_encode, DIM, POWERS, tstore, **KW)
    img, _ = make_fake_slide(rows=768, cols=768, seed=2)
    npy = str(tmp_path / "s2.npy")
    np.save(npy, img)
    nstore = TStore(str(tmp_path / "npy"), create=True)
    tpipe.process_slides([(npy, "s2")], t_encode, DIM, POWERS, nstore, **KW)
    for p in POWERS:
        got = np.asarray(tstore.load("s2", p))
        assert np.array_equal(got, np.asarray(jstore.load("s2", p))), p
        ref = np.asarray(nstore.load("s2", p))
        assert got.shape == ref.shape
        assert (got.any(-1) != ref.any(-1)).mean() <= 0.15, p


class DeadProc:
    def is_alive(self):
        return False


def test_consumer_survives_dead_worker(tmp_path):
    """A decode worker that dies without its `done` sentinel must not hang
    the parent: once no worker is alive, buffered messages drain and the
    consumer returns; a level its feeder flushed first still lands."""
    dim = 6
    store = TStore(str(tmp_path / "store"), create=True)
    cand = np.array([[0, 0], [0, 1]])
    q = queue.Queue()
    key = ("s0", 2.5)
    q.put(("level", (key, 1, 2, cand)))
    q.put(("batch", (key, np.zeros((4, 8, 8, 3), np.uint8), 0, 2)))
    q.put(("flush", key))

    def enc(a):
        return torch.ones((a.shape[0], dim))

    tpipe._consume_decode_queue(q, [DeadProc()], encode=enc, stage_fn=None,
                                dim=dim, store=store, verbose=False,
                                device="cpu", poll_s=0.05)
    got = np.asarray(store.load("s0", 2.5))
    assert got.shape == (1, 2, dim) and np.all(got == 1.0)


def test_consumer_error_drops_half_built_level(tmp_path, capsys):
    """A worker `error` for a level whose header arrived drops the half-built
    grid; later batches and flushes of that key are ignored; other levels
    are unaffected."""
    dim = 3
    store = TStore(str(tmp_path / "store"), create=True)
    cand = np.array([[0, 0]])
    q = queue.Queue()
    bad, good = ("s0", 2.5), ("s0", 5.0)
    arr = np.zeros((2, 8, 8, 3), np.uint8)
    for msg in [("level", (bad, 1, 1, cand)), ("batch", (bad, arr, 0, 1)),
                ("error", ("s0", 2.5, "boom traceback")),
                ("batch", (bad, arr, 0, 1)), ("flush", bad),
                ("level", (good, 1, 1, cand)), ("batch", (good, arr, 0, 1)),
                ("flush", good), ("done", 0)]:
        q.put(msg)

    def enc(a):
        return torch.full((a.shape[0], dim), 2.0)

    tpipe._consume_decode_queue(q, [DeadProc()], encode=enc, stage_fn=None,
                                dim=dim, store=store, verbose=False,
                                device="cpu", poll_s=0.05)
    assert not store.exists("s0", 2.5)
    assert np.all(np.asarray(store.load("s0", 5.0)) == 2.0)
    out = capsys.readouterr().out
    assert "FAILED ON SLIDE s0 AT POWER 2.5" in out and "boom traceback" in out
