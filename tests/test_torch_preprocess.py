"""The port's preprocess path against the JAX package's on the CPU: masking,
tissue proportions, bucketing, the pipeline (`process_level`, `process_slide`,
`process_slides`) with a dummy encoder, where the grids must be bit-equal,
and the CLI end to end with a small ViT.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paths_tpu.data.feature_store import FeatureStore as JStore
from paths_tpu.preprocess import masking as jmasking
from paths_tpu.preprocess import pipeline as jpipe
from paths_tpu.preprocess import wsi as jwsi
from paths_tpu_torch.data.feature_store import FeatureStore as TStore
from paths_tpu_torch.preprocess import masking as tmasking
from paths_tpu_torch.preprocess import pipeline as tpipe
from paths_tpu_torch.preprocess import wsi as twsi

DIM = 32


def make_fake_slide(rows=512, cols=768, seed=0):
    """White background with a dark tissue blob in the left half."""
    rng = np.random.default_rng(seed)
    img = np.full((rows, cols, 3), 240, np.uint8)
    img[:, :] += rng.integers(0, 10, (rows, cols, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:rows, 0:cols]
    blob = ((yy - rows // 2) ** 2 + (xx - cols // 4) ** 2) < (rows // 3) ** 2
    tissue = rng.integers(80, 160, (rows, cols, 3)).astype(np.uint8)
    img[blob] = tissue[blob]
    return img, blob


def j_encode(imgs):
    """Dummy encoder in exact integer arithmetic: both packages' versions
    give the same float32 bits."""
    x = jnp.asarray(imgs)[:, ::4, ::4, :]
    return x.reshape(x.shape[0], -1)[:, :DIM].astype(jnp.float32) + 1.0


def t_encode(imgs):
    x = imgs[:, ::4, ::4, :]
    return x.reshape(x.shape[0], -1)[:, :DIM].float() + 1.0


def test_masking_matches_jax():
    img, blob = make_fake_slide()
    assert tmasking.otsu_threshold(tmasking.rgb_to_gray(img)) == \
        jmasking.otsu_threshold(jmasking.rgb_to_gray(img))
    mask = tmasking.tissue_mask(img)
    assert np.array_equal(mask, jmasking.tissue_mask(img))
    assert mask[blob].mean() > 0.95 and mask[~blob].mean() < 0.05
    for a, b in zip(tmasking.tissue_masks([img[:100], img[100:]]),
                    jmasking.tissue_masks([img[:100], img[100:]])):
        assert np.array_equal(a, b)


def test_cell_tissue_proportions_matches_jax():
    mask = np.random.default_rng(0).uniform(size=(37, 53)) > 0.5
    got = tpipe.cell_tissue_proportions(mask, 8, 5, 7)
    assert np.array_equal(got, jpipe.cell_tissue_proportions(mask, 8, 5, 7))


def test_camelyon_map_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3), np.uint8)
    img[:3] = 0
    assert np.array_equal(twsi.camelyon_map(img), jwsi.camelyon_map(img))
    assert (twsi.camelyon_map(img)[0, 0] == 255).all()


@pytest.mark.parametrize("batch_size,mult", [(64, 1), (256, 1), (8, 1),
                                             (256, 6), (64, 4)])
def test_bucket_matches_jax(batch_size, mult):
    for width in range(1, batch_size + 1):
        assert tpipe._bucket(width, batch_size, mult) == \
            jpipe._bucket(width, batch_size, mult)


def test_array_wsi_matches_jax():
    img, _ = make_fake_slide(rows=200, cols=300)
    a, b = twsi.ArrayWSI(img, 10.0), jwsi.ArrayWSI(img, 10.0)
    for power in (10.0, 5.0, 1.25):
        assert a.slide_dimensions(power) == b.slide_dimensions(power)
        for loc, size in (((0, 0), (64, 64)), ((-5, 20), (40, 30)),
                          ((90, 140), (64, 64))):
            assert np.array_equal(a.read_rect(loc, size, power),
                                  b.read_rect(loc, size, power))


@pytest.mark.parametrize("power", [10.0, 5.0])
@pytest.mark.parametrize("load_mode", [0, 1])
def test_process_level_bit_equal_to_jax(power, load_mode):
    img, blob = make_fake_slide()
    kw = dict(patch_size=128, tissue_threshold=0.1, downscale=4, batch_size=8,
              threads=2, load_mode=load_mode)
    want = jpipe.process_level(jwsi.ArrayWSI(img, 10.0), j_encode, DIM, power, **kw)
    got = tpipe.process_level(twsi.ArrayWSI(img, 10.0), t_encode, DIM, power,
                              device="cpu", **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if power == 10.0:
        cell_blob = blob.reshape(4, 128, 6, 128).mean(axis=(1, 3))
        assert (np.abs(got[cell_blob > 0.5]).sum(axis=-1) > 0).all()
        assert (np.abs(got[cell_blob == 0]).sum(axis=-1) == 0).all()


def test_process_slide_resume(tmp_path):
    img, _ = make_fake_slide()
    path = str(tmp_path / "slideA.npy")
    np.save(path, img)
    store = TStore(str(tmp_path / "out"), create=True)
    kw = dict(patch_size=128, batch_size=8, threads=2, default_power=10.0,
              device="cpu")
    tpipe.process_slide(path, "slideA", t_encode, DIM, [2.5, 5.0], store, **kw)
    assert store.exists("slideA", 2.5) and store.exists("slideA", 5.0)
    g1 = np.asarray(store.load("slideA", 5.0))
    # resume: an existing grid is kept, not recomputed
    store.save("slideA", 5.0, np.ones_like(g1) * 7)
    tpipe.process_slide(path, "slideA", t_encode, DIM, [5.0], store, **kw)
    assert (np.asarray(store.load("slideA", 5.0)) == 7).all()


def _slides(tmp_path, n=2):
    d = tmp_path / "slides"
    d.mkdir()
    items = []
    for i in range(n):
        img, _ = make_fake_slide(rows=512 + 128 * i, cols=768, seed=i)
        np.save(str(d / f"s{i}.npy"), img)
        items.append((str(d / f"s{i}.npy"), f"s{i}"))
    return items


@pytest.mark.parametrize("case", ["f32_npy", "tail_bucket", "load_mode_1",
                                  "float16", "pt_format"])
def test_process_slides_bit_equal_to_jax(tmp_path, case):
    items = _slides(tmp_path)
    powers = [2.5, 5.0, 10.0]
    kw = dict(patch_size=64, batch_size=8, threads=2, default_power=10.0)
    fmt = "npy"
    if case == "tail_bucket":       # tails of 33..64 cells pad to 64, others to 32
        kw.update(batch_size=64, patch_size=32)
    elif case == "load_mode_1":
        kw.update(load_mode=1)
    elif case == "float16":
        kw.update(store_dtype="float16")
    elif case == "pt_format":
        fmt = "pt"
    jstore = JStore(str(tmp_path / "jax"), create=True, save_format=fmt)
    tstore = TStore(str(tmp_path / "torch"), create=True, save_format=fmt)
    jpipe.process_slides(items, j_encode, DIM, powers, jstore, **kw)
    stats = {}
    tpipe.process_slides(items, t_encode, DIM, powers, tstore, stats=stats,
                         device="cpu", **kw)
    assert stats["h2d_bytes"] > 0 and stats["h2d_busy_s"] >= 0
    assert sorted(os.listdir(jstore.root)) == sorted(os.listdir(tstore.root))
    tissue = 0
    for _, sid in items:
        for power in powers:
            want = np.asarray(jstore.load(sid, power))
            got = np.asarray(tstore.load(sid, power))
            assert got.dtype == want.dtype and np.array_equal(got, want)
            # either package reads the other's store
            assert np.array_equal(np.asarray(JStore(tstore.root).load(sid, power)),
                                  np.asarray(TStore(jstore.root).load(sid, power)))
            tissue += int((np.abs(got).sum(-1) > 0).sum())
    assert tissue > 50
    if case == "float16":
        assert tstore.dtype("s0", 5.0) == np.float16


def test_process_slides_reports_and_skips_unreadable_slide(tmp_path, capsys):
    items = _slides(tmp_path, n=1)
    bad = str(tmp_path / "slides" / "broken.npy")
    with open(bad, "wb") as f:
        f.write(b"not a numpy file")
    store = TStore(str(tmp_path / "out"), create=True)
    tpipe.process_slides([(bad, "broken")] + items, t_encode, DIM, [5.0], store,
                         patch_size=64, batch_size=8, threads=2,
                         default_power=10.0, device="cpu")
    assert "FAILED ON SLIDE broken" in capsys.readouterr().out
    assert store.exists("s0", 5.0) and not store.exists("broken", 5.0)


def test_staging_off_gives_the_same_grids(tmp_path):
    items = _slides(tmp_path, n=1)
    kw = dict(patch_size=64, batch_size=8, threads=2, default_power=10.0,
              device="cpu")
    a = TStore(str(tmp_path / "a"), create=True)
    b = TStore(str(tmp_path / "b"), create=True)
    tpipe.process_slides(items, t_encode, DIM, [5.0], a, **kw)
    tpipe.process_slides(items, t_encode, DIM, [5.0], b, stage_h2d=False, **kw)
    assert np.array_equal(np.asarray(a.load("s0", 5.0)),
                          np.asarray(b.load("s0", 5.0)))


def test_unported_options_raise(tmp_path):
    """`--data-shards` over more cards than the host has raises before any
    work (this host has none; sharded runs: tests/test_torch_parallel.py)."""
    from paths_tpu_torch.cli.preprocess import main

    with pytest.raises(ValueError, match="data mesh of 2 shard"):
        main(["-d", str(tmp_path), "-o", str(tmp_path / "o"),
              "--data-shards", "2"])


def test_feature_store_surface(tmp_path):
    store = TStore(str(tmp_path / "s"), create=True)
    grid = np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.float32)
    assert not store.exists("a", 5.0) and store.dtype("a", 5.0) is None
    store.save("a", 5.0, grid)
    assert store.exists("a", 5.0) and store.dtype("a", 5.0) == np.float32
    assert isinstance(store.load("a", 5.0), np.memmap)
    assert not isinstance(store.load("a", 5.0, mmap=False), np.memmap)
    with pytest.raises(ValueError, match="store_dtype must be float32 or float16"):
        store.save("b", 5.0, grid.astype(np.float64))
    with pytest.raises(ValueError):
        TStore(str(tmp_path / "s"), save_format="zarr")
    with pytest.raises(ValueError, match="store_dtype must be float32 or float16"):
        tpipe._grid_dtype("int8")


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one small slide with kaiko-vits16 from the same seed
    (`vit_init` gives both packages bit-identical weights). The CLIs compute
    in bf16, where the two frameworks sum in other orders: tissue cells agree
    within 2e-2 of the feature norm. The same path in f32 (`from_name` with
    compute_dtype float32 into `process_slides`, as the CLIs call them)
    agrees to 1e-4."""
    from paths_tpu.cli.preprocess import main as jmain
    from paths_tpu.encoders.registry import from_name as jfrom_name
    from paths_tpu_torch.cli.preprocess import main as tmain
    from paths_tpu_torch.encoders.registry import from_name as tfrom_name

    img, _ = make_fake_slide(rows=448, cols=448)
    d = tmp_path / "slides"
    d.mkdir()
    np.save(str(d / "s1.npy"), img)
    argv = ["-m", "kaiko-vits16", "-d", str(d), "-b", "4", "-p", "224", "-ms",
            "10.0", "--default-power", "10.0", "--ext", ".npy"]
    jmain(argv + ["-o", str(tmp_path / "jax"), "--block-impl", "xla"])
    stats = tmain(argv + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    assert stats["h2d_bytes"] > 0
    want = np.asarray(JStore(str(tmp_path / "jax")).load("s1", 10.0))
    got = np.asarray(TStore(str(tmp_path / "torch")).load("s1", 10.0))
    assert got.shape == want.shape == (2, 2, 384)
    cells = np.abs(want).sum(-1) > 0
    assert cells.any() and np.array_equal(cells, np.abs(got).sum(-1) > 0)
    rel = (np.linalg.norm(got - want, axis=-1)[cells]
           / np.linalg.norm(want, axis=-1)[cells])
    assert rel.max() < 2e-2

    items = [(str(d / "s1.npy"), "s1")]
    kw = dict(patch_size=224, batch_size=4, default_power=10.0)
    jenc, dim, _ = jfrom_name("kaiko-vits16", compute_dtype=jnp.float32,
                              block_impl="xla")
    jpipe.process_slides(items, jenc, dim, [10.0],
                         JStore(str(tmp_path / "jax32"), create=True), **kw)
    tenc, dim, _ = tfrom_name("kaiko-vits16", compute_dtype=torch.float32,
                              device="cpu")
    tpipe.process_slides(items, tenc, dim, [10.0],
                         TStore(str(tmp_path / "torch32"), create=True),
                         device="cpu", **kw)
    want = np.asarray(JStore(str(tmp_path / "jax32")).load("s1", 10.0))
    got = np.asarray(TStore(str(tmp_path / "torch32")).load("s1", 10.0))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
