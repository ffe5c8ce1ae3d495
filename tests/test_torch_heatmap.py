"""The port's heatmap entry point on the CPU, against the JAX package.

The same synthetic slide (`test_raw_slide.slide_file`), the same weights
(JAX's `recursive_init`, carried over by `from_jax_flat`) and twin dummy
encoders (a channel mean tiled to the feature width) feed both packages.
Slide reading, masking and the recursion's choices are numpy in both and
must be equal; the model runs in f32 in both and differs in summation order
only: importances and logits agree to 1e-5. The golden raster is held at
`tests/test_heatmap_golden.py`'s own tolerances.
"""
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from paths_tpu.config import Config as JConfig
from paths_tpu.config import PATHSProcessorConfig as JPConfig
from paths_tpu.data import raw_slide as jraw
from paths_tpu.models.recursive import recursive_init
from paths_tpu.train.state import _flatten
from paths_tpu.viz import heatmap as jhm
from test_heatmap_golden import FIXTURE
from test_raw_slide import dummy_encoder, slide_file

from paths_tpu_torch import convert
from paths_tpu_torch.config import Config, PATHSProcessorConfig
from paths_tpu_torch.data import raw_slide as traw
from paths_tpu_torch.viz import heatmap as thm

TOL = 1e-5  # f32 on the CPU, different summation order

SMALL = dict(patch_embed_dim=12, trans_dim=8, trans_heads=2, trans_layers=1,
             importance_mlp_hidden_dim=8, hierarchical_ctx_mlp_hidden_dim=8,
             pos_encoding_mode="2d", patch_size=64)


def configs(**kw):
    """`test_raw_slide.small_cfg` in both packages."""
    kw = dict(num_levels=3, top_k_patches=2, nbins=2, **kw)
    return (JConfig(model_config=JPConfig(**SMALL), **kw),
            Config(model_config=PATHSProcessorConfig(**SMALL), **kw))


def torch_dummy_encoder(dim=12):
    """The twin of `test_raw_slide.dummy_encoder` on tensors."""
    def encode(imgs):
        pooled = imgs.mean(dim=(1, 2))
        return pooled.repeat(1, dim // 3 + 1)[:, :dim] + 0.5
    return encode


def model_pair(jcfg, tcfg, seed=0):
    params = recursive_init(jax.random.PRNGKey(seed), jcfg)
    return params, convert.from_jax_flat(_flatten(params), tcfg).eval()


def test_patchify_locs_matches_jax():
    img = np.random.default_rng(0).integers(0, 255, (12, 8, 3), np.uint8)
    for got, want in zip(traw.patchify_locs(img, 4, (10, 20)),
                         jraw.patchify_locs(img, 4, (10, 20))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["blob", "white"])
def test_load_raw_slide_matches_jax(tmp_path, kind):
    """Tissue filtering, its threshold halving and, on an all-white slide,
    the one-patch fallback."""
    if kind == "blob":
        path, _, _ = slide_file(tmp_path)
        threshold = 0.1
    else:
        path = os.path.join(str(tmp_path), "white.npy")
        np.save(path, np.full((512, 512, 3), 245, np.uint8))
        threshold = 0.5
    ctx = configs()[1].model_config.ctx_dim()
    got = traw.load_raw_slide(path, 10.0, 64, ctx, tissue_threshold=threshold)
    want = jraw.load_raw_slide(path, 10.0, 64, ctx, tissue_threshold=threshold)
    assert got.patches.shape[0] >= 1
    for name in ("patches", "locs", "parent_inds", "ctx_patch"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.size_pixels == want.size_pixels


def test_encode_bag_matches_jax(tmp_path):
    """Buckets of 8 (the body) and a smaller tail; features within 1e-5
    (the dummy encoders average 4096 pixels in different orders),
    everything else equal."""
    path, _, _ = slide_file(tmp_path)
    ctx = configs()[1].model_config.ctx_dim()
    slide = traw.load_raw_slide(path, 20.0, 64, ctx, tissue_threshold=0.1)
    jslide = jraw.load_raw_slide(path, 20.0, 64, ctx, tissue_threshold=0.1)
    assert slide.patches.shape[0] % 8
    got = traw.encode_bag(slide, torch_dummy_encoder(), batch_size=8,
                          device="cpu")
    want = jraw.encode_bag(jslide, dummy_encoder(), batch_size=8)
    np.testing.assert_allclose(got.fts.numpy(), np.asarray(want.fts),
                               atol=TOL, rtol=0)
    for name in ("locs", "mask", "parent_inds", "ctx_slide", "ctx_patch"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_run_recursion_matches_jax(tmp_path, monkeypatch, impl):
    """Per depth the same patches (locs), importances and the final logits
    within 1e-5; "pallas" runs JAX's kernel in the Pallas interpreter and the
    port's plain version of #1."""
    monkeypatch.setattr(fa, "INTERPRET", True)
    path, _, _ = slide_file(tmp_path)
    jcfg, tcfg = configs(base_power=10.0, attention_impl=impl)
    params, model = model_pair(jcfg, tcfg)
    kw = dict(tissue_threshold=0.1, camelyon=False, default_power=40.0,
              verbose=False)
    jslides, jimps, jlogits = jhm.run_recursion(jcfg, params, dummy_encoder(),
                                                path, **kw)
    slides, imps, logits = thm.run_recursion(tcfg, model,
                                             torch_dummy_encoder(), path,
                                             device="cpu", **kw)
    assert len(slides) == len(jslides) == tcfg.num_levels
    for s, js, imp, jimp in zip(slides, jslides, imps, jimps):
        np.testing.assert_array_equal(s.locs, js.locs)
        np.testing.assert_array_equal(s.parent_inds, js.parent_inds)
        np.testing.assert_allclose(imp, jimp, atol=TOL, rtol=0)
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=TOL, rtol=0)


def test_folded_importance_and_viewport_match_jax():
    rng = np.random.default_rng(0)
    P, H, W = 64, 250, 310
    slides, imps = [], []
    for depth in range(3):
        size = P >> depth
        gh, gw = H // size + 1, W // size + 1
        n = int(rng.integers(1, 8))
        cells = rng.choice(gh * gw, size=n, replace=False)
        ys, xs = np.divmod(cells, gw)
        locs = np.stack([ys, xs], 1) * P
        locs[0] = -P                   # off the slide's edge: dropped
        slides.append(SimpleNamespace(locs=locs))
        imps.append(rng.normal(size=n).astype(np.float32))
    np.testing.assert_array_equal(
        thm.folded_importance(slides, imps, P, (H, W)),
        jhm.folded_importance(slides, imps, P, (H, W)))
    for s in slides:
        assert thm._viewport_ylim(s, P, H) == jhm._viewport_ylim(s, P, H)


def test_camelyon_xml_matches_jax(tmp_path):
    xml = """<?xml version="1.0"?>
<ASAP_Annotations>
  <Annotations>
    <Annotation Name="A0" Type="Polygon" PartOfGroup="Tumor" Color="#F4FA58">
      <Coordinates>
        <Coordinate Order="0" X="100.5" Y="200.5"/>
        <Coordinate Order="1" X="300.0" Y="200.0"/>
        <Coordinate Order="2" X="200.0" Y="400.0"/>
      </Coordinates>
    </Annotation>
    <Annotation Name="A1" Type="Polygon" PartOfGroup="Tumor" Color="#00FF00">
      <Coordinates>
        <Coordinate Order="0" X="1" Y="2"/>
        <Coordinate Order="1" X="3" Y="4"/>
      </Coordinates>
    </Annotation>
  </Annotations>
  <AnnotationGroups>
    <Group Name="Tumor" PartOfGroup="None" Color="#F4FA58"/>
  </AnnotationGroups>
</ASAP_Annotations>"""
    p = os.path.join(str(tmp_path), "anno.xml")
    with open(p, "w") as f:
        f.write(xml)
    got = thm.parse_camelyon17_anno_file(p)
    assert got == jhm.parse_camelyon17_anno_file(p) and len(got) == 2
    with open(p, "w") as f:
        f.write(xml.replace('Group Name="Tumor"', 'Group Name="Other"'))
    with pytest.raises(ValueError):
        thm.parse_camelyon17_anno_file(p)


def _store_model(tmp, tcfg_kw=None):
    """A 2-slide synthetic store and a model directory over it in both
    packages' config format, with JAX's weights."""
    from paths_tpu.data.synthetic import make_synthetic_store
    from test_train_loop import tiny_train_config

    jcfg = tiny_train_config(tmp)
    ids = make_synthetic_store(jcfg.preprocess_dir, jcfg, num_slides=2,
                               base_hw=(3, 3))
    mdir = os.path.join(tmp, "model")
    jcfg.save(mdir)
    tcfg = Config.load(mdir, test_mode=True)
    params, model = model_pair(jcfg, tcfg)
    return jcfg, tcfg, ids, mdir, params, model


def test_recursion_from_store_matches_jax(tmp_path):
    """The `--slide-id` path: per-depth valid locs equal and importances
    within 1e-5 of JAX's fused forward over the same slide."""
    from paths_tpu.data.dataset import collate_batch
    from paths_tpu.data.feature_store import FeatureStore as JStore
    from paths_tpu.engine.hierarchy import end2end_forward
    from paths_tpu.serve import serving_dataset

    from paths_tpu_torch.data.feature_store import FeatureStore

    jcfg, tcfg, ids, _, params, model = _store_model(str(tmp_path))
    ds = serving_dataset(jcfg, JStore(jcfg.preprocess_dir), [ids[1]])
    bag0, tables, _ = collate_batch(ds, [0], level0_bucket=jcfg.level0_bucket)
    outs = end2end_forward(params, jcfg, bag0, tables)
    slides, imps = thm.recursion_from_store(
        tcfg, model, ids[1], FeatureStore(tcfg.preprocess_dir), device="cpu")
    for s, imp, out in zip(slides, imps, outs):
        valid = np.asarray(out["bag"].mask[0])
        np.testing.assert_array_equal(s.locs, np.asarray(out["bag"].locs[0])[valid])
        np.testing.assert_allclose(imp, np.asarray(out["importance"][0])[valid],
                                   atol=TOL, rtol=0)


def test_heatmap_cli_slide_id_reads_model_pt(tmp_path):
    """`--slide-id` on a model directory holding the reference's `model.pt`
    only; exactly one of --slide-path / --slide-id."""
    from paths_tpu_torch.cli.heatmap import main

    tmp = str(tmp_path)
    _, _, ids, mdir, _, model = _store_model(tmp)
    convert.save_torch_checkpoint(os.path.join(mdir, "model.pt"), model)
    out = os.path.join(tmp, "hm_store.pdf")
    assert main(["-m", mdir, "--slide-id", ids[0], "-o", out,
                 "--device", "cpu"]) == out
    assert os.path.isfile(out) and os.path.getsize(out) > 1000
    with pytest.raises(SystemExit):
        main(["-m", mdir, "-o", out, "--device", "cpu"])


def test_heatmap_cli_without_matplotlib_runs_the_recursion(tmp_path,
                                                          monkeypatch, capsys):
    """On a host without matplotlib the CLI runs the same recursion, draws
    nothing and returns None; a window asked for still needs it."""
    import sys

    from paths_tpu_torch.cli.heatmap import main

    tmp = str(tmp_path)
    _, _, ids, mdir, _, model = _store_model(tmp)
    convert.save_torch_checkpoint(os.path.join(mdir, "model.pt"), model)
    calls = []
    real = thm.recursion_from_store
    monkeypatch.setattr(thm, "recursion_from_store",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = os.path.join(tmp, "hm_none.pdf")
    assert main(["-m", mdir, "--slide-id", ids[0], "-o", out,
                 "--device", "cpu"]) is None
    assert calls == [1] and not os.path.exists(out)
    assert "figure not drawn" in capsys.readouterr().out
    with pytest.raises(ImportError):
        thm._pyplot(show=True)


def test_heatmap_cli_slide_path(tmp_path):
    """`--slide-path` with the kaiko-vits16 encoder (random weights, the
    plain route on the CPU) on the raw slide; a model.npz written by JAX."""
    from paths_tpu.train.state import save_state

    from paths_tpu_torch.cli.heatmap import main

    path, _, _ = slide_file(tmp_path)
    jcfg, _ = configs()
    jcfg.model_config.patch_embed_dim = 384       # kaiko-vits16's width
    mdir = os.path.join(str(tmp_path), "model")
    jcfg.save(mdir)
    save_state(mdir, recursive_init(jax.random.PRNGKey(0), jcfg))
    out = os.path.join(str(tmp_path), "hm_cli.pdf")
    main(["-m", mdir, "-s", path, "-o", out, "--encoder", "kaiko-vits16",
          "--no-camelyon", "--tissue-threshold", "0.05",
          "--default-power", "40", "--device", "cpu"])
    assert os.path.isfile(out) and os.path.getsize(out) > 1000


def test_heatmap_matches_golden(tmp_path):
    """The port's recursion and renderer against
    `tests/fixtures/heatmap_golden.npz` (JAX's render), as
    `tests/test_heatmap_golden.py` holds JAX's."""
    from PIL import Image

    path, _, _ = slide_file(tmp_path)
    jcfg, tcfg = configs(base_power=10.0)
    _, model = model_pair(jcfg, tcfg)
    enc = torch_dummy_encoder()
    P = tcfg.model_config.patch_size
    kw = dict(tissue_threshold=0.1, camelyon=False, default_power=40.0)
    slides, imps, logits = thm.run_recursion(tcfg, model, enc, path,
                                             device="cpu", **kw)
    H, W = slides[0].view_at_power(tcfg.base_power).shape[:2]
    canvas = thm.folded_importance(slides, imps, P, (H, W))
    ylim = thm._viewport_ylim(slides[0], P, H)

    png = os.path.join(str(tmp_path), "hm.png")
    thm.heatmap_slide(tcfg, model, enc, path, None, png, device="cpu", **kw)
    raster = np.asarray(Image.open(png).convert("RGB"), np.float32)
    h, w = raster.shape[:2]
    ry = np.linspace(0, h, 65).astype(int)
    rx = np.linspace(0, w, 97).astype(int)
    fp = np.array([[raster[ry[i]:max(ry[i + 1], ry[i] + 1),
                           rx[j]:max(rx[j] + 1, rx[j + 1])].mean(axis=(0, 1))
                    for j in range(96)] for i in range(64)])

    ref = np.load(FIXTURE)
    np.testing.assert_array_equal(np.asarray(ylim, np.int64), ref["ylim"])
    np.testing.assert_allclose(logits, ref["logits"], atol=1e-5)
    np.testing.assert_allclose(canvas.astype(np.float32), ref["canvas"],
                               atol=1e-5)
    diff = np.abs(fp.astype(np.float32) - ref["raster_fp"])
    assert diff.mean() < 3.0 and diff.max() < 60.0, (diff.mean(), diff.max())


def test_pad_bag_is_inert():
    """Padding a bag to a wider width changes no valid output."""
    from paths_tpu_torch.models.batch import PatchBag, pad_bag
    from paths_tpu_torch.models.recursive import recursive_apply

    jcfg, tcfg = configs()
    _, model = model_pair(jcfg, tcfg)
    g = torch.Generator().manual_seed(0)
    n, (ds, dp) = 5, tcfg.model_config.ctx_dim()
    bag = PatchBag(fts=torch.rand((1, n, 12), generator=g),
                   locs=torch.randint(0, 8, (1, n, 2), generator=g) * 64,
                   mask=torch.ones((1, n), dtype=torch.bool),
                   parent_inds=torch.arange(n)[None],
                   ctx_slide=torch.zeros((1, 0, ds)),
                   ctx_patch=torch.zeros((1, n, 0, dp)))
    with torch.no_grad():
        a = recursive_apply(model, tcfg, 0, bag)
        b = recursive_apply(model, tcfg, 0, pad_bag(bag, 32))
    assert pad_bag(bag, 3) is bag
    torch.testing.assert_close(b["importance"][:, :n], a["importance"],
                               atol=1e-6, rtol=0)
    assert torch.all(b["importance"][:, n:] == 0)
    torch.testing.assert_close(b["logits"], a["logits"], atol=1e-6, rtol=0)
