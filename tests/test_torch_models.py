"""The port's layers, processor and hierarchy engine against the JAX package.

Weights: JAX params from `recursive_init` (or the layer's own init), flattened
with `paths_tpu.train.state._flatten` and loaded through the port's
converter. Inputs: numpy from a fixed seed, handed to both. Everything runs
in f32 on the CPU, where the packages differ only in summation order, so
outputs agree to about 1e-5; selections (top-K indices, compaction order,
child locations) must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paths_tpu.config import Config as JConfig
from paths_tpu.config import PATHSProcessorConfig as JPConfig
from paths_tpu.engine import hierarchy as jh
from paths_tpu.models.batch import PatchBag as JBag
from paths_tpu.models.processor import processor_apply as j_processor_apply
from paths_tpu.models.recursive import recursive_init
from paths_tpu.nn import attention as jattn
from paths_tpu.nn import transformer as jtr
from paths_tpu.ops.masking import masked_topk as j_masked_topk
from paths_tpu.train.state import _flatten

from paths_tpu_torch import convert
from paths_tpu_torch.config import Config, PATHSProcessorConfig
from paths_tpu_torch.engine import hierarchy as th
from paths_tpu_torch.models.batch import PatchBag
from paths_tpu_torch.models.processor import processor_apply
from paths_tpu_torch.nn.attention import MultiheadAttention
from paths_tpu_torch.nn.transformer import DecoderLayer, Transformer
from paths_tpu_torch.ops.masking import masked_topk

TOL = 1e-5  # f32 on the CPU, different summation order

SMALL = dict(patch_embed_dim=32, trans_dim=16, trans_heads=2, trans_layers=2,
             importance_mlp_hidden_dim=8, hierarchical_ctx_mlp_hidden_dim=8,
             dropout=0.0)


def small_configs(attention_impl="xla", **mc_kw):
    """The same small config in both packages: 3 levels, K=4."""
    mc = {**SMALL, **mc_kw}
    kw = dict(num_levels=3, top_k_patches=4, nbins=4, level0_bucket=16,
              attention_impl=attention_impl)
    return (JConfig(model_config=JPConfig(**mc), **kw),
            Config(model_config=PATHSProcessorConfig(**mc), **kw))


def model_pair(jcfg, tcfg, seed=0):
    params = recursive_init(jax.random.PRNGKey(seed), jcfg)
    return params, convert.from_jax_flat(_flatten(params), tcfg).eval()


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def _mha_pair(dim, heads, seed):
    jp = jattn.mha_init(jax.random.PRNGKey(seed), dim, heads)
    return jp, convert.load_jax_flat(MultiheadAttention(dim, heads), _flatten(jp))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mha_matches_jax(monkeypatch, impl):
    """Self-attention with a prefix mask, both attention routes (the port's
    "pallas" route runs the plain flash version on the CPU)."""
    import paths_tpu.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "INTERPRET", True)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 21, 16)).astype(np.float32)
    valid = np.arange(21)[None] < np.array([21, 1, 9])[:, None]
    jp, mha = _mha_pair(16, 2, 0)
    want = jattn.mha_apply(jp, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                           key_valid=jnp.asarray(valid), impl=impl)
    got = mha(t(x), t(x), t(x), key_valid=t(valid), impl=impl)
    close(got, want)


def test_empty_memory_cross_attention_returns_out_bias():
    jp, mha = _mha_pair(16, 2, 3)
    with torch.no_grad():
        mha.out.bias.uniform_(-1, 1)
    x = torch.randn(2, 5, 16)
    got = mha(x, x[:, :0], x[:, :0])
    close(got, np.broadcast_to(mha.out.bias.detach().numpy(), (2, 5, 16)),
          tol=0)


def test_decoder_layer_matches_jax():
    rng = np.random.default_rng(2)
    jp = jtr.decoder_layer_init(jax.random.PRNGKey(4), 16, 2, 64)
    # nonzero biases and norms so that every parameter is exercised
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), jp)
    layer = convert.load_jax_flat(DecoderLayer(16, 2, 64), _flatten(jp))
    x = rng.normal(size=(2, 11, 16)).astype(np.float32)
    valid = np.arange(11)[None] < np.array([11, 4])[:, None]
    mem = np.zeros((2, 0, 16), np.float32)
    want = jtr.decoder_layer_apply(jp, jnp.asarray(x), jnp.asarray(mem),
                                   tgt_valid=jnp.asarray(valid))
    got = layer(t(x), t(mem), tgt_valid=t(valid))
    close(got, want)


@pytest.mark.parametrize("n_src", [0, 7])
def test_transformer_matches_jax(n_src):
    """The encoder runs only over a non-empty source; PATHS passes an
    empty one, so the decoder's cross-attention returns its bias."""
    rng = np.random.default_rng(6)
    jp = jtr.transformer_init(jax.random.PRNGKey(5), 16, 2, 2, 64)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), jp)
    tr = convert.load_jax_flat(Transformer(16, 2, 2, 64), _flatten(jp))
    src = rng.normal(size=(2, n_src, 16)).astype(np.float32)
    tgt = rng.normal(size=(2, 9, 16)).astype(np.float32)
    src_valid = np.arange(n_src)[None] < np.array([n_src, 3])[:, None]
    tgt_valid = np.arange(9)[None] < np.array([9, 2])[:, None]
    want = jtr.transformer_apply(jp, jnp.asarray(src), jnp.asarray(tgt),
                                 src_valid=jnp.asarray(src_valid),
                                 tgt_valid=jnp.asarray(tgt_valid))
    got = tr(t(src), t(tgt), src_valid=t(src_valid), tgt_valid=t(tgt_valid))
    close(got, want)


def test_masked_topk_ties_go_to_lowest_index():
    vals = np.array([[0.5, 0.9, 0.5, 0.9, 0.5, 0.1],
                     [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 1], [0, 1, 0, 1, 1, 1]], bool)
    want_idx, want_valid = j_masked_topk(jnp.asarray(vals), jnp.asarray(mask), 5)
    idx, valid = masked_topk(t(vals), t(mask), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert idx[0].tolist() == [1, 3, 0, 2, 5]


def test_compaction_is_stable_valid_first():
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=(3, 17)) < 0.4
    a = rng.normal(size=(3, 17, 2)).astype(np.float32)
    jm, ja = jh._compact(jnp.asarray(mask), jnp.asarray(a))
    tm, ta = th._compact(t(mask), t(a))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def _random_bag(rng, b, n, depth, ctx_dim, d):
    ds, dp = ctx_dim
    n_valid = np.array([n, 3, 1][:b])
    mask = np.arange(n)[None] < n_valid[:, None]
    fts = (rng.normal(size=(b, n, d)) * mask[..., None]).astype(np.float32)
    return dict(
        fts=fts, locs=(rng.integers(0, 9, size=(b, n, 2)) * 256).astype(np.int32),
        mask=mask, parent_inds=np.tile(np.arange(n, dtype=np.int32), (b, 1)),
        ctx_slide=rng.normal(size=(b, depth, ds)).astype(np.float32),
        ctx_patch=rng.normal(size=(b, n, depth, dp)).astype(np.float32))


@pytest.mark.parametrize("lstm,pe,ctx", [
    (True, "2d", "residual"), (True, "1d", "concat"),
    (False, "2d", "concat"), (False, "1d", "residual"),
])
@pytest.mark.parametrize("depth", [0, 2])
def test_processor_matches_jax(lstm, pe, ctx, depth):
    jcfg, tcfg = small_configs(lstm=lstm, pos_encoding_mode=pe,
                               slide_ctx_mode=ctx)
    params, model = model_pair(jcfg, tcfg, seed=depth)
    rng = np.random.default_rng(depth)
    arrays = _random_bag(rng, 3, 12, depth, tcfg.model_config.ctx_dim(),
                         tcfg.model_config.patch_embed_dim)
    want = j_processor_apply(
        params["procs"][depth], jcfg.model_config, jcfg, depth,
        JBag(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        lstm_params=params.get("lstm"))
    got = processor_apply(
        model.procs[depth], tcfg.model_config, tcfg, depth,
        PatchBag(**{k: t(v).long() if k in ("locs", "parent_inds") else t(v)
                    for k, v in arrays.items()}),
        lstm=getattr(model, "lstm", None))
    for key in ("logits", "ctx_slide", "ctx_patch", "importance"):
        close(got[key], want[key])


def write_edge_store(root, cfg, rng):
    """Grids for the hierarchy edge cases, written with the port's store:
    a normal slide, a bag smaller than K (2 cells), a slide whose level-1
    grid is all background (fallback to raw cells), and one whose kept
    patches have only background children while tissue lies elsewhere
    (fallback to the non-background rows)."""
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.synthetic import synthetic_grid

    store = FeatureStore(root, create=True)
    d = cfg.model_config.patch_embed_dim
    powers = cfg.power_levels()

    def tissue_at(h, w, cells):
        g = np.zeros((h, w, d), np.float32)
        for y, x in cells:
            g[y, x] = rng.normal(size=d)
        return g

    slides = {
        "A-normal": [synthetic_grid(rng, 3 * 2**i, 4 * 2**i, d) for i in range(3)],
        "B-small": [synthetic_grid(rng, 1 * 2**i, 2 * 2**i, d, 1.0)
                    for i in range(3)],
        "C-allbg": [synthetic_grid(rng, 2, 3, d, 1.0), np.zeros((4, 6, d), np.float32),
                    synthetic_grid(rng, 8, 12, d)],
        "D-elsewhere": [tissue_at(3, 3, [(0, 0)]), tissue_at(6, 6, [(5, 5)]),
                        synthetic_grid(rng, 12, 12, d)],
    }
    for sid, grids in slides.items():
        for g, p in zip(grids, powers):
            store.save(sid, p, g)
    return sorted(slides)


def test_end2end_forward_matches_jax(tmp_path):
    """Selections, importances and logits at every level, with a bag
    smaller than K and both all-background fallbacks in the batch."""
    from paths_tpu.data.dataset import collate_batch as j_collate
    from paths_tpu.data.feature_store import FeatureStore as JStore
    from paths_tpu.serve import serving_dataset
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
    from paths_tpu_torch.data.feature_store import FeatureStore

    jcfg, tcfg = small_configs(pos_encoding_mode="1d")
    ids = write_edge_store(str(tmp_path), tcfg, np.random.default_rng(7))
    params, model = model_pair(jcfg, tcfg, seed=3)

    jds = serving_dataset(jcfg, JStore(str(tmp_path)), ids)
    jbag, jtables, _ = j_collate(jds, range(len(ids)), level0_bucket=16)
    tds = SlideDataset(ids, tcfg, FeatureStore(str(tmp_path)))
    tbag, ttables = collate_batch(tds, range(len(ids)), level0_bucket=16,
                                  device="cpu")

    jouts = jh.end2end_forward(params, jcfg, jbag, jtables)
    with torch.no_grad():
        touts = th.end2end_forward(model, tcfg, tbag, ttables)

    fallback = []
    for lvl, (jo, to) in enumerate(zip(jouts, touts)):
        for f in ("mask", "locs", "parent_inds"):
            np.testing.assert_array_equal(getattr(to["bag"], f).numpy(),
                                          np.asarray(getattr(jo["bag"], f)),
                                          err_msg=f"level {lvl} {f}")
        close(to["bag"].fts, jo["bag"].fts)
        close(to["importance"], jo["importance"])
        close(to["logits"], jo["logits"])
        if lvl + 1 < len(jouts):
            k = tcfg.top_k_patches[lvl]
            idx, _ = masked_topk(to["importance"], to["bag"].mask, k)
            jidx, _ = j_masked_topk(jo["importance"], jo["bag"].mask, k)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            sel = th.select_children(to["bag"], to, k, 256)
            fallback.append(th.lookup_device(sel, ttables[lvl])["use_fallback"])
    # the batch really went through both fallbacks and the small bag
    assert fallback[0][ids.index("C-allbg")] and fallback[0][ids.index("D-elsewhere")]
    assert int(tbag.mask[ids.index("B-small")].sum()) < tcfg.top_k_patches[0]

    loss, pred = th.task_loss(tcfg, touts[-1]["logits"],
                              {"survival_bin": np.array([0, 1, 3, 2]),
                               "censored": np.array([0, 1, 0, 1])})
    jloss, jpred = jh.task_loss(jcfg, jouts[-1]["logits"],
                                {"survival_bin": jnp.array([0, 1, 3, 2]),
                                 "censored": jnp.array([0, 1, 0, 1])})
    close(pred, jpred)
    close(loss, jloss)


def test_converter_round_trip():
    jcfg, tcfg = small_configs()
    params, model = model_pair(jcfg, tcfg)
    flat = _flatten(params)
    back = convert.to_jax_flat(model)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # a missing key is an error, not a silently random weight
    flat.pop(next(iter(flat)))
    with pytest.raises(RuntimeError):
        convert.from_jax_flat(flat, tcfg)


def test_config_loads_like_jax(tmp_path):
    from paths_tpu_torch.config import Config as TConfig

    for d in ("models/brca_paths_0", "models/sample"):
        want = JConfig.load(d, test_mode=True).to_dict()
        assert TConfig.load(d, test_mode=True).to_dict() == want
    bad = dataclasses.asdict(small_configs()[1])
    bad["not_a_key"] = 1
    (tmp_path / "config.json").write_text(__import__("json").dumps(bad))
    with pytest.raises(ValueError):
        TConfig.load(str(tmp_path), test_mode=True)
