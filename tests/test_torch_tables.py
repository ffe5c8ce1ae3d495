"""The table wire dtype of the port (`paths_tpu_torch.engine.tables`)
against the JAX package's: which dtype crosses the link, the mixed-dtype
warning, and that narrowing on the host gives the values a cast on the
device would; and the collation that copies each slide's rows straight into
its row of the batch, held to the host stack it replaced (kept here, frozen,
as the oracle)."""
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from paths_tpu.engine import tables as jtables

from paths_tpu_torch.engine import tables as ttables


def _grid(rng, h, w, d, dtype):
    g = rng.normal(size=(h, w, d)).astype(dtype)
    g[rng.uniform(size=(h, w)) < 0.3] = 0
    return g


@pytest.mark.parametrize("store", ["float16", "float32"])
@pytest.mark.parametrize("target", ["float32", "bfloat16", None])
def test_wire_dtype_matches_jax(store, target):
    want = jtables.wire_dtype(np.dtype(store),
                              None if target is None else
                              np.dtype(getattr(ml_dtypes, target, target)))
    got = ttables.wire_dtype(np.dtype(store), target)
    assert str(got).removeprefix("torch.") == want.name


def test_host_stack_dtype_warns_once_per_pair(monkeypatch):
    monkeypatch.setattr(ttables, "_warned_mixed_dtypes", set())
    f16, f32 = np.dtype(np.float16), np.dtype(np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert ttables.host_stack_dtype([f16, f16]) == f16
        assert ttables.host_stack_dtype([f16, f32, f16]) == f32
        assert ttables.host_stack_dtype([f32, f16]) == f32
        assert ttables.host_stack_dtype([f16, np.dtype(np.float64)]) == \
            np.float64
    assert len(caught) == 2
    assert "mixes storage dtypes ['float16', 'float32']" in str(caught[0].message)
    assert caught[0].filename == __file__     # the caller's line


def _old_fill_rows(dst, i, src):
    """The host stack's fill, frozen: dst[i, :len(src)] = src on the host,
    cast to dst's dtype."""
    n = src.shape[0]
    if dst.dtype == torch.bfloat16:
        dst[i, :n] = torch.from_numpy(np.array(src, np.float32))
    else:
        dst.numpy()[i, :n] = src


def _old_stack_host(tables, min_rows=0, pad_rows_to=None, pad_grid_to=None,
                    dtype=None):
    """The host stack the port collated through before it copied each
    slide's rows straight to the device, frozen as the oracle: every table
    padded and stacked on the host, the features at `wire_dtype(storage,
    dtype)`."""
    b = len(tables)
    m = max(max(t["fts"].shape[0] for t in tables), min_rows)
    if pad_rows_to is not None:
        m = max(m, pad_rows_to)
    h = max(t["index"].shape[0] for t in tables)
    w = max(t["index"].shape[1] for t in tables)
    if pad_grid_to is not None:
        h, w = max(h, pad_grid_to[0]), max(w, pad_grid_to[1])
    d = tables[0]["fts"].shape[1]
    host_dt = ttables.host_stack_dtype([t["fts"].dtype for t in tables])
    fts = torch.zeros((b, m, d), dtype=ttables.wire_dtype(host_dt, dtype))
    locs = np.zeros((b, m, 2), np.int32)
    count = np.zeros((b,), np.int32)
    index = np.full((b, h, w), -1, np.int32)
    grid_hw = np.zeros((b, 2), np.int32)
    for i, t in enumerate(tables):
        mi = t["fts"].shape[0]
        hi, wi = t["index"].shape
        _old_fill_rows(fts, i, t["fts"])
        locs[i, :mi] = t["locs"]
        count[i] = t["count"]
        index[i, :hi, :wi] = t["index"]
        grid_hw[i] = t["grid_hw"]
    return {"fts": fts, "locs": torch.from_numpy(locs),
            "count": torch.from_numpy(count), "index": torch.from_numpy(index),
            "grid_hw": torch.from_numpy(grid_hw)}


@pytest.mark.parametrize("store", [np.float32, np.float16])
def test_bf16_tables_cross_at_two_bytes(store, monkeypatch):
    """Under a bf16 table dtype the host tensor handed to the copy is 2
    bytes wide (bf16 from an f32 store, f16 from an f16 store) and the
    tables equal a cast of the stacked store on the device; f32 tables from
    an f16 store cross at f16 and widen there."""
    rng = np.random.default_rng(0)
    tables = [ttables.build_level_table(_grid(rng, h, w, 16, store),
                                        min_rows=8)
              for h, w in ((4, 5), (3, 3), (6, 2))]
    host32 = _old_stack_host(tables, min_rows=8, pad_rows_to=32,
                             pad_grid_to=(8, 8))
    assert host32["fts"].dtype == torch.from_numpy(np.zeros(0, store)).dtype
    crossed = []
    real = ttables.host_rows

    def spy(rows, dtype):
        crossed.append(real(rows, dtype))
        return crossed[-1]

    monkeypatch.setattr(ttables, "host_rows", spy)
    wire = torch.bfloat16 if store == np.float32 else torch.float16
    lt = ttables.stack_tables(tables, min_rows=8, pad_rows_to=32,
                              pad_grid_to=(8, 8), dtype=torch.bfloat16,
                              device="cpu")
    assert [c.dtype for c in crossed] == [wire] * 3
    assert all(c.element_size() == 2 for c in crossed)
    for c, t in zip(crossed, tables):
        assert torch.equal(c, torch.from_numpy(t["fts"]).to(wire))
    assert torch.equal(lt.fts, host32["fts"].to(torch.bfloat16))
    lt32 = ttables.stack_tables(tables, min_rows=8, pad_rows_to=32,
                                pad_grid_to=(8, 8), dtype=torch.float32,
                                device="cpu")
    assert lt32.fts.dtype == torch.float32
    assert torch.equal(lt32.fts, host32["fts"].float())
    for key in ("locs", "count", "index", "grid_hw"):
        assert getattr(lt, key).dtype == torch.int64
        assert torch.equal(getattr(lt, key), host32[key].long())


@pytest.mark.parametrize("store,table,wire", [
    (np.float32, torch.bfloat16, torch.bfloat16),
    (np.float16, torch.float32, torch.float16),
    (np.float32, torch.float32, torch.float32)])
def test_ship_at_wire_dtype(store, table, wire):
    """The lookup dict reaches `put` at the wire dtype and leaves it at the
    table dtype, with the values of a cast on the device."""
    rng = np.random.default_rng(1)
    lk = {"fts": rng.normal(size=(2, 8, 16)).astype(store),
          "mask": rng.uniform(size=(2, 8)) < 0.5,
          "locs": rng.integers(0, 9, (2, 8, 2)).astype(np.int32)}
    seen = {}

    def put(host):
        seen.update(host)
        return {k: v.clone() for k, v in host.items()}

    dev = ttables.ship_at_wire_dtype(lk, table, put)
    assert seen["fts"].dtype == wire
    assert dev["fts"].dtype == table
    assert torch.equal(dev["fts"], torch.from_numpy(lk["fts"]).to(table))
    assert torch.equal(dev["mask"], torch.from_numpy(lk["mask"]))


def test_collate_bag0_ships_at_wire_dtype(monkeypatch):
    """`collate_bag0` under a bf16 table dtype hands a 2-byte host tensor to
    the copy."""
    from test_torch_train import configs

    from paths_tpu_torch.data import dataset as tdata

    staged = []
    real = ttables.fill_rows

    def spy(dst, i, src):
        staged.append(dst.dtype)
        return real(dst, i, src)

    monkeypatch.setattr(tdata, "fill_rows", spy)

    class Slide:
        def __init__(self, n):
            grid = np.arange(n * 32, dtype=np.float32).reshape(n, 1, 32) / 7
            self.level0 = ttables.level0_bag_arrays(grid, 256)

    class Data:
        config = configs("/nonexistent", table_dtype="bfloat16")[1]
        slides = [Slide(5), Slide(3)]

    bag = tdata.collate_bag0(Data, [0, 1], level0_bucket=8, device="cpu")
    assert staged == [torch.bfloat16] * 2
    assert bag.fts.dtype == torch.bfloat16
    want = torch.from_numpy(Data.slides[0].level0[0]).to(torch.bfloat16)
    assert torch.equal(bag.fts[0, :5], want)


def test_f16_background_test_matches_jax():
    """An f16 grid's background (rows with no nonzero entry, -0.0 counting
    as zero) is found by an integer test on the bits in the port; the table
    equals JAX's, built with its f16 compare, on rows of zeros, of -0.0, of
    one subnormal entry and of one -0.0 beside a live entry."""
    rng = np.random.default_rng(4)
    g = _grid(rng, 6, 7, 16, np.float16)
    g[0, 1] = -0.0
    g[2, 3] = 0
    g[2, 3, 5] = np.float16(6e-8)          # a subnormal half: live
    g[4, 4, 0] = -0.0                      # beside live entries
    g[5, 6] = 0
    g[5, 6, 9] = -np.float16(6e-8)
    got = ttables.build_level_table_numpy(g, min_rows=48)
    want = jtables.build_level_table(g, min_rows=48)
    assert int(got["count"]) == int(want["count"]) == int(
        np.any(g.reshape(-1, 16) != 0, axis=1).sum())
    for k in ("fts", "locs", "index", "grid_hw"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _old_collate(ds, indices, level0_bucket, row_bucket=256, grid_bucket=16,
                 pads=None, seq=None):
    """`collate_batch` through the frozen host stack (the oracle): the
    level-0 bag and every level's table stacked on the host at the wire
    dtype, then cast to the table dtype. Returns the bag's features, locs
    and mask and each table's fields."""
    from paths_tpu_torch.data.dataset import _round_up
    from paths_tpu_torch.models.batch import seq_block_width

    cfg = ds.config
    dtype = getattr(torch, cfg.table_dtype)
    slides = [ds.slides[i] for i in indices]
    l0 = [s.level0 for s in slides]
    max_n0 = max(x[2] for x in l0)
    if pads is not None:
        max_n0 = max(max_n0, pads["n0"])
    n0 = _round_up(max_n0, level0_bucket)
    rows, first = n0, 0
    if seq is not None:
        rows = seq_block_width(n0, seq[1])
        first = seq[0] * rows - 1
    host_dt = ttables.host_stack_dtype([f.dtype for f, _, _ in l0])
    fts0 = torch.zeros((len(l0), rows, cfg.model_config.patch_embed_dim),
                       dtype=ttables.wire_dtype(host_dt, dtype))
    locs0 = np.zeros((len(l0), rows, 2), np.int32)
    mask0 = np.zeros((len(l0), rows), bool)
    for i, (f, l, n) in enumerate(l0):
        lo, hi = max(first, 0), min(n, first + rows)
        if hi > lo:
            _old_fill_rows(fts0[:, lo - first:], i, f[lo:hi])
            locs0[i, lo - first: hi - first] = l[lo:hi]
            mask0[i, lo - first: hi - first] = True
    bag = {"fts": fts0.to(dtype), "locs": torch.from_numpy(locs0).long(),
           "mask": torch.from_numpy(mask0)}
    widths = ttables.bag_widths(cfg.top_k_patches, cfg.num_levels, n0)
    tables = []
    for lvl in range(1, cfg.num_levels):
        per = [s.tables[lvl - 1] for s in slides]
        max_rows = max(t["fts"].shape[0] for t in per)
        max_h = max(t["index"].shape[0] for t in per)
        max_w = max(t["index"].shape[1] for t in per)
        if pads is not None:
            max_rows = max(max_rows, pads["rows"][lvl])
            max_h = max(max_h, pads["grid_hw"][lvl][0])
            max_w = max(max_w, pads["grid_hw"][lvl][1])
        host = _old_stack_host(
            per, min_rows=widths[lvl],
            pad_rows_to=_round_up(max(widths[lvl], max_rows), row_bucket),
            pad_grid_to=(_round_up(max_h, grid_bucket),
                         _round_up(max_w, grid_bucket)), dtype=dtype)
        tables.append({"fts": host["fts"].to(dtype),
                       **{k: v.long() for k, v in host.items() if k != "fts"}})
    return bag, tables


@pytest.fixture(scope="module")
def collate_store(tmp_path_factory):
    """Two 6-slide stores of 3 levels, 32 wide: one f16, and one f32 but
    for slides 1 and 4, whose grids are f16."""
    from paths_tpu_torch.config import Config, PATHSProcessorConfig
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.synthetic import make_synthetic_store

    roots = {}
    for name, store_dtype in (("f16", np.float16), ("mixed", np.float32)):
        root = str(tmp_path_factory.mktemp(f"collate_{name}"))
        cfg = Config(model_config=PATHSProcessorConfig(
            patch_embed_dim=32, trans_dim=16, trans_heads=2, trans_layers=2),
            num_levels=3, top_k_patches=4, level0_bucket=16)
        ids = make_synthetic_store(root, cfg, num_slides=6, base_hw=(3, 4),
                                   seed=5, store_dtype=store_dtype)
        if name == "mixed":
            store = FeatureStore(root)
            for sid in (ids[1], ids[4]):
                for power in cfg.power_levels():
                    store.save(sid, power, np.asarray(
                        store.load(sid, power)).astype(np.float16))
        roots[name] = (root, ids)
    return roots


# (store, table dtype, collate_batch's keywords, indices, cache_slides)
COLLATE_CASES = {
    "f16_store_f32_tables": ("f16", "float32", {}, [0, 2, 3], True),
    "f32_store_bf16_tables": ("mixed", "bfloat16", {}, [0, 2, 3], True),
    "mixed_store_f32_tables": ("mixed", "float32", {}, [0, 1, 4, 5], True),
    "mixed_store_bf16_tables": ("mixed", "bfloat16", {}, [1, 2, 4], True),
    "global_pads": ("mixed", "float32", {"pads": True}, [0, 1, 3], True),
    "buckets_of_one": ("f16", "float32", {"level0_bucket": 1,
                                          "row_bucket": 1,
                                          "grid_bucket": 1}, [0, 3, 5], True),
    "seq_block_0": ("f16", "float32", {"seq": (0, 3)}, [0, 1, 2], True),
    "seq_block_2": ("mixed", "bfloat16", {"seq": (2, 3)}, [1, 2, 4], True),
    "unheld": ("mixed", "float32", {}, [1, 2, 4], False),
    "padded_by_last": ("f16", "float32", {}, [3, 0, 5, 5, 5], True),
}


@pytest.mark.parametrize("case,pin", [
    (case, pin) for case in sorted(COLLATE_CASES)
    for pin in (("none", "fails", "emulated") if COLLATE_CASES[case][4]
                else ("none",))])      # an unheld slide is never page-locked
def test_collation_equals_the_host_stack(collate_store, monkeypatch, case, pin):
    """`collate_batch` copies each slide's rows straight into its row of a
    batch made zero on the device, and gives, bit for bit, the tensors of
    the host stack it replaced (`_old_collate`): f16 and f32 stores under
    f32 and bf16 tables, a batch mixing f16 and f32 slides, global pads,
    buckets of one, a sequence block, unheld slides and a batch padded by
    repeating its last slide; collated three times, the second of which
    page-locks the held slides. `pin` runs the held-slide path of a card on
    the CPU: page-locked copies that cannot be had (the pageable fallback),
    or stood in for by pageable tensors (the copies and views the slide
    then holds)."""
    from paths_tpu_torch.config import Config, PATHSProcessorConfig
    from paths_tpu_torch.data import dataset as tdata
    from paths_tpu_torch.data.feature_store import FeatureStore

    store, table_dtype, kw, idx, held = COLLATE_CASES[case]
    root, ids = collate_store[store]
    cfg = Config(model_config=PATHSProcessorConfig(
        patch_embed_dim=32, trans_dim=16, trans_heads=2, trans_layers=2),
        num_levels=3, top_k_patches=4, level0_bucket=16,
        table_dtype=table_dtype)
    ds = tdata.SlideDataset(ids, cfg, FeatureStore(root), cache_slides=held)
    ref = tdata.SlideDataset(ids, cfg, FeatureStore(root))
    kw = dict(kw)
    if kw.pop("pads", False):
        kw["pads"] = ds.global_pads()
    if pin != "none":
        monkeypatch.setattr(tdata, "_pins", lambda dataset, device: True)
    pins, real_empty = [], torch.empty

    def empty(*a, pin_memory=False, **k):
        if pin_memory:
            pins.append(a)
            if pin == "fails":
                raise RuntimeError("no page-locked memory")
        return real_empty(*a, **k)

    monkeypatch.setattr(torch, "empty", empty)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # the mixed-dtype warning
        want_bag, want_tables = _old_collate(
            ref, idx, kw.get("level0_bucket", cfg.level0_bucket),
            **{k: v for k, v in kw.items() if k != "level0_bucket"})
        kw.setdefault("level0_bucket", cfg.level0_bucket)
        for n in range(3):          # pageable, pins, reuses the copies
            bag, tables = tdata.collate_batch(ds, idx, device="cpu", **kw)
            for k, want in want_bag.items():
                got = getattr(bag, k)
                assert got.dtype == want.dtype and torch.equal(got, want), k
            assert len(tables) == len(want_tables)
            for lt, want in zip(tables, want_tables):
                for k, v in want.items():
                    got = getattr(lt, k)
                    assert got.dtype == v.dtype and torch.equal(got, v), k
            if n == 0:
                assert pins == []
    distinct = sorted(set(idx))
    slides = [ds.slides[i] for i in distinct]
    rows = [[s.level0[0]] + [t["fts"] for t in s.tables] for s in slides]
    wires = [[s.level0_wire] + [t.get("fts_wire") for t in s.tables]
             for s in slides]
    if pin == "emulated":       # one copy a level of each slide collated
        assert len(pins) == cfg.num_levels * len(distinct)
        for s, rs, ws in zip(slides, rows, wires):
            assert s.pinned_bytes > 0
            for r, w in zip(rs, ws):
                assert w.shape == r.shape
                assert w.dtype == ttables.wire_dtype(r.dtype, table_dtype)
                if ttables.as_torch_dtype(r.dtype) == w.dtype:  # held once
                    assert r.ctypes.data == w.data_ptr()
    else:       # never page-locked, or none to be had: tried once a slide
        assert len(pins) == (len(distinct) if pin == "fails" else 0)
        assert all(w is None for ws in wires for w in ws)
        assert all(s.pinned_bytes == 0 for s in ds.slides)


@pytest.mark.parametrize("budget,batches,locked", [
    (None, [[0, 1, 2], [3, 4, 5]], []),               # a one-pass sweep
    (None, [[0, 1, 2], [2, 0, 4, 4]], [0, 2]),        # reused: 0 and 2
    (0, [[0, 1, 2], [0, 1, 2]], []),                  # locking turned off
    ("two", [[0, 1, 2], [2, 1, 0], [0, 1, 2]], [2, 1]),   # room for two
])
def test_reused_slides_locked_within_the_budget(collate_store, monkeypatch,
                                                budget, batches, locked):
    """A held slide bound for a card is page-locked at its second collation
    (`_pin_reused`), never at its first, in batch order while the dataset's
    `pin_bytes` leaves room (a slide repeated within a batch is collated
    once), and the rest stay pageable; `pinned_bytes` is the allocator's
    power-of-two blocks. Page-locking stood in for on the CPU."""
    from paths_tpu_torch.config import Config, PATHSProcessorConfig
    from paths_tpu_torch.data import dataset as tdata
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.slide import locked_bytes

    root, ids = collate_store["f16"]
    cfg = Config(model_config=PATHSProcessorConfig(
        patch_embed_dim=32, trans_dim=16, trans_heads=2, trans_layers=2),
        num_levels=3, top_k_patches=4, level0_bucket=16)
    monkeypatch.setattr(tdata, "_pins", lambda dataset, device: True)
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        real_empty(*a, **k))
    probe = tdata.SlideDataset(ids, cfg, FeatureStore(root))
    need = [sum(locked_bytes(r.nbytes) for r in
                [s.level0[0]] + [t["fts"] for t in s.tables])
            for s in probe.slides]
    if budget == "two":             # slides 2 and 1 fit, then not slide 0
        budget = need[2] + need[1] + need[0] - 1
    ds = tdata.SlideDataset(ids, cfg, FeatureStore(root))
    if budget is not None:
        ds.pin_bytes = budget
    for b in batches:
        tdata.collate_batch(ds, b, device="cpu", level0_bucket=16)
    assert [i for i, s in enumerate(ds.slides) if s.level0_wire is not None] \
        == sorted(locked)
    assert [s.pinned_bytes for s in ds.slides] == [
        need[i] if i in locked else 0 for i in range(len(ds.slides))]
