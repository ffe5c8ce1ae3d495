"""The table wire dtype of the port (`paths_tpu_torch.engine.tables`)
against the JAX package's: which dtype crosses the link, the mixed-dtype
warning, and that narrowing on the host gives the values a cast on the
device would."""
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


@pytest.mark.parametrize("store", [np.float32, np.float16])
def test_bf16_tables_cross_at_two_bytes(store):
    """Under a bf16 table dtype the host tensor handed to the copy is 2
    bytes wide (bf16 from an f32 store, f16 from an f16 store) and the
    tables equal a cast of the stacked store on the device; f32 tables from
    an f16 store cross at f16 and widen there."""
    rng = np.random.default_rng(0)
    tables = [ttables.build_level_table(_grid(rng, h, w, 16, store),
                                        min_rows=8)
              for h, w in ((4, 5), (3, 3), (6, 2))]
    host32 = ttables.stack_host(tables, min_rows=8, pad_rows_to=32,
                                pad_grid_to=(8, 8))
    assert host32["fts"].dtype == torch.from_numpy(np.zeros(0, store)).dtype
    host = ttables.stack_host(tables, min_rows=8, pad_rows_to=32,
                              pad_grid_to=(8, 8), dtype=torch.bfloat16)
    wire = torch.bfloat16 if store == np.float32 else torch.float16
    assert host["fts"].dtype == wire and host["fts"].element_size() == 2
    assert torch.equal(host["fts"], host32["fts"].to(wire))
    lt = ttables.stack_tables(tables, min_rows=8, pad_rows_to=32,
                              pad_grid_to=(8, 8), dtype=torch.bfloat16,
                              device="cpu")
    assert torch.equal(lt.fts, host32["fts"].to(torch.bfloat16))
    lt32 = ttables.stack_tables(tables, min_rows=8, pad_rows_to=32,
                                pad_grid_to=(8, 8), dtype=torch.float32,
                                device="cpu")
    assert lt32.fts.dtype == torch.float32
    assert torch.equal(lt32.fts, host32["fts"].float())
    for key in ("locs", "count", "index", "grid_hw"):
        assert getattr(lt, key).dtype == torch.int64
        assert torch.equal(getattr(lt, key), host[key].long())


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
