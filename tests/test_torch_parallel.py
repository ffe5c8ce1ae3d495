"""The port's data meshes on the CPU, against the JAX package: the mesh
helpers and `runtime.maybe_init_distributed`, the data-parallel serving
session, and sharded preprocessing. Two "devices" of a port mesh are both
the CPU (`make_mesh(devices=["cpu", "cpu"])`); the JAX side runs on the
suite's virtual CPU devices.

Bars: a mesh session's hazards are the one-device session's within 1e-6
relative (each shard is one device's batch of fewer rows) and JAX's mesh
session's within 1e-5 (`tests/test_serve.py::test_session_mesh_data_parallel`);
sharded preprocessing with an integer-exact dummy encoder gives the
one-device grids to the bit and JAX's mesh-staged grids within 1e-6
(`tests/test_preprocess.py::test_process_slides_mesh_sharded_staging`).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from paths_tpu.data.feature_store import FeatureStore as JStore
from paths_tpu.models.recursive import recursive_init
from paths_tpu.parallel import mesh as jmesh
from paths_tpu.preprocess import pipeline as jpipe
from paths_tpu.serve import ServingSession as JSession
from paths_tpu.train.state import save_state
from test_torch_models import small_configs
from test_torch_preprocess import DIM, j_encode, make_fake_slide, t_encode

from paths_tpu_torch import runtime
from paths_tpu_torch.data import dataset as tdata
from paths_tpu_torch.data.feature_store import FeatureStore as TStore
from paths_tpu_torch.data.synthetic import make_synthetic_store
from paths_tpu_torch.parallel import mesh as tmesh
from paths_tpu_torch.preprocess import pipeline as tpipe
from paths_tpu_torch.serve import ServingSession

CPU2 = ["cpu", "cpu"]


# ------------------------------------------------------------------ helpers

def test_mesh_helpers():
    mesh = tmesh.make_mesh(devices=CPU2)
    assert mesh.shape == {"data": 2} and mesh.devices == [torch.device("cpu")] * 2
    assert tmesh.make_mesh(1, CPU2).shape == {"data": 1}
    assert tmesh.device_mesh(3, "cpu").devices == [torch.device("cpu")] * 3
    for bad in (lambda: tmesh.make_mesh(3, CPU2),
                lambda: tmesh.device_mesh(2, "cuda")):   # no card here
        with pytest.raises(ValueError, match="data mesh of"):
            bad()
    assert tmesh.data_axis_size(None) == tmesh.seq_axis_size(mesh) == 1
    assert tmesh.data_axis_size(mesh) == 2
    pm = tmesh.mesh_from_config(small_configs()[1])   # no process group
    assert (pm.rank, pm.size) == (0, 1)
    assert [tmesh.ProcessMesh(r, 3).rows(6) for r in range(3)] == [
        slice(0, 2), slice(2, 4), slice(4, 6)]
    assert tmesh.pad_batch_indices is tdata.pad_batch_indices
    for idx, m in (([3, 1, 4], 2), ([5], 4), ([1, 2], 2)):
        got, want = tmesh.pad_batch_indices(idx, m), jmesh.pad_batch_indices(idx, m)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])


def test_maybe_init_distributed(monkeypatch):
    """A no-op without torchrun's environment, as JAX's is without a
    coordinator; a half-set environment raises; a rank's default card is
    `cuda:{LOCAL_RANK}`, which must exist."""
    for k in runtime.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert runtime.maybe_init_distributed(device="cpu") is False
    assert runtime.rank_device("cuda") == torch.device("cuda")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        runtime.maybe_init_distributed(device="cpu")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert runtime.rank_device("cpu") == torch.device("cpu")
    assert runtime.rank_device("cuda:0") == torch.device("cuda", 0)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):
            runtime.rank_device("cuda")


# ------------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel")
    jcfg, _ = small_configs(pos_encoding_mode="2d")
    jcfg.preprocess_dir = str(tmp / "store")
    ids = make_synthetic_store(jcfg.preprocess_dir, jcfg, num_slides=6,
                               base_hw=(3, 4), seed=3)
    dirs = {}
    for engine in ("fused", "streaming"):
        jcfg.engine = engine
        dirs[engine] = str(tmp / f"model_{engine}")
        jcfg.save(dirs[engine])
        save_state(dirs[engine], recursive_init(jax.random.PRNGKey(1), jcfg))
    return ids, dirs


def _hazards(rows):
    return np.asarray([r["hazards"] for r in rows])


def test_mesh_session_matches_one_device_and_jax(served):
    """Requests of 1, 3 and 6 slides over two shards at batch 4: widths
    bucket to 2 and 4, each shard collated on its own device; the batch LRU
    keeps sharded batches."""
    ids, dirs = served
    mesh = tmesh.make_mesh(devices=CPU2)
    sess = ServingSession(dirs["fused"], batch_size=4, device="cpu",
                          mesh=mesh)
    assert [sess._pad_width(n) for n in (1, 2, 3, 4, 9)] == [2, 2, 4, 4, 4]
    one = ServingSession(dirs["fused"], batch_size=4, device="cpu",
                         cache_batches=0)
    jsess = JSession(dirs["fused"], batch_size=4, cache_batches=0,
                     mesh=jmesh.make_mesh(2))
    for req in (ids[:1], ids[1:4], ids):
        got = sess.predict(req)
        assert [r["slide_id"] for r in got] == req
        np.testing.assert_allclose(_hazards(got), _hazards(one.predict(req)),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(_hazards(got), _hazards(jsess.predict(req)),
                                   rtol=1e-5, atol=0)
    key = (0, 0)          # the one-slide request, padded to the mesh
    assert len(sess._batch_cache[key]) == 2 and len(sess._batch_cache) == 4
    first = _hazards(sess.predict(ids[:1]))
    assert list(sess._batch_cache)[-1] == key    # a hit, now the newest
    np.testing.assert_array_equal(first, _hazards(sess.predict(ids[:1])))


def test_mesh_session_refuses_streaming(served):
    _, dirs = served
    with pytest.raises(ValueError, match="live fused sessions"):
        ServingSession(dirs["streaming"], batch_size=4,
                       mesh=tmesh.make_mesh(devices=CPU2))


def test_cli_serve_data_parallel(served, monkeypatch):
    """`cli.serve --data-parallel 2 --device cpu` serves a two-shard
    session (the HTTP layer is `tests/test_torch_http.py`'s)."""
    from paths_tpu_torch.cli import serve as cli

    ids, dirs = served
    seen = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            seen["rows"] = seen["session"].predict(ids[:3])

        def server_close(self):
            pass

    def make_server(session, host, port):
        seen["session"] = session
        return Server()

    monkeypatch.setattr(cli, "make_server", make_server)
    cli.main(["-m", dirs["fused"], "--device", "cpu", "--data-parallel", "2",
              "--batch-size", "4"])
    assert seen["session"]._mesh.devices == [torch.device("cpu")] * 2
    want = ServingSession(dirs["fused"], batch_size=4, device="cpu")
    np.testing.assert_allclose(_hazards(seen["rows"]),
                               _hazards(want.predict(ids[:3])), rtol=1e-6)


# ------------------------------------------------------------ preprocessing

def _slides(tmp_path, n=2):
    d = tmp_path / "slides"
    d.mkdir()
    items = []
    for i in range(n):
        img, _ = make_fake_slide(rows=512 + 128 * i, cols=640, seed=i)
        np.save(str(d / f"s{i}.npy"), img)
        items.append((str(d / f"s{i}.npy"), f"s{i}"))
    return items


@pytest.mark.parametrize("decode_workers", [0, 2])
def test_sharded_preprocessing(tmp_path, decode_workers):
    """Batches of 8 (tails of 32 rounded to even) over two shards, one
    encoder each: the one-device grids to the bit and JAX's mesh-staged
    grids within 1e-6, with one decode thread and with two decode
    processes; `process_level` alike."""
    items = _slides(tmp_path)
    powers = [2.5, 5.0]
    kw = dict(patch_size=64, batch_size=8, threads=2, default_power=10.0)
    mesh = tmesh.make_mesh(devices=CPU2)
    stores = {n: TStore(str(tmp_path / n), create=True) for n in ("one", "mesh")}
    tpipe.process_slides(items, t_encode, DIM, powers, stores["one"],
                         device="cpu", **kw)
    tpipe.process_slides(items, [t_encode, t_encode], DIM, powers,
                         stores["mesh"], mesh=mesh,
                         decode_workers=decode_workers, **kw)
    jstore = JStore(str(tmp_path / "jax"), create=True)
    jpipe.process_slides(items, j_encode, DIM, powers, jstore,
                         mesh=JMesh(np.array(jax.devices()[:2]), ("data",)),
                         **kw)
    for _, sid in items:
        for p in powers:
            got = np.asarray(stores["mesh"].load(sid, p))
            assert np.array_equal(got, np.asarray(stores["one"].load(sid, p)))
            np.testing.assert_allclose(got, np.asarray(jstore.load(sid, p)),
                                       rtol=0, atol=1e-6)
    if decode_workers:
        return
    from paths_tpu_torch.preprocess.wsi import open_wsi

    grid = tpipe.process_level(open_wsi(items[0][0], 10.0), [t_encode] * 2,
                               DIM, 5.0, patch_size=64, batch_size=8,
                               threads=2, mesh=mesh)
    assert np.array_equal(grid, np.asarray(stores["one"].load("s0", 5.0)))
    with pytest.raises(ValueError, match="1 encoder"):
        tpipe.process_level(open_wsi(items[0][0], 10.0), [t_encode], DIM,
                            5.0, patch_size=64, batch_size=8, mesh=mesh)


def test_cli_preprocess_data_shards(tmp_path):
    """`cli.preprocess --data-shards 2 --device cpu` with a small ViT built
    once for both shards: the one-device CLI's grid."""
    from paths_tpu_torch.cli.preprocess import main

    img, _ = make_fake_slide(rows=448, cols=448)
    d = tmp_path / "slides"
    d.mkdir()
    np.save(str(d / "s1.npy"), img)
    argv = ["-m", "kaiko-vits16", "-d", str(d), "-b", "4", "-p", "224", "-ms",
            "10.0", "--default-power", "10.0", "--ext", ".npy", "--device",
            "cpu"]
    main(argv + ["-o", str(tmp_path / "one")])
    stats = main(argv + ["-o", str(tmp_path / "two"), "--data-shards", "2"])
    assert stats["h2d_bytes"] > 0
    one = np.asarray(TStore(str(tmp_path / "one")).load("s1", 10.0))
    two = np.asarray(TStore(str(tmp_path / "two")).load("s1", 10.0))
    assert np.abs(one).max() > 0
    np.testing.assert_array_equal(two, one)
