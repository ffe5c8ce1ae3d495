"""The port's serving slice end to end on the CPU, against the JAX package.

One synthetic store (written by both packages' `make_synthetic_store`, which
must agree byte for byte) and one `model.npz` (written by the JAX package)
feed the JAX `ServingSession` and the port's `ServingSession(device="cpu")`.
Both run in f32 on the CPU and differ only in summation order: hazards agree
to 1e-5.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paths_tpu.data.synthetic import make_synthetic_store as j_make_store
from paths_tpu.models.recursive import recursive_init
from paths_tpu.serve import ServingSession as JSession
from paths_tpu.train.state import save_state
from test_torch_models import small_configs

from paths_tpu_torch.data.synthetic import make_synthetic_store
from paths_tpu_torch.serve import ServingSession

TOL = 1e-5  # f32 on the CPU, different summation order
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    jcfg, _ = small_configs(pos_encoding_mode="2d")
    ids = make_synthetic_store(str(tmp / "store"), jcfg, num_slides=5,
                               base_hw=(3, 4), seed=11)
    dirs = {}
    for impl in ("xla", "pallas"):
        jcfg, _ = small_configs(impl, pos_encoding_mode="2d")
        jcfg.preprocess_dir = str(tmp / "store")
        d = str(tmp / f"model_{impl}")
        jcfg.save(d)
        save_state(d, recursive_init(jax.random.PRNGKey(2), jcfg))
        dirs[impl] = d
    return tmp, ids, dirs


def test_synthetic_store_matches_jax(tmp_path, served):
    tmp, ids, _ = served
    jcfg, _ = small_configs()
    assert j_make_store(str(tmp_path), jcfg, num_slides=5, base_hw=(3, 4),
                        seed=11) == ids
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.listdir(tmp / "store"))
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / n),
                                      np.load(tmp / "store" / n))


def test_serving_session_matches_jax(served):
    """Requests of 1, 3 and 5 slides (batch widths 1, 2+2 and 4+1 at
    batch_size 4); the port's kernel route ("pallas", the plain flash
    version on the CPU) and plain route both agree with JAX."""
    from paths_tpu.data.dataset import collate_batch as j_collate
    from paths_tpu_torch.data.dataset import collate_batch

    _, ids, dirs = served
    jsess = JSession(dirs["xla"], batch_size=4, cache_batches=0)
    sessions = {impl: ServingSession(d, batch_size=4, device="cpu")
                for impl, d in dirs.items()}
    for req in (ids[:1], ids[1:4], ids):
        want = jsess.predict(req)
        for impl, sess in sessions.items():
            got = sess.predict(req)
            assert [r["slide_id"] for r in got] == req
            for a, b in zip(got, want):
                np.testing.assert_allclose(a["hazards"], b["hazards"],
                                           atol=TOL, rtol=0, err_msg=impl)
                np.testing.assert_allclose(a["risk"], b["risk"],
                                           atol=4 * TOL, rtol=0)

    # collation: identical shapes under the session's global pads
    sess = sessions["xla"]
    jbag, jtables, _ = j_collate(jsess._dataset, [0, 2, 4], pads=jsess._pads)
    bag, tables = collate_batch(sess._dataset, [0, 2, 4], pads=sess._pads,
                                device="cpu")
    for f in ("fts", "locs", "mask", "parent_inds", "ctx_slide", "ctx_patch"):
        assert tuple(getattr(bag, f).shape) == getattr(jbag, f).shape, f
    for tt, jt in zip(tables, jtables):
        for f in ("fts", "locs", "count", "index", "grid_hw"):
            assert tuple(getattr(tt, f).shape) == getattr(jt, f).shape, f
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)))

    with pytest.raises(KeyError):
        sess.predict(["nope"])


def test_session_defaults_to_cuda(served):
    """No silent CPU path: without a card the default device fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    _, _, dirs = served
    with pytest.raises((RuntimeError, AssertionError)):
        ServingSession(dirs["pallas"])


def test_port_imports_neither_jax_nor_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paths_tpu_torch\n"
        "for m in pkgutil.walk_packages(paths_tpu_torch.__path__, 'paths_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paths_tpu', 'pandas'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
