"""The port's native host code (`paths_tpu_torch.native`: the table builder
and the batched JPEG decoder) and its JPEG-tiled slides
(`preprocess.wsi.TiledJpegWSI`) against the port's numpy path, PIL and the
JAX package on the same inputs. Skips without g++ or libjpeg, as the JAX
package's native tests do."""
import shutil

import numpy as np
import pytest

import paths_tpu.engine.tables as jtables
import paths_tpu_torch.engine.tables as ttables
from paths_tpu.preprocess import wsi as jwsi
from paths_tpu_torch import native
from paths_tpu_torch.native import build as nbuild
from paths_tpu_torch.native import jpeg as njpeg
from paths_tpu_torch.preprocess import wsi as twsi


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    nbuild.build(verbose=False)
    assert native.available()
    return native


@pytest.fixture(scope="module")
def jpeg_lib(host_lib):
    if nbuild.build_jpeg(verbose=False) is None:
        pytest.skip("libjpeg dev files unavailable")
    assert njpeg.available()
    # the JAX package's decoder, for the decoder-for-decoder comparison;
    # built only when missing (its tests rebuild it in place)
    from paths_tpu.native import jpeg as jjpeg

    jjpeg._tried, jjpeg._lib = False, None
    if not jjpeg.available():
        from paths_tpu.native.build import build_jpeg as jbuild_jpeg

        if jbuild_jpeg(verbose=False) is None:
            pytest.skip("libjpeg dev files unavailable")
        jjpeg._tried, jjpeg._lib = False, None
    assert jjpeg.available()
    return njpeg


def _grid(rng, h, w, d, bgf, dtype=np.float32):
    """Random grid whose background rows are exactly zero (the C++ scan sums
    a row in order, numpy pairwise: they agree unless a live row cancels to
    exactly 0)."""
    g = rng.normal(size=(h, w, d)).astype(dtype)
    g[rng.uniform(size=(h, w)) < bgf] = 0
    return g


@pytest.mark.parametrize("shape,bgf,rows", [
    ((7, 9, 16), 0.5, 20), ((32, 40, 64), 0.3, 0), ((4, 4, 8), 1.0, 12),
    ((4, 4, 8), 0.0, 0), ((6, 5, 8), 0.4, 64)])
def test_native_table_matches_numpy_and_jax(host_lib, shape, bgf, rows):
    g = _grid(np.random.default_rng(0), *shape, bgf)
    nat = native.build_level_table_native(g, rows)
    assert nat is not None
    ref = ttables.build_level_table_numpy(g, rows)
    jax_t = jtables.build_level_table(g, rows)
    via = ttables.build_level_table(g, rows)        # dispatches to native
    for key in ("fts", "locs", "index", "grid_hw"):
        for other in (ref, jax_t, via):
            assert nat[key].dtype == other[key].dtype, key
            np.testing.assert_array_equal(nat[key], other[key])
    assert nat["count"] == ref["count"] == jax_t["count"] == via["count"]


def test_f16_grid_takes_the_numpy_path(host_lib):
    g = _grid(np.random.default_rng(1), 8, 6, 16, 0.4, np.float16)
    assert native.build_level_table_native(g, 10) is None
    got = ttables.build_level_table(g, 10)
    want = jtables.build_level_table(g, 10)
    assert got["fts"].dtype == np.float16
    for key in ("fts", "locs", "index", "grid_hw", "count"):
        np.testing.assert_array_equal(got[key], want[key])


def test_library_name_carries_source_and_flags(host_lib):
    path = nbuild.library_path("host")
    assert path.startswith(nbuild.BUILD_DIR)
    assert path != nbuild.library_path("jpeg")
    import os

    assert "libpaths_torch_host-" in os.path.basename(path)
    assert host_lib.load().omp_thread_count() >= 1


def _pil_jpeg(img, quality=85):
    import io

    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=quality)
    return b.getvalue()


def test_jpeg_batch_decode_matches_pil(jpeg_lib):
    """Native batched decode == PIL decode of the same streams within +-2
    (both are libjpeg; IDCT variants differ across builds), with top-left
    placement, white padding, failed and oversize slots."""
    import io

    from PIL import Image

    rng = np.random.default_rng(2)
    shapes = [(128, 128), (40, 96), (128, 128), (96, 128)]
    imgs = [(rng.random((h, w, 3)) * 255).astype(np.uint8) for h, w in shapes]
    bufs = [_pil_jpeg(im) for im in imgs]
    bufs.insert(2, b"\xff\xd8 definitely not a jpeg")

    out, dims = jpeg_lib.decode_batch(bufs, (128, 128))
    assert out.shape == (5, 128, 128, 3) and out.dtype == np.uint8
    assert dims[2].tolist() == [-1, -1] and (out[2] == 255).all()
    for bi in [0, 1, 3, 4]:
        ref = np.asarray(Image.open(io.BytesIO(bufs[bi])).convert("RGB"))
        h, w = ref.shape[:2]
        assert dims[bi].tolist() == [h, w]
        assert np.abs(out[bi, :h, :w].astype(int) - ref.astype(int)).max() <= 2
        assert (out[bi, h:] == 255).all() and (out[bi, :, w:] == 255).all()

    big = _pil_jpeg((rng.random((200, 64, 3)) * 255).astype(np.uint8))
    out2, dims2 = jpeg_lib.decode_batch([big], (128, 128))
    assert dims2[0].tolist() == [-1, -1] and (out2 == 255).all()
    empty, edims = jpeg_lib.decode_batch([], (8, 8))
    assert empty.shape == (0, 8, 8, 3) and edims.shape == (0, 2)

    assert jpeg_lib.header_dims(bufs[1]) == shapes[1]
    assert jpeg_lib.header_dims(b"junk") is None


# (power, loc, size) reads: tile-crossing, partial and negative out of
# bounds, a stored pyramid level, a downsampled read, and one read of 12
# tiles, more than the cache's 4
READS = [(10.0, (100, 200), (300, 400)), (10.0, (120, 120), (200, 300)),
         (10.0, (400, 600), (256, 256)), (10.0, (-20, -20), (64, 64)),
         (2.5, (5, 10), (60, 80)), (0.625, (0, 0), (40, 50)),
         (5.0, (30, 40), (64, 64))]


@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_tiled_reader_equals_jax_byte_for_byte(jpeg_lib, tmp_path, decoder):
    """The port's TiledJpegWSI reads the same bytes as the JAX package's, with
    the same decoder on each side; the cache cap is restored after an
    oversize read; the port reads a pyramid the JAX package wrote."""
    rng = np.random.default_rng(3)
    base = (rng.random((500, 700, 3)) * 255).astype(np.uint8)
    d = str(tmp_path / "s.tiles")
    twsi.write_tiled_jpeg(base, d, base_power=10.0, tile=128, quality=90)
    dj = str(tmp_path / "j.tiles")
    jwsi.write_tiled_jpeg(base, dj, base_power=10.0, tile=128, quality=90)

    got = twsi.TiledJpegWSI(d, cache_tiles=4, decoder=decoder)
    want = jwsi.TiledJpegWSI(d, cache_tiles=4, decoder=decoder)
    assert (got._native is not None) == (decoder == "native")
    assert (want._native is not None) == (decoder == "native")
    from_jax = twsi.TiledJpegWSI(dj, cache_tiles=4, decoder=decoder)
    assert isinstance(twsi.open_wsi(dj, 10.0), twsi.TiledJpegWSI)
    assert isinstance(from_jax, twsi.TiledJpegWSI)
    assert got.objective_power() == 10.0
    for power in (10.0, 2.5, 0.625):
        assert got.slide_dimensions(power) == want.slide_dimensions(power)
    for power, loc, size in READS:
        a = got.read_rect(loc, size, power)
        assert a.shape == (*size, 3) and a.dtype == np.uint8
        assert np.array_equal(a, want.read_rect(loc, size, power)), (power, loc)
        assert np.array_equal(a, from_jax.read_rect(loc, size, power))
        assert len(got._cache) <= 4               # cap restored
    for r in (got, want, from_jax):
        r.close()


def test_tiled_reader_decoders_agree_and_refusals(jpeg_lib, tmp_path):
    rng = np.random.default_rng(4)
    base = (rng.random((300, 260, 3)) * 255).astype(np.uint8)
    d = twsi.write_tiled_jpeg(base, str(tmp_path / "a.tiles"), tile=128)
    nat = twsi.TiledJpegWSI(d, decoder="native")
    pil = twsi.TiledJpegWSI(d, decoder="pil")
    auto = twsi.TiledJpegWSI(d)
    assert auto._native is not None
    for loc, size in (((0, 0), (300, 260)), ((100, 50), (128, 200))):
        a, b = nat.read_rect(loc, size, 40.0), pil.read_rect(loc, size, 40.0)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
    with pytest.raises(ValueError):
        twsi.TiledJpegWSI(d, decoder="libvips")
