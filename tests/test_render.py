"""Render-layer golden tests.

Goldens from reference: src-tauri/src/core/visualize/drawing.rs:44-57 and
src-tauri/src/core/render_tiles.rs:408-546.
"""

import struct

import numpy as np
import pytest

from thesia_tpu.render import (
    RenderTileCache,
    SPECTROGRAM_TILE_SIZE,
    WAVEFORM_TILE_BINS,
    convert_spectrogram_to_img,
    decode_spectrogram_tile,
    decode_waveform_tile,
    default_colormap_rgba8,
    encode_spectrogram_tile,
    encode_waveform_tile,
)


def test_spectrogram_to_img_golden():
    spec = np.array([[-100.0, -50.0, 0.0], [100.0, -200.0, -25.0]], np.float32)
    img = convert_spectrogram_to_img(spec, (0, 4), (-100.0, 0.0), 4)
    assert img.shape == (4, 2)
    assert img[0, 0] == 16384
    assert img[0, 1] == 65535
    assert img[1, 0] == 40960  # 40959.5 rounds half-away-from-zero
    assert img[1, 1] == 0
    assert img[2, 0] == 65535
    assert img[2, 1] == 53247
    assert img[3, 0] == 0 and img[3, 1] == 0


def test_spectrogram_to_img_neginf_range():
    spec = np.full((3, 2), -np.inf, np.float32)
    img = convert_spectrogram_to_img(spec, (0, 2), (-np.inf, -np.inf), 258)
    assert img.shape == (2, 3)
    assert (img == 0).all()


def test_waveform_tile_min_max_representative():
    data = encode_waveform_tile(np.array([-1.0, 0.0, 0.5, 1.0], np.float32), 3, 1, 0)
    assert struct.unpack_from("<I", data, 8)[0] == 2
    assert struct.unpack_from("<f", data, 24)[0] == -1.0
    assert struct.unpack_from("<f", data, 28)[0] == 0.0
    assert struct.unpack_from("<f", data, 32)[0] == -0.5


def test_waveform_tile_partial_last_tile():
    wav = np.full(WAVEFORM_TILE_BINS + 1, 0.25, np.float32)
    data = encode_waveform_tile(wav, 1, 0, 1)
    assert struct.unpack_from("<I", data, 8)[0] == 1


def test_waveform_tile_large_bin():
    wav = (np.arange(64) - 32.0).astype(np.float32)
    data = encode_waveform_tile(wav, 1, 6, 0)
    d = decode_waveform_tile(data)
    assert d["binCount"] == 1
    np.testing.assert_allclose(d["bins"][0], [-32.0, 31.0, -0.5])


def test_waveform_all_nan_bin_matches_native_semantics():
    """NaN samples are skipped with inf/-inf inits (native std::min/max and
    the reference's f32::min/max both ignore NaN) — np.nanmin returned NaN
    for an all-NaN bin, so tile bytes differed between the native and
    fallback paths (review finding)."""
    from thesia_tpu.render.tiles import waveform_bin_stats

    wav = np.array(
        [0.5, -0.25, np.nan, 0.125] + [np.nan] * 4 + [np.nan, 1.0, -1.0, 0.0],
        np.float32,
    )
    mins, maxs, means = waveform_bin_stats(wav, 0, len(wav), 4)
    np.testing.assert_array_equal(mins, [-0.25, np.inf, -1.0])
    np.testing.assert_array_equal(maxs, [0.5, -np.inf, 1.0])
    assert np.isnan(means[:2]).all()  # the sum still propagates NaN
    from thesia_tpu import native

    if native.available():
        # a blanket except here would also swallow the ASSERTIONS and make
        # the cross-path identity unfalsifiable (review finding)
        nat = np.asarray(
            native.waveform_bin_stats(wav, 0, len(wav), 4, 3)
        ).reshape(3, 3)
        np.testing.assert_array_equal(nat[:, 0], mins)
        np.testing.assert_array_equal(nat[:, 1], maxs)
        np.testing.assert_array_equal(np.isnan(nat[:, 2]), np.isnan(means))


def test_waveform_tile_out_of_range():
    data = encode_waveform_tile(np.zeros(10, np.float32), 1, 0, 5)
    assert struct.unpack_from("<I", data, 8)[0] == 0
    assert len(data) == 24


def test_spectrogram_tile_lod_and_edges():
    spec = np.array([[0, 65535], [65535, 65535]], np.uint16)
    colors = np.array([[0, 0, 0, 255], [255, 0, 0, 255]], np.uint8)
    data = encode_spectrogram_tile(spec, colors, 4, 1, 1, 0, 0)
    assert struct.unpack_from("<I", data, 8)[0] == 1
    assert struct.unpack_from("<I", data, 12)[0] == 1
    assert data[40:] == bytes([255, 0, 0, 255])


def test_spectrogram_tile_partial_last_tile():
    n = SPECTROGRAM_TILE_SIZE + 1
    spec = np.full((n, n), 65535, np.uint16)
    colors = np.array([[0, 0, 0, 255], [255, 0, 0, 255]], np.uint8)
    data = encode_spectrogram_tile(spec, colors, 4, 0, 0, 1, 1)
    d = decode_spectrogram_tile(data)
    assert d["width"] == 5 and d["height"] == 5
    assert d["originX"] == 508 and d["originY"] == 508
    assert (d["rgba"] == [255, 0, 0, 255]).all()


def test_spectrogram_tile_high_freq_first():
    spec = np.array([[0], [65535]], np.uint16)
    colors = np.array([[0, 0, 0, 255], [255, 0, 0, 255]], np.uint8)
    data = encode_spectrogram_tile(spec, colors, 4, 0, 0, 0, 0)
    assert data[40:44] == bytes([255, 0, 0, 255])
    assert data[44:48] == bytes([0, 0, 0, 255])


def test_cache_evicts_and_invalidates():
    cache = RenderTileCache(budget_bytes=24 + WAVEFORM_TILE_BINS * 12)
    wav = np.zeros(WAVEFORM_TILE_BINS * 2, np.float32)
    revision = cache.waveform_revision
    cache.store_waveform_tile(1, 0, revision, 0, 0, encode_waveform_tile(wav, revision, 0, 0))
    cache.store_waveform_tile(1, 0, revision, 0, 1, encode_waveform_tile(wav, revision, 0, 1))
    assert cache.entry_count == 1
    assert cache.cached_bytes <= 24 + WAVEFORM_TILE_BINS * 12
    cache.invalidate_waveform()
    assert cache.entry_count == 0
    assert cache.waveform_revision > revision


def test_cache_lru_order_updates_on_hit():
    wav = np.zeros(WAVEFORM_TILE_BINS * 3, np.float32)
    tile_bytes = len(encode_waveform_tile(wav, 1, 0, 0))
    cache = RenderTileCache(budget_bytes=tile_bytes * 2)
    revision = cache.waveform_revision
    for i in range(2):
        cache.store_waveform_tile(1, 0, revision, 0, i, encode_waveform_tile(wav, revision, 0, i))
    assert cache.cached_waveform_tile(1, 0, 0, 0)[1] is not None
    cache.store_waveform_tile(1, 0, revision, 0, 2, encode_waveform_tile(wav, revision, 0, 2))
    assert cache.cached_waveform_tile(1, 0, 0, 0)[1] is not None
    assert cache.cached_waveform_tile(1, 0, 0, 1)[1] is None
    assert cache.cached_waveform_tile(1, 0, 0, 2)[1] is not None


def test_cache_drops_stale_revision():
    cache = RenderTileCache()
    revision = cache.waveform_revision
    wav = np.zeros(WAVEFORM_TILE_BINS, np.float32)
    data = encode_waveform_tile(wav, revision, 0, 0)
    cache.invalidate_waveform()
    cache.store_waveform_tile(1, 0, revision, 0, 0, data)
    assert cache.entry_count == 0


def test_metadata():
    cache = RenderTileCache()
    md = cache.metadata(2, 48000, 2 / 48000, True, (2, 3))
    assert md["isClipped"] and md["sampleCount"] == 2
    assert md["spectrogramHeight"] == 2 and md["spectrogramWidth"] == 3
    assert md["waveformTileBins"] == WAVEFORM_TILE_BINS


def test_default_colormap():
    cm = default_colormap_rgba8()
    assert cm.shape == (258, 4)
    assert (cm[0] == [0, 0, 0, 255]).all()
    assert (cm[-1] == [255, 255, 255, 255]).all()
    # first inferno entry: [0.001462, 0.000466, 0.013866] * 255 rounded
    assert (cm[1] == [0, 0, 4, 255]).all()


@pytest.mark.parametrize(
    "index, rgb",
    [(64, (85, 15, 109)), (128, (186, 54, 85)), (192, (249, 140, 10)), (256, (252, 255, 164))],
)
def test_default_colormap_inline_anchors(index, rgb):
    """The inline inferno table keeps matplotlib's published values."""
    cm = default_colormap_rgba8()
    assert cm.dtype == np.uint8 and (cm[:, 3] == 255).all()
    assert tuple(cm[index, :3]) == rgb


def test_default_colormap_matches_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    inferno = np.asarray(matplotlib.colormaps["inferno"].colors)
    want = np.round(np.vstack([[0, 0, 0], inferno, [1, 1, 1]]) * 255).astype(np.uint8)
    np.testing.assert_array_equal(default_colormap_rgba8()[:, :3], want)


def test_quantize_min_value_half_away_from_zero():
    """min_value = round(65535/len) with the reference's f64 round()
    (half-away-from-zero, drawing.rs:21) — np.round's banker's rounding
    diverged for lengths whose quotient ends in even+0.5 (review finding).
    The default 258-entry colormap is unaffected (pinned)."""
    from thesia_tpu.render.visualize import quantize_min_value

    assert quantize_min_value(None) == 1
    assert quantize_min_value(258) == 254  # default colormap (goldens)
    assert quantize_min_value(6) == 10923  # 10922.5 rounds AWAY, not to even
    assert quantize_min_value(2) == 32768  # 32767.5 likewise
    assert quantize_min_value(65535) == 1
