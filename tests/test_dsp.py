"""Golden tests for framing, STFT, dB conversion.

Goldens from reference: src-tauri/src/core/spectrogram/stft.rs:173-196,
src-tauri/src/core/dynamics/decibel.rs:257-301, core/utils.rs:165-175.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from thesia_tpu.dsp import (
    SpecSetting,
    perform_stft,
    reflect_pad_1d,
    stft_frame_count,
)
from thesia_tpu.dsp.decibel import (
    amp_from_db,
    db_from_amp,
    db_from_amp_scalar,
    db_from_power,
    db_from_power_scalar,
    power_from_db,
)
from thesia_tpu.dsp.spectrogram import SpectrogramAnalyzer
from thesia_tpu.common.freqscale import FreqScale


def test_reflect_pad():
    # reference: core/utils.rs:170-174 (cyclic reflect)
    x = np.array([1, 2, 3])
    np.testing.assert_array_equal(
        reflect_pad_1d(x, 3, 4), [2, 3, 2, 1, 2, 3, 2, 1, 2, 3]
    )


def test_spec_setting_framing():
    s = SpecSetting()  # 40 ms, t_overlap 4
    hop, win, n_fft = s.calc_framing_params(48000)
    assert (hop, win, n_fft) == (480, 1920, 2048)
    hop, win, n_fft = s.calc_framing_params(16000)
    assert (hop, win, n_fft) == (160, 640, 1024)
    hop, win, n_fft = s.calc_framing_params(22050)
    # 220.5 rounds half-away-from-zero (rust f64::round), not banker's
    assert (hop, win) == (221, 884)


def test_stft_impulse_golden():
    # reference: stft.rs:173-196
    impulse = np.zeros(4, np.float32)
    impulse[2] = 1.0
    spec = perform_stft(impulse, 4, 2, 4)
    expected = np.array(
        [
            [0, 0, 0],
            [0.25, -0.25, 0.25],
            [0.25, -0.25, 0.25],
        ],
        np.complex64,
    )
    assert spec.shape == (3, 3)
    np.testing.assert_allclose(spec, expected, atol=1e-6)


def test_stft_short_wav():
    # reference: stft.rs:198-203 — len < win path must not crash
    impulse = np.zeros(2, np.float32)
    impulse[1] = 1.0
    spec = perform_stft(impulse, 8, 6, 8)
    assert spec.shape[0] == stft_frame_count(2, 8, 6) == 1


def test_stft_frame_count_matches_reference_construction():
    # front/mid/back construction: n = (len + 2*(win//2) - win)//hop + 1
    for n, win, hop in [(4, 4, 2), (100, 8, 2), (1000, 64, 16), (2113529, 1920, 480)]:
        assert stft_frame_count(n, win, hop) == (n + 2 * (win // 2) - win) // hop + 1


def test_db_scalar_goldens():
    # reference: decibel.rs:257-301
    assert abs(db_from_amp_scalar(0.25) - (-12.0412)) < 1e-4
    assert abs(db_from_power_scalar(0.25) - (-6.0206)) < 1e-4
    assert db_from_amp_scalar(0.0) == -math.inf
    assert db_from_power_scalar(0.0) == -math.inf
    assert math.isnan(db_from_amp_scalar(-1.0))
    assert math.isnan(db_from_power_scalar(math.nan))
    assert abs(db_from_amp_scalar(1.0, ref_value=2.0) - (-6.0206)) < 1e-4


def test_db_array_semantics():
    amps = jnp.array([1.0, 0.5, 0.0, -1.0, jnp.nan])
    out = np.asarray(db_from_amp(amps, 1.0, 1e-3))
    assert abs(out[0]) < 1e-6
    assert abs(out[1] + 6.0206) < 1e-3
    assert abs(out[2] + 60.0) < 1e-4
    assert math.isnan(out[3]) and math.isnan(out[4])

    # round trips
    assert abs(float(amp_from_db(jnp.float32(-12.0412))) - 0.25) < 1e-5
    assert abs(float(power_from_db(jnp.float32(-6.0206))) - 0.25) < 1e-5


def test_calc_spec_shapes_and_silence():
    analyzer = SpectrogramAnalyzer()
    sr = 8000
    s = SpecSetting()
    hop, win, n_fft = s.calc_framing_params(sr)
    wav = np.zeros(sr, np.float32)  # 1 s of silence
    spec = np.asarray(analyzer.calc_spec(wav, sr, s))
    assert spec.shape[0] == stft_frame_count(sr, win, hop)
    assert np.all(np.isneginf(spec))  # silence -> exactly -inf everywhere

    s_lin = SpecSetting(freq_scale=FreqScale.Linear)
    spec_lin = np.asarray(analyzer.calc_spec(wav, sr, s_lin))
    assert spec_lin.shape[1] == n_fft // 2 + 1


def test_calc_spec_sine_peak():
    # 1 kHz sine at sr 8000 -> linear spec should peak at bin k = 1000/ (sr/n_fft)
    analyzer = SpectrogramAnalyzer()
    sr = 8000
    s = SpecSetting(freq_scale=FreqScale.Linear)
    hop, win, n_fft = s.calc_framing_params(sr)
    t = np.arange(sr, dtype=np.float64) / sr
    wav = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    spec = np.asarray(analyzer.calc_spec(wav, sr, s))
    mid = spec[spec.shape[0] // 2]
    expected_bin = round(1000.0 / (sr / n_fft))
    assert abs(int(np.argmax(mid)) - expected_bin) <= 1


def test_hop_length_floor_keeps_engine_defined():
    """UI-reachable 1 ms window + t_overlap 32 at 8 kHz rounds hop to 0 in
    the reference's own math (spectrogram.rs:62-64 would then divide by
    zero); the rebuild floors hop at 1 so every validated setting computes
    (review finding)."""
    s = SpecSetting(win_ms=1.0, t_overlap=32)
    s.validated()  # the combination passes entry validation
    hop, win, n_fft = s.calc_framing_params(8000)
    assert hop == 1 and win == 32 and n_fft >= win
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, 4000).astype(np.float32)
    spec = np.asarray(SpectrogramAnalyzer().calc_spec(wav, 8000, s))
    assert spec.shape[0] == stft_frame_count(4000, win, hop)
    assert np.isfinite(spec).any()


def test_db_scalar_negative_zero_is_nan():
    """-0.0 is sign-negative (Rust f64::is_sign_negative) -> NaN, for both
    the input and the reference value; the array path's signbit check
    already agreed (decibel.rs:66-91, review finding)."""
    from thesia_tpu.dsp.decibel import (
        db_from_amp, db_from_amp_scalar, db_from_power_scalar,
    )

    assert math.isnan(db_from_amp_scalar(-0.0))
    assert math.isnan(db_from_power_scalar(-0.0))
    assert math.isnan(db_from_amp_scalar(1.0, ref_value=-0.0))
    assert math.isnan(db_from_power_scalar(1.0, ref_value=-0.0))
    arr = np.asarray(db_from_amp(np.float32([1.0]), ref_value=-0.0))
    assert np.isnan(arr).all()
    # positive zero still maps to exactly -inf with amin=0
    assert db_from_amp_scalar(0.0) == -math.inf


def test_quantize_warm_shape_matches_dispatch_for_tight_bucket():
    """A track whose padded extent exactly fills its wav bucket gives a
    spec T axis SMALLER than frame_cap(n_frames); the quantize warm job
    must mirror that exact (C, T, F) or the real dispatch compiles cold
    inside the interactive call (review finding)."""
    from thesia_tpu.dsp import precompile
    from thesia_tpu.dsp.spectrogram import wav_size_bucket

    sr = 8000
    s = SpecSetting()
    hop, win, n_fft = s.calc_framing_params(sr)
    pad = win // 2
    n = wav_size_bucket(10**5) - 2 * pad  # padded extent == the bucket
    an = SpectrogramAnalyzer()
    job = precompile.quantize_jobs(an, [(0, (1, n), sr)], s, sr, 258)[0]
    key, _lower = job()
    warm_shape = key[1]
    wav = np.zeros((1, n), np.float32)
    wav[0, ::997] = 0.5
    res = an.calc_spec_multi(wav, sr, s)
    assert tuple(warm_shape) == tuple(res.db_padded.shape)


def test_rfft_fallback_parity_and_trigger(monkeypatch):
    """Huge-window guard: when the folded-DFT (win, n_freq) matrices would
    exceed THESIA_DFT_MAT_MAX_BYTES, the fused programs compute the
    magnitude via |rfft(frame * window, n_fft)| instead — which equals the
    centered-zero-pad DFT magnitude exactly in infinite precision (the
    center shift only rotates phase).  Without this, winMillisec=2000 at
    48 kHz would try to build two ~25 GB matrices."""
    from thesia_tpu.dsp import spectrogram as sg

    sr = 8000
    s = SpecSetting(freq_scale=FreqScale.Mel)
    hop, win, n_fft = s.calc_framing_params(sr)
    rng = np.random.default_rng(3)
    wav = rng.uniform(-0.5, 0.5, (2, sr)).astype(np.float32)

    ref = np.asarray(SpectrogramAnalyzer().calc_spec_multi(wav, sr, s).db_padded)

    monkeypatch.setattr(sg, "_DFT_MAT_MAX_BYTES", 0)  # force rfft everywhere
    an = SpectrogramAnalyzer()
    cw, _sw, rn = an._spec_operands(win, n_fft)
    assert rn == n_fft and cw.ndim == 1  # the window vector, not a matrix
    out = np.asarray(an.calc_spec_multi(wav, sr, s).db_padded)
    assert out.shape == ref.shape
    finite = np.isfinite(ref) & np.isfinite(out)
    np.testing.assert_allclose(out[finite], ref[finite], atol=5e-3)
    assert np.array_equal(np.isfinite(ref), np.isfinite(out))

    # batched path too (mixed with a second track)
    items = [(0, wav, sr, 1), (1, wav[:1] * 0.5, sr, 2)]
    ref_b = SpectrogramAnalyzer().calc_specs_batched(items, s)
    out_b = an.calc_specs_batched(items, s)
    for k in ref_b:
        a = np.asarray(ref_b[k].db_padded)
        b = np.asarray(out_b[k].db_padded)
        m = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(b[m], a[m], atol=5e-3)

    # the default budget really triggers for the dangerous shape:
    # 2000 ms at 48 kHz (win 96000, n_fft 131072)
    monkeypatch.undo()
    assert sg.use_rfft_for(96000, 131072)
    assert not sg.use_rfft_for(win, n_fft)  # production shapes stay on the GEMMs


def test_engine_survives_max_window_setting(tmp_path):
    """set_spec_setting at the 2000 ms entry cap completes end-to-end (the
    rfft fallback engages at 8 kHz: the folded mats would be ~1 GB) and
    tiles keep serving."""
    from thesia_tpu.engine.session import EngineSession
    from thesia_tpu.io.wav import encode_wav_f32
    from thesia_tpu.render import default_colormap_rgba8

    p = tmp_path / "t.wav"
    rng = np.random.default_rng(7)
    p.write_bytes(encode_wav_f32(
        rng.uniform(-0.5, 0.5, (1, 24000)).astype(np.float32), 8000
    ))
    session = EngineSession(settings_dir=tmp_path)
    session.init(default_colormap_rgba8())
    session.add_tracks([0], [str(p)])
    session.apply_track_list_changes()
    session.set_spec_setting(
        {"winMillisec": 2000.0, "tOverlap": 4, "fOverlap": 1,
         "freqScale": "Mel"},
        defer=False,
    )
    session.tm.images.drain()
    md = session.get_audio_render_metadata("0_0")
    assert md["spectrogramWidth"] > 0 and not md["isComputing"]
    tile = session.get_spectrogram_tile("0_0", 0, 0, 0, 0)
    assert len(tile) > 44
    session.tm.images.shutdown()


def test_calc_spec_matches_reference_stft():
    """Fused device path == frame-by-frame STFT + dB (semantics parity)."""
    analyzer = SpectrogramAnalyzer()
    sr = 8000
    s = SpecSetting(freq_scale=FreqScale.Linear)
    hop, win, n_fft = s.calc_framing_params(sr)
    rng = np.random.default_rng(0)
    wav = rng.uniform(-1, 1, 3001).astype(np.float32)
    got = np.asarray(analyzer.calc_spec(wav, sr, s))
    stft = perform_stft(wav, win, hop, n_fft)
    expected = 20.0 * np.log10(np.maximum(np.abs(stft), 1e-30))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, atol=1e-3, rtol=1e-4)


def test_calc_spec_multi_channels_and_cache():
    analyzer = SpectrogramAnalyzer()
    sr = 8000
    s = SpecSetting()
    rng = np.random.default_rng(1)
    wavs = rng.uniform(-1, 1, (2, 9000)).astype(np.float32)
    res = analyzer.calc_spec_multi(wavs, sr, s, cache_key="k", token=1)
    per_ch0 = np.asarray(analyzer.calc_spec(wavs[0], sr, s))
    per_ch1 = np.asarray(analyzer.calc_spec(wavs[1], sr, s))
    multi = np.asarray(res.db_padded)[:, : res.n_frames]
    np.testing.assert_allclose(multi[0], per_ch0, atol=1e-4)
    np.testing.assert_allclose(multi[1], per_ch1, atol=1e-4)
    mn, mx = res.min_max_db()
    assert abs(mn - multi.min()) < 1e-4 and abs(mx - multi.max()) < 1e-4
    # cached upload: same token reuses device buffer
    assert analyzer._wav_cache["k"][2] == 1


def test_calc_specs_batched_matches_per_track():
    """Multi-track batched recompute == per-track results (values + bounds)."""
    analyzer = SpectrogramAnalyzer()
    sr = 8000
    s = SpecSetting()
    rng = np.random.default_rng(4)
    tracks = {
        "a": rng.uniform(-1, 1, (1, 9000)).astype(np.float32),
        "b": rng.uniform(-0.5, 0.5, (2, 7000)).astype(np.float32),
        "c": rng.uniform(-0.2, 0.2, (1, 12000)).astype(np.float32),
    }
    batched = analyzer.calc_specs_batched(
        [(k, w, sr) for k, w in tracks.items()], s
    )
    for k, w in tracks.items():
        solo = analyzer.calc_spec_multi(w, sr, s)
        got = np.asarray(batched[k].db_padded)[:, : batched[k].n_frames]
        exp = np.asarray(solo.db_padded)[:, : solo.n_frames]
        assert batched[k].n_frames == solo.n_frames
        np.testing.assert_allclose(got, exp, atol=2e-4, rtol=1e-5)
        bmn, bmx = batched[k].min_max_db()
        smn, smx = solo.min_max_db()
        assert abs(bmn - smn) < 1e-3 and abs(bmx - smx) < 1e-3


def test_calc_specs_batched_mixed_sr():
    analyzer = SpectrogramAnalyzer()
    s = SpecSetting()
    rng = np.random.default_rng(5)
    items = [
        ("x", rng.uniform(-1, 1, (1, 9000)).astype(np.float32), 8000),
        ("y", rng.uniform(-1, 1, (1, 20000)).astype(np.float32), 16000),
        ("tiny", rng.uniform(-1, 1, (1, 100)).astype(np.float32), 8000),
    ]
    out = analyzer.calc_specs_batched(items, s)
    assert set(out) == {"x", "y", "tiny"}
    for key, w, sr in items:
        hop, win, _ = s.calc_framing_params(sr)
        assert out[key].n_frames == stft_frame_count(w.shape[1], win, hop)


@pytest.mark.parametrize(
    "t_overlap,f_overlap,win_ms,sr",
    [
        (1, 1, 40.0, 8000),
        (2, 1, 20.0, 16000),
        (8, 1, 40.0, 8000),
        (32, 1, 80.0, 8000),
        (4, 2, 40.0, 8000),   # f_overlap: n_fft = 2 * next_pow2(win)
        (2, 4, 20.0, 16000),
        (4, 1, 40.0, 22050),  # round-half-away hop case
    ],
)
def test_calc_spec_parameter_sweep_vs_reference_stft(t_overlap, f_overlap, win_ms, sr):
    """Fused device path == frame-by-frame reference STFT across the full
    SpecSetting parameter grid (T_OVERLAP_VALUES 1..32, f_overlap pow2;
    reference: constants/tracks.ts + spectrogram.rs:30-99)."""
    analyzer = SpectrogramAnalyzer()
    s = SpecSetting(
        win_ms=win_ms, t_overlap=t_overlap, f_overlap=f_overlap,
        freq_scale=FreqScale.Linear,
    )
    hop, win, n_fft = s.calc_framing_params(sr)
    assert win == hop * t_overlap
    rng = np.random.default_rng(t_overlap * 100 + f_overlap)
    wav = rng.uniform(-1, 1, int(sr * 0.8)).astype(np.float32)
    got = np.asarray(analyzer.calc_spec(wav, sr, s))
    stft = perform_stft(wav, win, hop, n_fft)
    expected = 20.0 * np.log10(np.maximum(np.abs(stft), 1e-30))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, atol=1e-3, rtol=1e-4)


def test_frame_cap_bucketing():
    from thesia_tpu.dsp.spectrogram import frame_cap

    assert frame_cap(1) == 1024
    assert frame_cap(1024) == 1024
    assert frame_cap(1025) == 2048
    assert frame_cap(6001) == 6144


def test_wav_cache_byte_budget_lru():
    analyzer = SpectrogramAnalyzer()
    analyzer._wav_cache_budget = 3 * (1 << 16) * 4  # room for ~3 min-bucket rows
    rng = np.random.default_rng(9)
    s = SpecSetting()
    for k in range(5):
        w = rng.uniform(-1, 1, (1, 40000)).astype(np.float32)
        analyzer.calc_spec_multi(w, 8000, s, cache_key=k, token=k + 1)
    # oldest entries evicted; the newest kept, total within budget
    total = sum(v[0].size * 4 for v in analyzer._wav_cache.values())
    assert total <= analyzer._wav_cache_budget
    assert 4 in analyzer._wav_cache and 0 not in analyzer._wav_cache


def test_upload_padded_chunked_bitexact():
    """Chunked h2d assembly (big buckets upload as pipelined
    _WAV_BUCKET_BIG_STEP column blocks + one device concat) must be
    bit-identical to the single-put padded buffer, including the zero tail
    and a partial final block."""
    from thesia_tpu.dsp.spectrogram import _WAV_BUCKET_BIG_STEP, wav_size_bucket

    analyzer = SpectrogramAnalyzer()
    rng = np.random.default_rng(11)
    # n crosses one full chunk plus a partial tail; bucket = 2 chunks
    n = _WAV_BUCKET_BIG_STEP + 12_345
    bucket = wav_size_bucket(n)
    assert bucket % _WAV_BUCKET_BIG_STEP == 0 and bucket // _WAV_BUCKET_BIG_STEP >= 2
    wavs = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    dev = analyzer._upload_padded(wavs, n, bucket)
    assert dev.shape == (2, bucket) and dev.dtype == np.float32
    got = np.asarray(dev)
    np.testing.assert_array_equal(got[:, :n], wavs)
    assert not got[:, n:].any()
    # small buckets keep the single-put path
    small = rng.uniform(-1, 1, (1, 50_000)).astype(np.float32)
    sb = wav_size_bucket(50_000)
    sd = analyzer._upload_padded(small, 50_000, sb)
    np.testing.assert_array_equal(np.asarray(sd)[:, :50_000], small)


def test_s16_grid_detection_and_device_convert(monkeypatch):
    """16-bit-source samples (every value k/32768) upload as int16 (half the
    h2d bytes) and convert on device bit-exactly; anything off-grid must be
    rejected so the f32 path stays authoritative."""
    from thesia_tpu.dsp import spectrogram as S

    monkeypatch.setattr(S, "_S16_GRID_MIN_BYTES", 0)
    rng = np.random.default_rng(12)
    ints = rng.integers(-32768, 32768, (2, 50_000), np.int64).astype(np.int16)
    wavs = ints.astype(np.float32) / 32768.0
    got = S._as_s16_grid(wavs)
    assert got is not None and got.dtype == np.int16
    np.testing.assert_array_equal(got, ints)
    # device conversion reproduces the host floats bit-for-bit
    back = np.asarray(S._s16_to_f32(jnp.asarray(got)))
    np.testing.assert_array_equal(back, wavs)
    # -1.0 (= -32768) is on-grid; +1.0 and float-source noise are not
    w2 = wavs.copy(); w2[0, 0] = -1.0
    assert S._as_s16_grid(w2) is not None
    w3 = wavs.copy(); w3[0, 0] = 1.0
    assert S._as_s16_grid(w3) is None
    w4 = wavs.copy(); w4[1, 123] = 0.3333333
    assert S._as_s16_grid(w4) is None
    # gained tracks fall off the grid
    assert S._as_s16_grid(wavs * np.float32(10 ** (-3 / 20))) is None
    # below the size threshold the host passes are skipped entirely
    monkeypatch.setattr(S, "_S16_GRID_MIN_BYTES", 1 << 30)
    assert S._as_s16_grid(wavs) is None


def test_device_wav_s16_path_spec_bitexact(monkeypatch):
    """calc_spec_multi through the int16 upload path must produce the same
    dB spectrogram bit-for-bit as the f32 upload path."""
    from thesia_tpu.dsp import spectrogram as S

    rng = np.random.default_rng(13)
    ints = rng.integers(-30000, 30000, (2, 60_000), np.int64).astype(np.int16)
    wavs = ints.astype(np.float32) / 32768.0
    s = SpecSetting()
    ref = SpectrogramAnalyzer().calc_spec_multi(wavs, 16000, s)
    monkeypatch.setattr(S, "_S16_GRID_MIN_BYTES", 0)
    via_s16 = SpectrogramAnalyzer().calc_spec_multi(wavs, 16000, s)
    np.testing.assert_array_equal(np.asarray(via_s16.db_padded), np.asarray(ref.db_padded))
    assert via_s16.min_max_db() == ref.min_max_db()


def test_rebucket_pads_on_device_bitexact():
    """When pad + n + pad overflows the cached upload's bucket (n exactly at
    a bucket boundary), the spec path zero-extends the cached device array
    instead of re-uploading — result must equal a fresh compute bit-for-bit."""
    from thesia_tpu.dsp.spectrogram import _WAV_BUCKET_BASE

    n = _WAV_BUCKET_BASE  # == bucket(n), so any pad overflows it
    rng = np.random.default_rng(31)
    wavs = rng.uniform(-1, 1, (1, n)).astype(np.float32)
    s = SpecSetting(win_ms=40.0, t_overlap=4)
    an = SpectrogramAnalyzer()
    an.calc_spec_multi(wavs, 8000, s, cache_key="k", token=1)  # seeds cache at bucket(n)
    cached = an.calc_spec_multi(wavs, 8000, s, cache_key="k", token=1)
    fresh = SpectrogramAnalyzer().calc_spec_multi(wavs, 8000, s)
    assert cached.n_frames == fresh.n_frames
    np.testing.assert_array_equal(
        np.asarray(cached.db_padded)[:, : cached.n_frames],
        np.asarray(fresh.db_padded)[:, : fresh.n_frames],
    )
    assert cached.min_max_db() == fresh.min_max_db()


@pytest.mark.parametrize("fmt", ["s16", "s24", "f32"])
def test_prefetch_interleaved_pcm_bitexact(fmt, monkeypatch):
    """Device-side deinterleave+convert of raw interleaved WAV payloads must
    reproduce the host decoder's planar f32 bit-for-bit for every supported
    prefetch depth (s16, packed s24, f32)."""
    from thesia_tpu.dsp import spectrogram as S
    from thesia_tpu.io.wav import decode_wav, encode_wav_s16, probe_wav

    monkeypatch.setattr(S.SpectrogramAnalyzer, "_PREFETCH_MIN_BYTES", 0)
    rng = np.random.default_rng(61)
    n, c = 50_000, 2
    if fmt == "s16":
        w = rng.uniform(-0.9, 0.9, (c, n)).astype(np.float32)
        data = encode_wav_s16(w, 8000)
    elif fmt == "f32":
        import struct

        w = rng.uniform(-0.9, 0.9, (c, n)).astype(np.float32)
        inter = np.ascontiguousarray(w.T, np.float32).tobytes()
        fmtc = struct.pack("<HHIIHH", 3, c, 8000, 8000 * c * 4, c * 4, 32)
        chunks = b"WAVE" + b"fmt " + struct.pack("<I", len(fmtc)) + fmtc
        chunks += b"data" + struct.pack("<I", len(inter)) + inter
        data = b"RIFF" + struct.pack("<I", len(chunks)) + chunks
    else:  # packed little-endian s24
        import struct

        ints = rng.integers(-(1 << 23), 1 << 23, (n, c), np.int64).astype(np.int32)
        u = ints.astype(np.uint32) & 0xFFFFFF
        b = np.empty((n * c, 3), np.uint8)
        flatu = u.reshape(-1)
        b[:, 0] = flatu & 0xFF
        b[:, 1] = (flatu >> 8) & 0xFF
        b[:, 2] = (flatu >> 16) & 0xFF
        inter = b.tobytes()
        fmtc = struct.pack("<HHIIHH", 1, c, 8000, 8000 * c * 3, c * 3, 24)
        chunks = b"WAVE" + b"fmt " + struct.pack("<I", len(fmtc)) + fmtc
        chunks += b"data" + struct.pack("<I", len(inter)) + inter
        data = b"RIFF" + struct.pack("<I", len(chunks)) + chunks

    planar, _sr, _codec = decode_wav(data)
    fmt_tag, bits, n_ch, _sr2, payload = probe_wav(data)
    an = SpectrogramAnalyzer()
    res = an.upload_interleaved_pcm(payload, n_ch, fmt)
    assert res is not None
    dev, got_n, probe = res
    assert got_n == n and dev.shape[0] == c
    np.testing.assert_array_equal(np.asarray(dev)[:, :n], planar)
    assert not np.asarray(dev)[:, n:].any()
    assert an.prefetch_matches(probe, planar)
    # a corrupted decode must be rejected by the probe
    bad = planar.copy()
    bad[probe[0][3] % c, probe[0][3] // c] += np.float32(1e-3)
    assert not an.prefetch_matches(probe, bad)
