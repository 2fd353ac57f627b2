"""The numpy float64 reference (thesia_tpu/dsp/reference.py) against the
device path at small sizes, on the CPU backend.

chip_smoke.py makes the same comparison on the GPU at real sizes; these
tests pin that the reference agrees with the engine where both are exact
enough to tell, and that its checks reject a spectrogram computed from
TF32-rounded products.
"""

import numpy as np
import pytest

from thesia_tpu.common.freqscale import FreqScale
from thesia_tpu.common.windows import WindowType, calc_normalized_win
from thesia_tpu.dsp import reference
from thesia_tpu.dsp import spectrogram as sg
from thesia_tpu.dsp.framing import SpecSetting
from thesia_tpu.dsp.stft import stft_frame_count
from thesia_tpu.render.visualize import convert_spectrogram_to_img

# (sample rate, setting); the last takes the rfft route at its window
CASES = [
    (48000, SpecSetting()),
    (44100, SpecSetting(win_ms=80.0, freq_scale=FreqScale.Linear)),
    (96000, SpecSetting(win_ms=100.0)),
    (16000, SpecSetting(win_ms=20.0, t_overlap=8, freq_scale=FreqScale.Linear)),
]
# the CPU backend's error at these cases is below 1e-2 dB near the row max
# and 1e-6 of the row max elsewhere (float32 GEMMs at HIGHEST)
CPU_TOLERANCE = reference.DbError(1e-2, 1e-6, 0)


def _signal(sr, seconds, n_ch, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = rng.normal(0.0, 0.01, (n_ch, t.size))
    for f, a in ((110.0, 0.2), (440.0, 0.1), (0.3 * sr, 0.02)):
        x += a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi, (n_ch, 1)))
    return x.astype(np.float32)


def _tf32(a):
    """Round float32 to TF32's 10-bit mantissa (round half up on the bits)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_window_and_frame_count_match_the_engine_definitions():
    for win, n_fft in ((1920, 2048), (441, 512), (7680, 8192)):
        np.testing.assert_allclose(
            reference.hann_normalized(win, n_fft),
            calc_normalized_win(WindowType.Hann, win, n_fft),
            rtol=0, atol=1e-6 / n_fft,  # the engine builds it in float32
        )
        for n in (win + 1, 10 * win + 7, 48000):
            assert reference.frame_count(n, win, win // 4) == stft_frame_count(n, win, win // 4)


@pytest.mark.parametrize("sr, setting", CASES)
def test_device_spectrogram_matches_reference(sr, setting):
    wavs = _signal(sr, 2.0, 2, seed=sr)
    res = sg.SpectrogramAnalyzer().calc_spec_multi(wavs, sr, setting)
    got = np.asarray(res.db_padded)[:, : res.n_frames]
    ref = reference.spec_db(wavs, sr, setting)
    assert got.shape == ref.shape
    err = reference.db_error(got, ref)
    assert err.within(CPU_TOLERANCE), err


def test_reference_frame_subset_equals_full_computation():
    sr, setting = 22050, SpecSetting()
    wavs = _signal(sr, 1.5, 1, seed=3)
    full = reference.spec_db(wavs, sr, setting)
    idx = np.array([0, 1, 17, full.shape[1] - 1])
    np.testing.assert_array_equal(reference.spec_db(wavs, sr, setting, idx), full[:, idx])
    gained = reference.spec_db(wavs, sr, setting, idx, gain=0.5)
    np.testing.assert_allclose(gained, full[:, idx] - 20 * np.log10(2.0), atol=1e-9)


def test_tf32_rounded_spectrogram_is_rejected():
    """Products of TF32-rounded operands fail the bound the HIGHEST path
    is held to (the CPU error times BOUND_FACTOR), as on the GPU."""
    sr, setting = 48000, SpecSetting()
    wavs = _signal(sr, 2.0, 1, seed=11)
    analyzer = sg.SpectrogramAnalyzer()
    res = analyzer.calc_spec_multi(wavs, sr, setting)
    ref = reference.spec_db(wavs, sr, setting)
    bound = reference.db_error(
        np.asarray(res.db_padded)[:, : res.n_frames], ref
    ).scaled(reference.BOUND_FACTOR)

    hop, win, n_fft = setting.calc_framing_params(sr)
    cw, sw = (np.asarray(m) for m in analyzer._dft_mats(win, n_fft))
    mel = np.asarray(analyzer.mel_fb(sr, n_fft))
    padded = np.pad(wavs, ((0, 0), (win // 2, win // 2)), mode="reflect")
    frames = _tf32(padded[:, np.arange(res.n_frames)[:, None] * hop + np.arange(win)])
    re = frames.astype(np.float64) @ _tf32(cw).astype(np.float64)
    im = frames.astype(np.float64) @ _tf32(sw).astype(np.float64)
    mag = _tf32(np.sqrt(re * re + im * im)).astype(np.float64) @ _tf32(mel).astype(np.float64)
    err = reference.db_error(20.0 * np.log10(mag), ref)
    assert not err.within(bound), (err, bound)
    assert err.near_db > 3 * bound.near_db


@pytest.mark.parametrize("colormap_length", [258, 6])
def test_quantize_matches_host_quantizer(colormap_length):
    from thesia_tpu.render.visualize import quantize_min_value

    rng = np.random.default_rng(colormap_length)
    db = rng.uniform(-130.0, 5.0, (300, 64)).astype(np.float32)
    db[3, 7] = np.nan
    lo, hi = -100.0, 0.0
    want = convert_spectrogram_to_img(db, (4, 70), (lo, hi), colormap_length)
    got = reference.quantize_u16(
        db.astype(np.float64), lo, float(np.float32(hi - lo)), 4, 66,
        quantize_min_value(colormap_length),
    )
    near, overall, share = reference.u16_diff(got, want, db.astype(np.float64), 4)
    assert overall <= 1 and share < 0.01
    assert (got[60:] == 0).all()


def test_engine_u16_image_within_one_step_of_reference(tmp_path):
    from thesia_tpu.engine.manager import TrackManager
    from thesia_tpu.engine.track import TrackList
    from thesia_tpu.io.wav import encode_wav_f32
    from thesia_tpu.render.visualize import quantize_min_value

    paths = []
    for i, sr in enumerate((16000, 22050)):
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(_signal(sr, 1.0, 1 + i, seed=i), sr))
        paths.append(str(p))
    tl, tm = TrackList(), TrackManager()
    tm.set_colormap_length(tl, 258)
    ids = tl.add_tracks([0, 1], paths)
    tm.add_tracks(tl, ids)
    tm.apply_track_list_changes(tl)
    imgs = tm.spec_imgs
    lo, span = (float(np.asarray(v)) for v in tm._quant_scalars())
    for tid in ids:
        track = tl[tid]
        ref = reference.spec_db(track.audio.wavs, track.sr, tm.setting)
        i_start, i_end = tm.setting.freq_scale.hz_range_to_idx(
            (0.0, tm.max_sr / 2.0), track.sr, ref.shape[-1])
        for ch in range(track.n_ch):
            want = reference.quantize_u16(
                ref[ch], lo, span, i_start, i_end - i_start, quantize_min_value(258))
            near, _overall, _share = reference.u16_diff(
                np.asarray(imgs[(tid, ch)]), want, ref[ch], i_start)
            assert near <= 1
