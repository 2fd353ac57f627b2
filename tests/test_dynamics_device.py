"""Device (JAX f64) dynamics vs host/native reference parity.

reference semantics: src-tauri/src/core/dynamics/limiter.rs:45-172 (gain
chain), stats.rs:44-86 (LUFS/stats via ebur128).
"""

import numpy as np
import pytest

from thesia_tpu.dynamics.limiter import PerfectLimiter
from thesia_tpu.dynamics.loudness import integrated_lufs
from thesia_tpu.dynamics.stats import calc_stats
from thesia_tpu.dynamics import stats_device



@pytest.mark.parametrize("sr", [8000, 44100, 48000])
def test_limiter_gain_device_matches_streaming(sr):
    rng = np.random.default_rng(sr)
    n = 30000
    wavs = (rng.uniform(-1, 1, (2, n)) * 2.5).astype(np.float32)
    expected = PerfectLimiter(sr).calc_gain_seq(wavs)
    got = stats_device.limiter_gain_seqs_batched([("k", wavs, sr)])
    assert got is not None
    assert got["k"].shape == (n,)
    np.testing.assert_allclose(got["k"], expected, atol=1e-9, rtol=0)


def test_limiter_gain_device_batched_mixed_lengths():
    sr = 16000
    rng = np.random.default_rng(0)
    items = [
        (k, (rng.uniform(-1, 1, (c, n)) * amp).astype(np.float32), sr)
        for k, (c, n, amp) in enumerate([(1, 9000, 3.0), (2, 15000, 1.5), (1, 4000, 8.0)])
    ]
    got = stats_device.limiter_gain_seqs_batched(items)
    assert got is not None
    lim = PerfectLimiter(sr)
    for k, wavs, _sr in items:
        np.testing.assert_allclose(got[k], lim.calc_gain_seq(wavs), atol=1e-9, rtol=0)


def test_limiter_gain_device_silence_and_tail():
    """Quiet signals produce all-ones gain; limiting releases toward 1."""
    sr = 8000
    w = np.zeros((1, 5000), np.float32)
    w[0, 1000] = 4.0  # single spike
    got = stats_device.limiter_gain_seqs_batched([(0, w, sr)])[0]
    exp = PerfectLimiter(sr).calc_gain_seq(w)
    np.testing.assert_allclose(got, exp, atol=1e-9, rtol=0)
    assert got.min() < 0.3 and got[-1] > 0.9


@pytest.mark.parametrize("sr", [16000, 44100, 48000])
def test_lufs_device_matches_host(sr):
    rng = np.random.default_rng(sr)
    t = np.arange(int(sr * 2.5)) / sr
    sine = (0.4 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    noise = (0.1 * rng.standard_normal(len(t))).astype(np.float32)
    for wavs in [sine[None], np.stack([sine, noise]), noise[None] * 0.001]:
        exp = integrated_lufs(wavs, sr)
        got = stats_device.integrated_lufs_device(wavs, sr)
        assert got is not None
        if np.isinf(exp):
            assert np.isinf(got)
        else:
            assert abs(got - exp) < 1e-9


def test_lufs_device_gating_below_absolute_gate():
    sr = 48000
    quiet = np.full((1, sr), 1e-5, np.float32)
    got = stats_device.integrated_lufs_device(quiet, sr)
    exp = integrated_lufs(quiet, sr)
    assert (np.isinf(got) and np.isinf(exp)) or abs(got - exp) < 1e-9


def test_calc_stats_batched_matches_host():
    rng = np.random.default_rng(7)
    items = [
        (k, (rng.uniform(-1, 1, (c, n)) * a).astype(np.float32), sr)
        for k, (c, n, a, sr) in enumerate(
            [(2, 48000, 0.5, 48000), (1, 30000, 0.9, 48000), (2, 20000, 0.2, 16000)]
        )
    ]
    got = stats_device.calc_stats_batched(items)
    assert got is not None
    for k, wavs, sr in items:
        exp = calc_stats(wavs, sr)
        assert abs(got[k].global_lufs - exp.global_lufs) < 1e-9
        assert got[k].max_peak == exp.max_peak
        assert got[k].max_peak_db == exp.max_peak_db
        assert abs(got[k].rms_db - exp.rms_db) < 1e-5


def test_tracklist_batched_limiter_end_to_end(tmp_path):
    """TrackList Limiter path (batched device program) == per-track path."""
    from thesia_tpu.dynamics.guard import GuardClippingMode
    from thesia_tpu.dynamics.normalize import NormalizeTarget
    from thesia_tpu.engine.track import TrackList
    from thesia_tpu.io.wav import encode_wav_f32

    rng = np.random.default_rng(3)
    paths = []
    for i, (c, n) in enumerate([(2, 12000), (1, 9000)]):
        w = (rng.uniform(-0.5, 0.5, (c, n))).astype(np.float32)
        p = tmp_path / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(w, 8000))
        paths.append(str(p))

    def build(force_single):
        tl = TrackList()
        tl.common_guard_clipping = GuardClippingMode.Limiter
        tl.common_normalize = NormalizeTarget(type="LUFS", target=-3.0)
        ids = tl.add_tracks(list(range(len(paths))), paths)
        if force_single:
            # re-apply per-track (streaming/native path)
            for tid in ids:
                tl[tid].normalize(tl.common_normalize, tl.common_guard_clipping)
        return tl, ids

    tl_b, ids = build(False)
    tl_s, _ = build(True)
    for tid in ids:
        a, b = tl_b[tid].audio, tl_s[tid].audio
        assert a.guard_clip_result.kind == b.guard_clip_result.kind == "gain_sequence"
        np.testing.assert_allclose(
            a.guard_clip_result.gain_seq, b.guard_clip_result.gain_seq, atol=1e-7
        )
        np.testing.assert_allclose(a.wavs, b.wavs, atol=1e-6)
        assert a.wavs.max() <= 1.0 and a.wavs.min() >= -1.0
