"""Plain numpy float64 reference for the device spectrogram path.

Independent of the code under test (dsp/stft.py, dsp/spectrogram.py,
engine/images.py): reflect padding, framing, a windowed np.fft.rfft per
frame, the mel filterbank, dB and the u16 quantization are written out here
again in float64.  The filterbank weights and the framing parameters are
the engine's inputs, not its computation, so they come from
common/melscale.py and dsp/framing.py.  chip_smoke.py compares the engine
with this module on the GPU; tests/test_reference.py does so on the CPU.

Tolerances.  The engine's GEMMs run at Precision.HIGHEST (full float32
products).  Its error against this reference is bounded only relative to
each frame's loudest bin, so the checks split every frame ("row") in two:
bins within NEAR_DB of the row maximum are held to a dB bound, and bins
below that to a bound on |magnitude error| / row-maximum magnitude.  Both
bounds are set from the CPU backend's own error on the same input, times
BOUND_FACTOR (cuBLAS and XLA's CPU dot sum in different orders, so equal
errors are not expected; a float32 product rounded to TF32's 10-bit
mantissa is off by orders of magnitude more).  u16 images must agree within
one quantization step at every pixel within U16_NEAR_DB of its frame's
loudest bin (see u16_diff).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..common.freqscale import FreqScale
from ..common.melscale import calc_mel_fb_default
from .framing import SpecSetting

NEAR_DB = 60.0
BOUND_FACTOR = 16.0
U16_NEAR_DB = 40.0


def hann_normalized(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window divided by n_fft (the reference STFT's
    normalization), float64."""
    i = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / win_length)) / n_fft


def frame_count(n: int, win_length: int, hop: int) -> int:
    return (n + 2 * (win_length // 2) - win_length) // hop + 1


def spec_db(wavs: np.ndarray, sr: int, setting: SpecSetting, frames=None,
            gain: float = 1.0) -> np.ndarray:
    """(C, n) float32 samples -> (C, len(frames), F) float64 dB.

    frames: frame indices to compute (default: all).  gain multiplies the
    samples in float32 first, as the engine applies its track gain.
    F is the mel band count (Mel) or n_fft // 2 + 1 (Linear)."""
    wavs = np.atleast_2d(np.asarray(wavs, np.float32))
    if gain != 1.0:
        wavs = (np.float32(gain) * wavs).astype(np.float32)
    hop, win, n_fft = setting.calc_framing_params(sr)
    n = wavs.shape[1]
    pad = win // 2
    if frames is None:
        frames = np.arange(frame_count(n, win, hop))
    frames = np.asarray(frames, np.int64)
    window = hann_normalized(win, n_fft)
    mel = (
        calc_mel_fb_default(sr, n_fft).astype(np.float64)
        if setting.freq_scale is FreqScale.Mel else None
    )
    # bounded host memory: ~2^25 float64 frame samples per chunk
    chunk = max(1, (1 << 25) // n_fft)
    out = []
    for row in wavs:
        padded = np.pad(row.astype(np.float64), pad, mode="reflect")
        parts = []
        for k in range(0, len(frames), chunk):
            idx = frames[k : k + chunk]
            x = padded[idx[:, None] * hop + np.arange(win)[None, :]]
            # |DFT| of the window centered in n_fft zeros equals |rfft| of
            # the window zero-padded at the end: a shift only turns phase
            mag = np.abs(np.fft.rfft(x * window, n=n_fft, axis=1))
            if mel is not None:
                mag = mag @ mel
            with np.errstate(divide="ignore"):
                parts.append(20.0 * np.log10(mag))
        out.append(np.concatenate(parts, axis=0))
    return np.stack(out)


def quantize_u16(db: np.ndarray, lo: float, span: float, i_start: int,
                 height: int, min_value: int) -> np.ndarray:
    """(T, F) dB -> (height, T) u16 image: row r is bin i_start + r, values
    below/above [lo, lo + span] clamp to [min_value, 65535], rows past the
    available bins stay 0, NaN maps to 0 (drawing.rs:6-36 semantics)."""
    t, f = db.shape
    n_rows = max(min(i_start + height, f) - i_start, 0)
    out = np.zeros((height, t), np.uint16)
    if n_rows:
        vals = (db[:, i_start : i_start + n_rows].T - lo) / span * (65535 - min_value) + min_value
        vals = np.where(np.isnan(vals), 0.0, vals)
        rounded = np.sign(vals) * np.floor(np.abs(vals) + 0.5)
        out[:n_rows] = np.clip(rounded, 0.0, 65535.0).astype(np.uint16)
    return out


@dataclasses.dataclass
class DbError:
    """Worst error of a device spectrogram against the reference."""

    near_db: float  # max |dB error| over bins within NEAR_DB of the row max
    far_rel: float  # max |magnitude error| / row-max magnitude, other bins
    bins: int

    def merge(self, other: "DbError") -> "DbError":
        return DbError(
            max(self.near_db, other.near_db), max(self.far_rel, other.far_rel),
            self.bins + other.bins,
        )

    def within(self, bound: "DbError") -> bool:
        return self.near_db <= bound.near_db and self.far_rel <= bound.far_rel

    def scaled(self, factor: float) -> "DbError":
        return DbError(self.near_db * factor, self.far_rel * factor, self.bins)


def db_error(got_db: np.ndarray, ref_db: np.ndarray) -> DbError:
    """Error of got (any float dtype, ..., F) against ref (..., F), per the
    module docstring's split at NEAR_DB below each row's maximum."""
    got = np.asarray(got_db, np.float64)
    row_max = ref_db.max(axis=-1, keepdims=True)
    near = ref_db >= row_max - NEAR_DB
    with np.errstate(invalid="ignore"):
        d = np.abs(got - ref_db)
    near_db = float(d[near].max()) if near.any() else 0.0
    far = ~near
    if far.any():
        rel = np.abs(10.0 ** ((got - row_max) / 20.0) - 10.0 ** ((ref_db - row_max) / 20.0))
        far_rel = float(rel[far].max())
    else:
        far_rel = 0.0
    return DbError(near_db, far_rel, int(ref_db.size))


def u16_diff(got: np.ndarray, ref: np.ndarray, ref_db: np.ndarray, i_start: int):
    """Compare a (height, T) u16 image with the reference image.

    ref_db: the (T, F) reference dB the reference image was quantized from.
    Returns (max |step difference| over pixels whose bin lies within
    U16_NEAR_DB of its frame's loudest bin, max |step difference| over all
    pixels, share of pixels that differ).  Lower bins carry the float32
    GEMM's error relative to the frame maximum, which exceeds one step
    there; db_error's magnitude bound covers them."""
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    n_rows = max(min(i_start + got.shape[0], ref_db.shape[1]) - i_start, 0)
    row_max = ref_db.max(axis=1)
    near = np.zeros(got.shape, bool)
    near[:n_rows] = ref_db[:, i_start : i_start + n_rows].T >= row_max[None, :] - U16_NEAR_DB
    near_max = int(d[near].max()) if near.any() else 0
    return near_max, int(d.max()) if d.size else 0, float(np.count_nonzero(d)) / max(d.size, 1)
