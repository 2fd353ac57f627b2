"""Batched center-padded STFT.

Semantics match the reference STFT (reference:
src-tauri/src/core/spectrogram/stft.rs:16-149):

  * reflect-pad win//2 samples on each side (cyclic reflection when the pad
    exceeds the signal length, reference: src-tauri/src/core/utils.rs:61-142),
  * frames of length win at stride hop starting at -win//2,
  * each frame windowed by (hann / n_fft) and zero-padded to n_fft with the
    window centered ((n_fft-win)//2 zeros on the left),
  * real FFT of size n_fft -> (n_frames, n_fft//2 + 1) complex.

The reference implements this with a 3-region (front/mid/back) frame loop +
per-frame rustfft calls on a thread pool.  Here the whole thing is one fused
XLA program: the real DFT is expressed as two matmuls against
window-folded cosine/sine matrices of shape (win, n_freq) — zero-padding and
windowing cost nothing because they are folded into the DFT matrix rows.
XLA then fuses |.|, the mel GEMM and the dB conversion into the same
pipeline (see spectrogram.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def stft_frame_count(n_samples: int, win_length: int, hop_length: int) -> int:
    """Number of STFT frames for a center-padded signal.

    Equals the frame count of the reference's front/mid/back construction
    (stft.rs:50-97): frames start at t*hop - win//2 and must fit inside the
    padded extent [-win//2, n_samples + win//2).
    """
    padded = n_samples + 2 * (win_length // 2)
    if padded < win_length:
        return 0
    return (padded - win_length) // hop_length + 1


def reflect_indices(n: int, n_left: int, n_right: int) -> np.ndarray:
    """Index map implementing cyclic reflect padding (utils.rs:111-138)."""
    if n == 1:
        return np.zeros(n_left + 1 + n_right, dtype=np.int64)
    period = 2 * (n - 1)
    i = np.arange(-n_left, n + n_right, dtype=np.int64)
    j = np.mod(i, period)
    j = np.where(j >= n, period - j, j)
    return j


def reflect_pad_1d(x: np.ndarray, n_left: int, n_right: int) -> np.ndarray:
    """Cyclic reflect padding of a 1-D array (host-side, cheap)."""
    idx = reflect_indices(x.shape[-1], n_left, n_right)
    return x[..., idx]


# -------------------------------------------------------------------------
# Device kernels


def make_dft_matrices(
    window: np.ndarray, n_fft: int, n_pad_left: int, dtype=np.float32
) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT matrices (win, n_freq).

    Re[t,k] = sum_i frame[t,i] * w[i] * cos(-2*pi*k*(n_pad_left+i)/n_fft)
    so a frame of raw samples matmul'd with these gives the same result as
    window -> center-zero-pad to n_fft -> rfft.  Built in float64, cast down.
    """
    win = window.shape[0]
    n_freq = n_fft // 2 + 1
    i = np.arange(win, dtype=np.float64) + n_pad_left
    k = np.arange(n_freq, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(i, k) / n_fft
    w = window.astype(np.float64)[:, None]
    cw = (np.cos(ang) * w).astype(dtype)
    sw = (np.sin(ang) * w).astype(dtype)
    return cw, sw


def frame_starts(chunk_frames: int, hop_length: int):
    return jnp.arange(chunk_frames, dtype=jnp.int32) * hop_length


def gather_frames(padded_wav, t0, chunk_frames: int, win_length: int, hop_length: int):
    """Gather `chunk_frames` frames starting at frame index t0 from a
    (reflect-padded, device-resident) signal. Out-of-range reads clamp; the
    caller discards frames beyond the valid count."""
    starts = t0 * hop_length + frame_starts(chunk_frames, hop_length)
    idx = starts[:, None] + jnp.arange(win_length, dtype=jnp.int32)[None, :]
    return jnp.take(padded_wav, idx, axis=-1, mode="clip")


def perform_stft(
    wav: np.ndarray,
    win_length: int,
    hop_length: int,
    n_fft: int,
    window: np.ndarray | None = None,
) -> np.ndarray:
    """Reference-semantics STFT -> complex64 (n_frames, n_fft//2+1).

    Correctness-path entry point (tests, small inputs). The production path
    is SpectrogramAnalyzer.calc_spec which fuses magnitude/mel/dB and chunks
    frames.
    """
    from ..common.windows import WindowType, calc_normalized_win

    if window is None:
        window = calc_normalized_win(WindowType.Hann, win_length, n_fft)
    n = wav.shape[-1]
    n_frames = stft_frame_count(n, win_length, hop_length)
    pad = win_length // 2
    padded = reflect_pad_1d(np.asarray(wav, np.float32), pad, pad)
    n_pad_left = (n_fft - win_length) // 2
    cw, sw = make_dft_matrices(window, n_fft, n_pad_left)
    frames = np.stack(
        [padded[t * hop_length : t * hop_length + win_length] for t in range(n_frames)]
    )
    frames_j = jnp.asarray(frames)
    re = jnp.dot(frames_j, jnp.asarray(cw), precision=jax.lax.Precision.HIGHEST)
    im = jnp.dot(frames_j, jnp.asarray(sw), precision=jax.lax.Precision.HIGHEST)
    return np.asarray(re) + 1j * np.asarray(im)
