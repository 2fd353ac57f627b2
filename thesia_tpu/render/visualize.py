"""dB spectrogram -> u16 image quantization.

reference: src-tauri/src/core/visualize/drawing.rs:6-36.

The u16 range is [min_value, 65535] where min_value = round(65535 /
colormap_length) (reserving 0 as the out-of-band black), values below/above
the dB range clamp, and frequency rows outside the computed spectrogram
(tracks whose sr is below the global max) are 0.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def quantize_min_value(colormap_length: int | None) -> int:
    """The ONE definition of min_value — the host quantizer, the device
    quantize dispatch (engine/manager.py) and the precompile warmup
    (dsp/precompile.py) must all agree or warmed executables go stale.
    floor(x+0.5), not np.round: the reference's f64 round() is
    half-away-from-zero (drawing.rs:21; np.round's banker's rounding
    diverges for colormap lengths whose 65535/l quotient ends in
    even+0.5, e.g. length 6 -> 10923 not 10922)."""
    if colormap_length is None:
        return 1
    return max(int(np.floor(65535.0 / colormap_length + 0.5)), 1)


_min_value = quantize_min_value  # internal alias


def convert_spectrogram_to_img(
    spec: np.ndarray,
    i_freq_range: tuple[int, int],
    db_range: tuple[float, float],
    colormap_length: int | None,
) -> np.ndarray:
    """spec (T, F) f32 dB -> image (H, T) u16 with H = i_freq_end - i_freq_start.

    Row i of the image is frequency bin i_freq_start + i (low freq at row 0;
    tile encoding flips to high-first at serialization time).
    """
    spec = np.asarray(spec)
    i_start, i_end = i_freq_range
    height = i_end - i_start
    width = spec.shape[0]
    if db_range[0] == db_range[1] and np.isneginf(db_range[1]):
        return np.zeros((height, width), np.uint16)
    assert np.isfinite(db_range[0])
    min_value = _min_value(colormap_length)
    u16_span = np.float32(65535 - min_value)
    db_span = np.float32(db_range[1] - db_range[0])

    f_avail = spec.shape[1]
    n_rows = max(min(i_end, f_avail) - i_start, 0)
    out = np.zeros((height, width), np.uint16)
    if n_rows > 0:
        sub = spec[:, i_start : i_start + n_rows].T.astype(np.float32)  # (n_rows, T)
        zero_to_one = (sub - np.float32(db_range[0])) / db_span
        vals = zero_to_one * u16_span + np.float32(min_value)
        # rust f32::round (half away from zero) then clamp to [0, 65535]
        vals = np.where(np.isnan(vals), 0.0, vals)
        rounded = np.sign(vals) * np.floor(np.abs(vals) + 0.5)
        out[:n_rows] = np.clip(rounded, 0.0, 65535.0).astype(np.uint16)
    return out


def convert_spectrogram_to_img_device(
    spec: jnp.ndarray,
    i_freq_range: tuple[int, int],
    db_range: tuple[float, float],
    colormap_length: int | None,
) -> jnp.ndarray:
    """Device version (jnp), same semantics; spec stays device-resident."""
    i_start, i_end = i_freq_range
    height = i_end - i_start
    width = spec.shape[0]
    if db_range[0] == db_range[1] and np.isneginf(db_range[1]):
        return jnp.zeros((height, width), jnp.uint16)
    min_value = _min_value(colormap_length)
    u16_span = np.float32(65535 - min_value)
    db_span = np.float32(db_range[1] - db_range[0])
    f_avail = spec.shape[1]
    n_rows = max(min(i_end, f_avail) - i_start, 0)
    out = jnp.zeros((height, width), jnp.uint16)
    if n_rows > 0:
        sub = spec[:, i_start : i_start + n_rows].T.astype(jnp.float32)
        vals = (sub - np.float32(db_range[0])) / db_span * u16_span + np.float32(min_value)
        vals = jnp.where(jnp.isnan(vals), 0.0, vals)
        rounded = jnp.sign(vals) * jnp.floor(jnp.abs(vals) + 0.5)
        out = out.at[:n_rows].set(jnp.clip(rounded, 0.0, 65535.0).astype(jnp.uint16))
    return out
