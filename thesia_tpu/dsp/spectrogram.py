"""Fused spectrogram pipeline: pad -> frames -> DFT GEMMs -> |.| -> mel -> dB.

Device rework of the reference analyzer (reference:
src-tauri/src/core/spectrogram.rs:101-253).  The reference caches windows,
rustfft plans and mel filterbanks per parameter set and runs per-frame FFTs
on a rayon pool; here each parameter set compiles ONE fused XLA program that
processes a whole track (all channels batched).

Hot-path design (interactive viewers can't afford recompiles or chatty
host<->device traffic):

  * raw waveforms live in a device-side cache, uploaded once per track into
    geometric size buckets -> settings changes never re-upload audio;
  * reflect padding is applied on device with dynamic-update-slices (the
    pad amount depends on the window, the track length is a dynamic scalar);
  * frames come from `t_overlap` shifted strided slices (win == hop *
    t_overlap by construction) -> no general gather anywhere;
  * the real DFT is two matmuls against window-folded cos/sin matrices
    (windowing + center zero-padding folded into the matrix rows);
  * masked min/max over valid frames are computed inside the same program,
    so the global dB-range pass needs only two scalars per track;
  * compilation is keyed on (bucket, pad, hop, t_overlap, F) only — every
    track length reuses the same executable.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..common.freqscale import FreqScale
from ..common.melscale import calc_mel_fb_default
from ..common.windows import WindowType, calc_normalized_win
from .framing import SpecSetting, SrWinNfft
from .stft import make_dft_matrices, reflect_pad_1d, stft_frame_count


def _matmul_precision():
    """Precision of the DFT/mel GEMMs.  Default HIGHEST: full f32 products,
    which keep dB values within the f32 reference's own error.  Lower
    precisions (on a GPU, TF32 tensor-core products) move low bins by many
    u16 steps; THESIA_MATMUL_PRECISION=high|default selects them."""
    name = os.environ.get("THESIA_MATMUL_PRECISION", "highest").lower()
    return {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }.get(name, jax.lax.Precision.HIGHEST)


_WAV_BUCKET_BASE = 1 << 16
_WAV_BUCKET_POW2_MAX = 1 << 24
_WAV_BUCKET_BIG_STEP = 1 << 23
_FRAME_CAP_STEP = 1024


@functools.partial(jax.jit, donate_argnums=0)
def _fold_chunk(buf, part, off):
    """In-place (donated) chunk write for the pipelined wav upload."""
    return jax.lax.dynamic_update_slice(buf, part, (jnp.int32(0), off))


@jax.jit
def _s16_to_f32(ints):
    """Device-side s16 -> f32: int16 is exact in f32 and 2^-15 is a pure
    exponent shift, so this is bit-identical to the host's x / 32768
    (reference semantics: src-tauri/src/core/audio.rs s16 conversion)."""
    return ints.astype(jnp.float32) * np.float32(1.0 / 32768.0)


@functools.partial(jax.jit, static_argnames=("c", "bucket"))
def _deinterleave_flat(flat2d, *, c: int, bucket: int):
    """(1, bucket*c) interleaved int16/f32 (zero tail) -> (c, bucket) f32
    planar.  Per-channel STRIDED 1-D slices, so no (n, c) intermediate with
    a tiny minor dimension is materialized.  For int16, x * 2^-15 is
    bit-identical to the
    host decode's s16 -> x/32768 (reference audio.rs semantics); zeros stay
    zero."""
    flat = flat2d.reshape(-1)
    rows = [
        jax.lax.slice(flat, (ch,), (bucket * c - (c - 1 - ch),), (c,))
        for ch in range(c)
    ]
    x = rows[0][None] if c == 1 else jnp.stack(rows, axis=0)
    if x.dtype == jnp.float32:
        return x
    return x.astype(jnp.float32) * np.float32(1.0 / 32768.0)


@functools.partial(jax.jit, static_argnames=("c", "bucket"))
def _deinterleave_s24(flat2d, *, c: int, bucket: int):
    """(1, bucket*3*c) interleaved packed 24-bit little-endian bytes (zero
    tail) -> (c, bucket) f32 planar.  Three strided byte slices per channel
    combine to sign-extended int32; x * 2^-23 matches the host's
    v / 8388608 exactly (both are exponent shifts)."""
    flat = flat2d.reshape(-1)
    stride = 3 * c
    rows = []
    for ch in range(c):
        def byte(k, _base=3 * ch):
            start = _base + k
            return jax.lax.slice(
                flat, (start,), (start + (bucket - 1) * stride + 1,), (stride,)
            ).astype(jnp.int32)

        v = byte(0) | (byte(1) << 8) | (byte(2) << 16)
        rows.append((v << 8) >> 8)  # sign-extend 24 -> 32
    x = rows[0][None] if c == 1 else jnp.stack(rows, axis=0)
    return x.astype(jnp.float32) * np.float32(1.0 / 8388608.0)


_S16_GRID_MIN_BYTES = 64 << 20  # only worth the host passes for big uploads


def _as_s16_grid(wavs: np.ndarray) -> np.ndarray | None:
    """int16 view of (C, n) f32 samples when EVERY sample lies exactly on the
    s16 grid (k / 32768) — true for 16-bit sources with unit gain.  Uploading
    the ints halves h2d bytes; the device-side convert reproduces the floats
    bit-for-bit (verified by full reconstruction below, so a false positive
    is impossible).  Returns None when off-grid (float sources, gained
    tracks) or when the array is too small for the host passes to pay off."""
    if wavs.nbytes < _S16_GRID_MIN_BYTES or wavs.dtype != np.float32:
        return None
    # cheap strided probe rejects float-source audio without a full pass
    probe = wavs[:, ::4097]
    scaled = probe * np.float32(32768.0)
    if not (
        (probe >= -1.0).all()
        and (probe < 1.0).all()
        and (scaled == np.trunc(scaled)).all()
    ):
        return None
    from .. import native

    if native.available():
        return native.f32_to_s16_grid(wavs)  # one -O3 pass, early exit
    full = wavs * np.float32(32768.0)
    ints = full.astype(np.int16)  # exact for on-grid values; wraps otherwise
    if not (ints.astype(np.float32) * np.float32(1.0 / 32768.0) == wavs).all():
        return None
    return ints


def wav_size_bucket(n: int) -> int:
    """Device wav buffer size class.  Pow2 up to 2^24 samples (executable
    reuse), then multiples of 2^23: long tracks pay at most ~5% padding
    (upload bytes and device memory) instead of up to 100%."""
    b = _WAV_BUCKET_BASE
    while b < n and b < _WAV_BUCKET_POW2_MAX:
        b *= 2
    if b >= n:
        return b
    return -(-n // _WAV_BUCKET_BIG_STEP) * _WAV_BUCKET_BIG_STEP


def frame_cap(n_frames: int) -> int:
    """Frame-count bucket: multiples of 1024.  The pow2 wav bucket alone
    implies up to ~45% garbage frames past the valid count (all masked but
    all computed); capping the frame axis separately removes that waste
    while keeping executable reuse (compile keyed on (bucket, t_cap))."""
    return max(
        (n_frames + _FRAME_CAP_STEP - 1) // _FRAME_CAP_STEP * _FRAME_CAP_STEP,
        _FRAME_CAP_STEP,
    )


def _build_padded_row(raw_row, n, *, pad: int, bucket: int):
    """(B,) raw (valid first n samples) -> (B,) reflect-padded signal.

    padded[pad + i] = raw[i]; [:pad] / [pad+n : pad+n+pad] are reflections.
    Requires n > pad (short tracks take the host path).  vmap-able over rows
    with per-row n.
    """
    head = jnp.flip(jax.lax.dynamic_slice(raw_row, (1,), (pad,)))
    tail = jnp.flip(jax.lax.dynamic_slice(raw_row, (n - pad - 1,), (pad,)))
    out = jnp.zeros((bucket,), raw_row.dtype)
    # slice the update so DUS never clamps the start offset
    out = jax.lax.dynamic_update_slice(out, raw_row[: bucket - pad], (pad,))
    out = jax.lax.dynamic_update_slice(out, head, (0,))
    out = jax.lax.dynamic_update_slice(out, tail, (pad + n,))
    return out


@functools.partial(jax.jit, static_argnames=("pad", "bucket"))
def _build_padded(raw, n, *, pad: int, bucket: int):
    """(C, B) raw with a shared scalar n -> (C, B) reflect-padded."""
    return jax.vmap(
        lambda row: _build_padded_row(row, n, pad=pad, bucket=bucket)
    )(raw)


# Above this operand size the (win, n_freq) folded-DFT matrices switch to a
# framed jnp.fft.rfft: at 2000 ms / 48 kHz the two matrices would need
# ~2 x 25 GB of device memory.  |rfft(frame * window, n_fft)| is EXACTLY the
# centered-zero-pad DFT magnitude (the center shift only rotates phase and
# the pipeline consumes magnitudes), so mel/dB semantics are unchanged.
# Which route is faster at each shape on the GPU is an open measurement;
# until then only the operand size picks the route.
_DFT_MAT_MAX_BYTES = int(os.environ.get("THESIA_DFT_MAT_MAX_BYTES", 256 << 20))


def use_rfft_for(win_length: int, n_fft: int) -> bool:
    return win_length * (n_fft // 2 + 1) * 8 > _DFT_MAT_MAX_BYTES


def _dft_magnitude(frames, cw, sw, rfft_n_fft):
    """(…, win) frames -> (…, n_freq) spectral magnitude.

    GEMM mode (rfft_n_fft None): two matmuls against the window-folded
    cos/sin matrices.  rfft mode: cw IS the window vector (sw unused) and
    the magnitude comes from a real FFT of the windowed frame."""
    if rfft_n_fft is not None:
        return jnp.abs(jnp.fft.rfft(frames * cw, n=rfft_n_fft))
    re = jnp.einsum("ctw,wf->ctf", frames, cw, precision=_matmul_precision())
    im = jnp.einsum("ctw,wf->ctf", frames, sw, precision=_matmul_precision())
    return jnp.sqrt(re * re + im * im)


@functools.partial(
    jax.jit,
    static_argnames=(
        "hop_length", "t_overlap", "use_mel", "bucket", "pad", "t_cap",
        "rfft_n_fft",
    ),
)
def _spec_full(raw, n, gain, cw, sw, mel_fb, *, hop_length: int, t_overlap: int,
               use_mel: bool, bucket: int, pad: int,
               t_cap: int | None = None, rfft_n_fft: int | None = None):
    """Whole-track fused pipeline.

    raw: (C, bucket) with the first n samples valid.  gain: dynamic f32
    scalar applied on device — x * 1.0 is a bitwise identity, so gained and
    ungained tracks share one executable, and a gain change never re-uploads
    the cached device wav (the f32 multiply here is bit-identical to the
    host's apply_gain).  Returns (db (C, T_max, F), min_db scalar, max_db
    scalar) where frames beyond the valid count hold garbage excluded from
    min/max.  t_cap bounds the frame axis (frame_cap bucketing) so the pow2
    wav bucket doesn't inflate it.
    """
    win_length = hop_length * t_overlap
    raw = raw * gain  # 0-padding stays 0 (gain is finite and positive)
    padded = _build_padded(raw, n, pad=pad, bucket=bucket)
    c = padded.shape[0]
    t_max = (bucket - win_length) // hop_length + 1
    if t_cap is not None:
        t_max = min(t_max, t_cap)
    t_blocks = t_max + t_overlap - 1
    blocks = padded[:, : t_blocks * hop_length].reshape(c, t_blocks, hop_length)
    frames = jnp.concatenate(
        [blocks[:, i : i + t_max] for i in range(t_overlap)], axis=2
    )  # (C, T_max, win)
    mag = _dft_magnitude(frames, cw, sw, rfft_n_fft)
    if use_mel:
        out = jnp.einsum(
            "ctf,fm->ctm", mag, mel_fb, precision=_matmul_precision()
        )
    else:
        out = mag
    # dB from amplitude with amin=0 (decibel.rs:212): 0 -> -inf exactly
    db = 20.0 * jnp.where(out > 0, jnp.log10(jnp.where(out > 0, out, 1.0)), -jnp.inf)
    n_frames = (n + 2 * pad - win_length) // hop_length + 1
    mask = (jnp.arange(t_max, dtype=jnp.int32) < n_frames)[None, :, None]
    min_db = jnp.min(jnp.where(mask, db, jnp.inf))
    max_db = jnp.max(jnp.where(mask, db, -jnp.inf))
    return db, min_db, max_db


@functools.partial(
    jax.jit,
    static_argnames=(
        "hop_length", "t_overlap", "use_mel", "bucket", "pad", "shardings",
        "t_cap", "rfft_n_fft",
    ),
)
def _spec_full_multi(raw, ns, gains, cw, sw, mel_fb, *, hop_length: int,
                     t_overlap: int, use_mel: bool, bucket: int, pad: int,
                     shardings=None, t_cap: int | None = None,
                     rfft_n_fft: int | None = None):
    """Multi-track batch: raw (C_total, bucket) with PER-ROW valid lengths ns
    (C_total,) and PER-ROW gains (C_total,) f32 (1.0 rows are bitwise
    identity — see _spec_full).  Returns (db (C, T_max, F), row_min (C,),
    row_max (C,)) with per-row masked bounds.  One device program recomputes
    every track of a (sr, win, n_fft) group (SURVEY §7.8 multi-track batched
    recompute).

    shardings: optional parallel.sharding.SpecSharding — rows spread over the
    mesh "tracks" axis (data parallel; the device analogue of the
    reference's rayon per-(id,ch) fan-out, src-tauri/src/core/mod.rs:152-163)
    and, when enabled, DFT/mel operands over "freq" (tensor parallel; GSPMD
    inserts the psum for the contracted mel GEMM)."""
    return _spec_multi_impl(
        raw, ns, gains, cw, sw, mel_fb, hop_length=hop_length,
        t_overlap=t_overlap, use_mel=use_mel, bucket=bucket, pad=pad,
        shardings=shardings, t_cap=t_cap, rfft_n_fft=rfft_n_fft,
    )


def _spec_multi_impl(raw, ns, gains, cw, sw, mel_fb, *, hop_length, t_overlap,
                     use_mel, bucket, pad, shardings, t_cap,
                     rfft_n_fft=None):
    """Trace-time body shared by _spec_full_multi and the fused multi-group
    program _spec_groups."""
    win_length = hop_length * t_overlap
    c = raw.shape[0]
    if shardings is not None:
        raw = jax.lax.with_sharding_constraint(raw, shardings.rows2)
        ns = jax.lax.with_sharding_constraint(ns, shardings.rows1)
        gains = jax.lax.with_sharding_constraint(gains, shardings.rows1)
        if shardings.mat is not None and rfft_n_fft is None:
            # freq-TP partitions the (win, F) GEMM operands; the rfft
            # fallback has no F-partitionable operand — rows-DP only
            cw = jax.lax.with_sharding_constraint(cw, shardings.mat)
            sw = jax.lax.with_sharding_constraint(sw, shardings.mat)
            if use_mel:
                mel_fb = jax.lax.with_sharding_constraint(mel_fb, shardings.fb)
    raw = raw * gains[:, None]
    padded = jax.vmap(
        lambda row, n: _build_padded_row(row, n, pad=pad, bucket=bucket)
    )(raw, ns)
    t_max = (bucket - win_length) // hop_length + 1
    if t_cap is not None:
        t_max = min(t_max, t_cap)
    t_blocks = t_max + t_overlap - 1
    blocks = padded[:, : t_blocks * hop_length].reshape(c, t_blocks, hop_length)
    frames = jnp.concatenate(
        [blocks[:, i : i + t_max] for i in range(t_overlap)], axis=2
    )
    if shardings is not None and shardings.frames is not None:
        # sequence parallelism: frames are mutually independent GEMM rows,
        # so sharding T costs only the framing halo at shard edges and an
        # exactly-associative min/max tree — BIT-EXACT vs single device.
        # This is the load-balancing axis when rows < devices (one long
        # stereo track = 2 rows).
        frames = jax.lax.with_sharding_constraint(frames, shardings.frames)
    mag = _dft_magnitude(frames, cw, sw, rfft_n_fft)
    if use_mel:
        out = jnp.einsum("ctf,fm->ctm", mag, mel_fb, precision=_matmul_precision())
    else:
        out = mag
    db = 20.0 * jnp.where(out > 0, jnp.log10(jnp.where(out > 0, out, 1.0)), -jnp.inf)
    if shardings is not None:
        db = jax.lax.with_sharding_constraint(db, shardings.rows3)
    n_frames = (ns + 2 * pad - win_length) // hop_length + 1
    mask = jnp.arange(t_max, dtype=jnp.int32)[None, :, None] < n_frames[:, None, None]
    row_min = jnp.min(jnp.where(mask, db, jnp.inf), axis=(1, 2))
    row_max = jnp.max(jnp.where(mask, db, -jnp.inf), axis=(1, 2))
    return db, row_min, row_max


@functools.partial(jax.jit, static_argnames=("specs",))
def _spec_groups(arrays, *, specs):
    """Fused multi-group recompute: EVERY (sr, win, n_fft, bucket) group in
    ONE device program, ONE dispatch.

    A mixed-sample-rate recompute then pays one host dispatch and no
    intermediate sync points however many groups it has.  Groups are
    mutually independent, so XLA can also overlap their compute.

    arrays: tuple of (raw, ns, gains, cw, sw, mel_fb) pytrees, one per group;
    specs:  matching tuple of (hop_length, t_overlap, use_mel, bucket, pad,
            t_cap, rfft_n_fft, shardings) static tuples.  Compilation is keyed on the
    combination of group shapes/params ONLY — per-track row extents stay
    out of the key so adding a track that fits the same pow2 row bucket
    reuses the executable (compile stability is a feature)."""
    return tuple(
        _spec_multi_impl(
            raw, ns, gains, cw, sw, mel, hop_length=h, t_overlap=t, use_mel=m,
            bucket=b, pad=p, shardings=sh, t_cap=tc, rfft_n_fft=rn,
        )
        for (raw, ns, gains, cw, sw, mel), (h, t, m, b, p, tc, rn, sh) in zip(
            arrays, specs
        )
    )


class _HostOnce:
    """Lazy one-time device->host fetch shared by a batch group: the
    per-track bound lookups then cost host slicing, not extra device
    launches and transfers.  The device
    array is kept (it is a few floats) so the device-side global-range
    program can consume it without re-uploading."""

    __slots__ = ("dev", "_host")

    def __init__(self, dev):
        self.dev = dev
        self._host = None

    def get(self) -> np.ndarray:
        if self._host is None:
            self._host = np.asarray(self.dev)
        return self._host


class SpecResult:
    """Device-resident spectrogram with lazily-fetched bounds.

    Bounds are either scalars (single-track path) or lazy
    (_HostOnce row_min/row_max, row span) tuples from a batched group."""

    __slots__ = ("db_padded", "n_frames", "n_freq", "_min", "_max", "_span")

    def __init__(self, db_padded, n_frames: int, min_db, max_db, span=None):
        self.db_padded = db_padded
        self.n_frames = n_frames
        self.n_freq = db_padded.shape[-1]
        self._min = min_db
        self._max = max_db
        self._span = span

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_frames, self.n_freq)

    def min_max_db(self) -> tuple[float, float]:
        if self._span is not None:
            r0, c = self._span
            return (
                float(self._min.get()[r0 : r0 + c].min()),
                float(self._max.get()[r0 : r0 + c].max()),
            )
        return float(self._min), float(self._max)

    def bounds_device(self):
        """((row_min, row_max) device arrays, (r0, c) static span) without
        forcing a host sync — feeds the device-side global-range program."""
        if self._span is not None:
            return (self._min.dev, self._max.dev), self._span
        mn = self._min if hasattr(self._min, "shape") else jnp.float32(self._min)
        mx = self._max if hasattr(self._max, "shape") else jnp.float32(self._max)
        return (jnp.reshape(mn, (1,)), jnp.reshape(mx, (1,))), (0, 1)

    def to_numpy(self) -> np.ndarray:
        """(n_frames, F) host array (single bulk transfer, sliced on host)."""
        arr = np.asarray(self.db_padded)[0 if self.db_padded.ndim == 3 else ...]
        return arr[: self.n_frames]  # rows past n_frames are garbage frames

    def channel_numpy(self, ch: int) -> np.ndarray:
        return np.asarray(self.db_padded[ch])[: self.n_frames]


class SpectrogramAnalyzer:
    """Caches device constants, compiled pipelines, and device-resident
    waveforms.  reference lifecycle: spectrogram.rs:101-185."""

    def __init__(self):
        from ..runtime import configure_jax_cache

        configure_jax_cache()
        self._dft: dict[tuple[int, int], tuple[jax.Array, jax.Array]] = {}
        self._mel_fbs: dict[tuple[int, int], jax.Array] = {}
        # device wav uploads, LRU-evicted under a byte budget so long
        # sessions with many tracks can't exhaust the device (dict preserves
        # insertion order; hits re-insert)
        self._wav_cache: dict[object, tuple[jax.Array, int, object]] = {}
        self._wav_cache_budget = int(
            os.environ.get("THESIA_WAV_CACHE_BYTES", 4 * 1024**3)
        )
        # assembled (c_bucket, bucket) device row stacks for batched groups
        self._group_cache: dict[tuple, tuple[jax.Array, jax.Array]] = {}
        self._empty_mel: jax.Array | None = None  # cached Linear-mode dummy

    # -- lifecycle ---------------------------------------------------------
    def prepare(self, params, freq_scale: FreqScale) -> None:
        for p in params:
            self._spec_operands(p.win_length, p.n_fft)
        if freq_scale is FreqScale.Mel:
            for p in params:
                self.mel_fb(p.sr, p.n_fft)
        else:
            self._mel_fbs.clear()

    def retain(self, params, freq_scale: FreqScale) -> None:
        keep_wn = {(p.win_length, p.n_fft) for p in params}
        keep_sn = {(p.sr, p.n_fft) for p in params}
        self._dft = {k: v for k, v in self._dft.items() if k in keep_wn}
        if freq_scale is FreqScale.Mel:
            self._mel_fbs = {k: v for k, v in self._mel_fbs.items() if k in keep_sn}
        else:
            self._mel_fbs.clear()

    def drop_wav(self, cache_key) -> None:
        self._wav_cache.pop(cache_key, None)
        self._group_cache = {
            sig: v
            for sig, v in self._group_cache.items()
            if all(k != cache_key for k, _t, _n in sig[3])
        }

    def clear_wav_cache(self) -> None:
        self._wav_cache.clear()
        self._group_cache.clear()

    def _empty_fb(self) -> jax.Array:
        """Cached (1, 1) dummy filterbank for Linear mode (one upload, not
        one per recompute)."""
        if self._empty_mel is None:
            self._empty_mel = jnp.zeros((1, 1), jnp.float32)
        return self._empty_mel

    def mel_fb(self, sr: int, n_fft: int) -> jax.Array:
        key = (sr, n_fft)
        if key not in self._mel_fbs:
            self._mel_fbs[key] = jnp.asarray(calc_mel_fb_default(sr, n_fft))
        return self._mel_fbs[key]

    def _dft_mats(self, win_length: int, n_fft: int):
        key = (win_length, n_fft)
        if key not in self._dft or self._dft[key][0].ndim != 2:
            window = calc_normalized_win(WindowType.Hann, win_length, n_fft)
            n_pad_left = (n_fft - win_length) // 2
            cw, sw = make_dft_matrices(window, n_fft, n_pad_left)
            self._dft[key] = (jnp.asarray(cw), jnp.asarray(sw))
        return self._dft[key]

    def _spec_operands(self, win_length: int, n_fft: int):
        """(cw, sw, rfft_n_fft) for the fused programs: the window-folded
        DFT GEMM matrices by default, or — when those matrices would exceed
        THESIA_DFT_MAT_MAX_BYTES (huge window x high sample rate) — the bare
        window vector twice (sw unused) with the rfft flag set.  Every
        engine compute/warm path must route through here so the warmer
        compiles the exact program the dispatch will run."""
        if not use_rfft_for(win_length, n_fft):
            cw, sw = self._dft_mats(win_length, n_fft)
            return cw, sw, None
        key = (win_length, n_fft)
        if key not in self._dft or self._dft[key][0].ndim != 1:
            window = calc_normalized_win(WindowType.Hann, win_length, n_fft)
            w = jnp.asarray(window.astype(np.float32))
            self._dft[key] = (w, w)
        cw, sw = self._dft[key]
        return cw, sw, n_fft

    def _device_wav(self, wavs: np.ndarray, cache_key, token=None) -> tuple[jax.Array, int]:
        """(C, bucket) device array + valid length; uploaded once per
        (cache_key, token) — the token (Audio.version) invalidates the cached
        upload when the track's samples change.  A None token means the
        caller can't vouch for sample identity, so it NEVER cache-hits
        (returning another upload's samples for a reused key would be
        silently wrong)."""
        if cache_key is not None and token is not None:
            hit = self._wav_cache.get(cache_key)
            if hit is not None and hit[2] == token:
                # refresh LRU recency
                self._wav_cache.pop(cache_key)
                self._wav_cache[cache_key] = hit
                return hit[0], hit[1]
        from ..obs import span

        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        n = wavs.shape[-1]
        bucket = wav_size_bucket(n)
        with span("spec.h2d_upload"):
            ints = _as_s16_grid(wavs)
            if ints is not None:
                dev = _s16_to_f32(self._upload_padded(ints, n, bucket))
            else:
                dev = self._upload_padded(wavs, n, bucket)
            dev.block_until_ready()
        if cache_key is not None and token is not None:
            self._wav_cache[cache_key] = (dev, n, token)
            self._evict_wav_cache()
        return dev, n

    def _upload_padded(self, wavs: np.ndarray, n: int, bucket: int) -> jax.Array:
        """(C, n) host samples -> (C, bucket) zero-padded device array.

        Big uploads are split into _WAV_BUCKET_BIG_STEP-sample column
        blocks: every device_put is issued up front so the transfers
        pipeline, then the blocks fold into a zeroed (C, bucket) buffer with
        DONATED dynamic_update_slice dispatches (in place on device; a
        device-side concatenate needs 2x the transient device memory).
        Offsets are dynamic scalars, multiples of the step, and every big
        bucket is a multiple of the step, so off + chunk <= bucket always
        holds (dynamic_update_slice clamps silently otherwise) and one
        executable serves every track per (C, bucket, dtype).  The result
        is bit-identical to a single put.  Whether chunking still pays on a
        local PCIe link is not measured yet."""
        C = wavs.shape[0]
        chunk = _WAV_BUCKET_BIG_STEP
        if bucket < chunk or bucket % chunk:
            buf = np.zeros((C, bucket), wavs.dtype)
            buf[:, :n] = wavs
            return jnp.asarray(buf)
        parts = []
        for off in range(0, n, chunk):
            end = min(off + chunk, n)
            if end - off == chunk:
                block = np.ascontiguousarray(wavs[:, off:end])
            else:
                block = np.zeros((C, chunk), wavs.dtype)
                block[:, : end - off] = wavs[:, off:end]
            parts.append((off, jax.device_put(block)))
        buf = jnp.zeros((C, bucket), wavs.dtype)
        for off, part in parts:
            buf = _fold_chunk(buf, part, np.int32(off))
        return buf

    _PREFETCH_MIN_BYTES = 64 << 20

    def upload_interleaved_pcm(self, payload, n_ch: int, fmt: str):
        """Prefetch path for big PCM WAVs (fmt in {"s16", "s24", "f32"}):
        upload the file's interleaved payload AS-IS (zero host decode work;
        s16 is half the f32 bytes, s24 three quarters) and deinterleave +
        convert on device.  Run on a background thread concurrently with the
        host decode/stats pass; the result slots into the wav cache via
        adopt_wav once the decoded track vouches for the bytes.

        Returns (dev (C, bucket) f32, n, probe) where probe holds strided
        expected f32 samples for post-decode verification, or None when the
        payload is too small / the format is unsupported."""
        if n_ch <= 0 or len(payload) < self._PREFETCH_MIN_BYTES:
            return None
        if fmt == "s16":
            flat = np.frombuffer(payload, "<i2")
            n = flat.size // n_ch
            flat = flat[: n * n_ch]
            bucket = wav_size_bucket(n)
            dev_flat = self._upload_padded(flat.reshape(1, -1), n * n_ch, bucket * n_ch)
            dev = _deinterleave_flat(dev_flat, c=n_ch, bucket=bucket)
            probe_idx = np.arange(0, n * n_ch, 4097)
            expected = flat[probe_idx].astype(np.float32) * np.float32(1.0 / 32768.0)
        elif fmt == "f32":
            flat = np.frombuffer(payload, "<f4")
            n = flat.size // n_ch
            flat = flat[: n * n_ch]
            bucket = wav_size_bucket(n)
            dev_flat = self._upload_padded(flat.reshape(1, -1), n * n_ch, bucket * n_ch)
            dev = _deinterleave_flat(dev_flat, c=n_ch, bucket=bucket)
            probe_idx = np.arange(0, n * n_ch, 4097)
            expected = flat[probe_idx].astype(np.float32)
        elif fmt == "s24":
            raw = np.frombuffer(payload, np.uint8)
            n = raw.size // (3 * n_ch)
            raw = raw[: n * 3 * n_ch]
            bucket = wav_size_bucket(n)
            dev_flat = self._upload_padded(
                raw.reshape(1, -1), n * 3 * n_ch, bucket * 3 * n_ch
            )
            dev = _deinterleave_s24(dev_flat, c=n_ch, bucket=bucket)
            from ..io.wav import s24_bytes_to_f32

            probe_idx = np.arange(0, n * n_ch, 4097)
            expected = s24_bytes_to_f32(
                raw.reshape(-1, 3)[probe_idx].reshape(-1)
            )
        else:
            return None
        return dev, n, (probe_idx, expected)

    @staticmethod
    def prefetch_matches(probe, wavs: np.ndarray) -> bool:
        """Did the decoded planar f32 come from the same bytes the prefetch
        uploaded?  (Guards against the file changing between the two
        reads.)  probe positions are flat interleaved SAMPLE indices."""
        probe_idx, expected = probe
        c = wavs.shape[0]
        got = wavs[probe_idx % c, probe_idx // c]
        return bool((got == expected).all())

    def adopt_wav(self, cache_key, dev: jax.Array, n: int, token) -> None:
        """Install a prefetched upload into the device wav cache."""
        if cache_key is None or token is None:
            return
        self._wav_cache.pop(cache_key, None)
        self._wav_cache[cache_key] = (dev, n, token)
        self._evict_wav_cache()

    def _evict_wav_cache(self) -> None:
        """Keep wav uploads + assembled group stacks within the device budget.
        Group stacks go first (cheap to rebuild from cached wavs on device);
        per-track uploads after, oldest first.  Single-member group stacks
        ALIAS the wav-cache buffer (same device array) — count each buffer
        once or the budget overstates usage and evicts needlessly."""
        wav_ids = {id(v[0]) for v in self._wav_cache.values()}
        wav_total = sum(v[0].size * 4 for v in self._wav_cache.values())
        group_total = sum(
            v[0].size * 4
            for v in self._group_cache.values()
            if id(v[0]) not in wav_ids
        )
        while (
            wav_total + group_total > self._wav_cache_budget and self._group_cache
        ):
            _sig, (buf, _ns) = next(iter(self._group_cache.items()))
            self._group_cache.pop(_sig)
            if id(buf) not in wav_ids:
                group_total -= buf.size * 4
        while wav_total + group_total > self._wav_cache_budget and len(self._wav_cache) > 1:
            _key, (dev, _n, _t) = next(iter(self._wav_cache.items()))
            self._wav_cache.pop(_key)
            wav_total -= dev.size * 4

    # -- compute -----------------------------------------------------------
    def calc_spec_multi(
        self, wavs: np.ndarray, sr: int, setting: SpecSetting, cache_key=None,
        token=None, gain: float = 1.0
    ) -> SpecResult:
        """All channels at once: (C, n) -> SpecResult with (C, T_max, F).

        gain: scalar applied ON DEVICE (bit-identical to the host f32
        multiply) — callers pass the ORIGINAL samples with a stable token so
        gain changes never re-upload (see AudioTrack.device_scalar_gain)."""
        hop, win, n_fft = setting.calc_framing_params(sr)
        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        n = wavs.shape[-1]
        pad = win // 2
        n_frames = stft_frame_count(n, win, hop)
        use_mel = setting.freq_scale is FreqScale.Mel
        cw, sw, rfft_n_fft = self._spec_operands(win, n_fft)
        mel = self.mel_fb(sr, n_fft) if use_mel else self._empty_fb()

        if n <= pad + 1 or n < win:
            # short-track path: host reflect-pad (cyclic) + same device math
            if gain != 1.0:
                wavs = (np.float32(gain) * wavs).astype(np.float32)
            return self._calc_short(
                wavs, hop, win, pad, cw, sw, mel, use_mel, n_frames, rfft_n_fft
            )

        raw_dev, n_dev = self._device_wav(wavs, cache_key, token)
        bucket = raw_dev.shape[-1]
        # padded signal needs room: pad + n + pad <= bucket.  The cached
        # upload is zero past n, so zero-extending ON DEVICE is bit-exact
        # and costs no transfer (re-uploading here would also bypass the
        # int16 fast path and clobber the cache token — review finding).
        if pad + n_dev + pad > bucket:
            bucket2 = wav_size_bucket(n_dev + 2 * pad)
            raw_dev = jnp.pad(raw_dev, ((0, 0), (0, bucket2 - bucket)))
            if cache_key is not None and token is not None:
                self._wav_cache[cache_key] = (raw_dev, n_dev, token)
                self._evict_wav_cache()
            bucket = bucket2
        db, mn, mx = _spec_full(
            raw_dev,
            jnp.int32(n_dev),
            jnp.float32(gain),
            cw,
            sw,
            mel,
            hop_length=hop,
            t_overlap=win // hop,
            use_mel=use_mel,
            bucket=bucket,
            pad=pad,
            t_cap=frame_cap(n_frames),
            rfft_n_fft=rfft_n_fft,
        )
        return SpecResult(db, n_frames, mn, mx)

    def _calc_short(self, wavs, hop, win, pad, cw, sw, mel, use_mel, n_frames,
                    rfft_n_fft=None):
        padded = reflect_pad_1d(wavs, pad, pad)
        t_overlap = win // hop
        need = (max(n_frames - 1, 0)) * hop + win
        if padded.shape[-1] < need:
            padded = np.pad(padded, ((0, 0), (0, need - padded.shape[-1])))
        frames = np.stack(
            [padded[:, t * hop : t * hop + win] for t in range(max(n_frames, 1))], axis=1
        ).astype(np.float32)
        mag = _dft_magnitude(jnp.asarray(frames), cw, sw, rfft_n_fft)
        out = (
            jnp.einsum("ctf,fm->ctm", mag, mel, precision=_matmul_precision())
            if use_mel
            else mag
        )
        db = 20.0 * jnp.where(out > 0, jnp.log10(jnp.where(out > 0, out, 1.0)), -jnp.inf)
        return SpecResult(db, n_frames, jnp.min(db), jnp.max(db))

    def calc_spec(self, wav: np.ndarray, sr: int, setting: SpecSetting, cache_key=None):
        """Single-channel compatibility wrapper -> (n_frames, F) device array."""
        res = self.calc_spec_multi(np.atleast_2d(wav), sr, setting, cache_key)
        return res.db_padded[0, : res.n_frames]

    def _group_buffer(self, bucket: int, c_bucket: int, members, win: int):
        """Device (c_bucket, bucket) row stack + host ns for a batched group.

        Assembled from the per-track device wav cache (h2d happens once per
        track, ever); the assembled stack itself is cached keyed by the
        member signature so settings-change recomputes touching the same
        tracks do zero transfer AND zero re-assembly (VERDICT r1 item 7).
        Members with a None token (unverifiable sample identity) disable the
        group cache for this call.
        """
        cacheable = all(t is not None for _k, _w, _n, t in members)
        # safe n for dummy rows' reflect slices depends on win -> key on it
        sig = (bucket, c_bucket, win, tuple((k, t, n) for k, _w, n, t in members))
        hit = self._group_cache.get(sig) if cacheable else None
        safe_n = max(win + 2, 2 * (win // 2) + 2)
        if hit is not None:
            # refresh LRU recency (eviction pops oldest-inserted first)
            self._group_cache.pop(sig)
            self._group_cache[sig] = hit
            return hit[0], hit[1], sig
        row_parts = []
        ns = np.zeros(c_bucket, np.int32)
        r = 0
        for key, wavs, n, token in members:
            dev, _n_dev = self._device_wav(wavs, key, token)
            if dev.shape[1] < bucket:
                dev = jnp.pad(dev, ((0, 0), (0, bucket - dev.shape[1])))
            elif dev.shape[1] > bucket:
                # over-sized cached upload (re-bucketed for a larger pad):
                # data past n is zero, safe to crop
                dev = dev[:, :bucket]
            row_parts.append(dev)
            c = wavs.shape[0]
            ns[r : r + c] = n
            r += c
        if r < c_bucket:
            row_parts.append(jnp.zeros((c_bucket - r, bucket), jnp.float32))
        buf_dev = row_parts[0] if len(row_parts) == 1 else jnp.concatenate(row_parts, axis=0)
        ns[r:] = safe_n
        ns_dev = jnp.asarray(ns)  # device-resident: recomputes re-upload nothing
        if cacheable:
            self._group_cache[sig] = (buf_dev, ns_dev)
            while len(self._group_cache) > 8:
                self._group_cache.pop(next(iter(self._group_cache)))
            self._evict_wav_cache()  # group stacks count against the budget
        return buf_dev, ns_dev, sig

    def calc_specs_batched(
        self, items, setting: SpecSetting
    ) -> dict[object, SpecResult]:
        """Multi-track batched recompute: items = [(key, wavs (C,n), sr)],
        [(key, wavs, sr, token)], or [(key, wavs, sr, token, gain)] — token
        invalidates the device wav cache; gain is applied on device per row
        (pass ORIGINAL samples + original-version token so gain changes hit
        both the wav cache and the assembled group stacks).

        Tracks sharing a (sr, win, n_fft) parameter set AND wav size bucket
        are stacked into ONE device program (row batch padded to a power of
        two so batch sizes reuse executables).  When a multi-device mesh is
        active (parallel.sharding.set_active_mesh) the row batch additionally
        pads to a multiple of the mesh "tracks" axis and the whole program is
        sharded over it — the device analogue of the reference's rayon
        per-(id,ch) loop (src-tauri/src/core/mod.rs:152-163).  Short tracks
        fall back to the per-track path.  Returns {key: SpecResult}.
        """
        from ..parallel.sharding import active_spec_sharding, pad_rows_for

        shardings = active_spec_sharding()
        results: dict[object, SpecResult] = {}
        groups: dict[tuple, list] = {}
        for item in items:
            key, wavs, sr = item[0], item[1], item[2]
            token = item[3] if len(item) > 3 else None
            gain = float(item[4]) if len(item) > 4 else 1.0
            wavs = np.atleast_2d(np.asarray(wavs, np.float32))
            hop, win, n_fft = setting.calc_framing_params(sr)
            pad = win // 2
            n = wavs.shape[-1]
            if n <= pad + 1 or n < win:
                results[key] = self.calc_spec_multi(wavs, sr, setting, gain=gain)
                continue
            bucket = wav_size_bucket(n + 2 * pad)
            groups.setdefault((sr, hop, win, n_fft, bucket), []).append(
                (key, wavs, n, token, gain)
            )

        use_mel = setting.freq_scale is FreqScale.Mel
        prepared = []  # (spans, (hop, win), arrays, statics)
        for (sr, hop, win, n_fft, bucket), members in groups.items():
            cw, sw, rfft_n_fft = self._spec_operands(win, n_fft)
            mel = self.mel_fb(sr, n_fft) if use_mel else self._empty_fb()
            rows = sum(w.shape[0] for _, w, _n, _t, _g in members)
            c_bucket = pad_rows_for(shardings, rows)
            buf_dev, ns_dev, _sig = self._group_buffer(
                bucket, c_bucket, [m[:4] for m in members], win
            )
            spans = []
            gains = np.ones(c_bucket, np.float32)
            r = 0
            for key, wavs, n, _token, gain in members:
                spans.append((key, r, wavs.shape[0], n))
                gains[r : r + wavs.shape[0]] = np.float32(gain)
                r += wavs.shape[0]
            t_cap = frame_cap(
                max(stft_frame_count(n, win, hop) for _k, _w, n, _t, _g in members)
            )
            prepared.append(
                (
                    spans,
                    (hop, win),
                    (buf_dev, ns_dev, jnp.asarray(gains), cw, sw, mel),
                    (hop, win // hop, use_mel, bucket, win // 2, t_cap, rfft_n_fft),
                )
            )
        if not prepared:
            return results
        # all groups in ONE device program, one host dispatch (see
        # _spec_groups docstring for the measured cost model)
        outs = _spec_groups(
            tuple(p[2] for p in prepared),
            specs=tuple(p[3] + (shardings,) for p in prepared),
        )
        for (spans, (hop, win), _arrays, _st), (db, row_min, row_max) in zip(
            prepared, outs
        ):
            # bounds stay lazy: ONE d2h per group on first use, host slicing
            # per track; db row slices are lazy device views used by the
            # quantize pass
            mins = _HostOnce(row_min)
            maxs = _HostOnce(row_max)
            for key, r0, c, n in spans:
                n_frames = stft_frame_count(n, win, hop)
                results[key] = SpecResult(
                    db[r0 : r0 + c], n_frames, mins, maxs, span=(r0, c)
                )
        return results
