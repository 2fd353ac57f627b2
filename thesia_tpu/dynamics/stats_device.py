"""Batched ON-DEVICE dynamics: limiter gain scan + LUFS + basic stats.

Parallel-scan formulations of the two sequential per-sample recurrences the
reference runs as streaming CPU loops:

  * limiter gain chain (reference: src-tauri/src/core/dynamics/limiter.rs:45-172):
    cross-channel |max| -> raw gain -> sliding-min peak hold (van Herk
    blockwise cummin — two strided cummins, zero gathers) -> exponential
    release as a `jax.lax.associative_scan` over (A, B, C) closure triples of
    y' = min(c, a*y + b) -> box-stack smoother as cumsum moving averages ->
    min(., 1); `attack` latency compensated by reading gains shifted by
    `attack` against the zero-padded tail (limiter.rs:110-135 semantics).

  * LUFS K-weighting biquads (reference: src-tauri/src/core/dynamics/stats.rs:44-86
    via the ebur128 crate): each biquad's DF2T state recurrence
    s_t = A s_{t-1} + c*x_t (constant 2x2 A) solved with a Hillis-Steele
    doubling scan using precomputed A^(2^k) powers — log2(n) tensor ops, no
    sequential loop; then 400 ms / 100 ms gating blocks from a cumsum with
    strided slices and masked gated means (matches dynamics/loudness.py and
    the -26.2033... golden to ~1e-10).

Everything runs in f64 inside a scoped `jax.enable_x64()` so engine-wide
dtype semantics are untouched.  The engine takes these paths only where
`device_dynamics_preferred()` says so; elsewhere it runs the host/native
streaming implementations.

Rows are batched (padded to power-of-two buckets, grouped per sample rate)
so a guard-mode recompute of N tracks is ONE device program per (sr, bucket)
group — the VERDICT r1 item 6 deliverable.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .envelope import optimal_ratios, stack_layer_lengths
from .loudness import (
    _RELATIVE_GATE_FACTOR,
    _SURROUND_WEIGHT,
    HIST_BOUNDARIES,
    HIST_ENERGIES,
    k_weighting_coeffs,
)

_F64_EPS = float(np.finfo(np.float64).eps)
_f64_ok: bool | None = None


# The GPU is not listed: there the engine keeps the native streaming paths.
# Measured by chip_smoke.py on a one-hour 48 kHz stereo track (NVIDIA H100
# 80GB HBM3, 700 W power limit): the device limiter takes 2.35 s warm
# (upload, f64 program, f64 gain download; 11-14 s on a cold compile cache)
# against 3.27 s native and holds 18 GiB of device memory; the device LUFS
# program asks for 73 GiB on that track, more than a process gets, and on
# its first 15 minutes takes 0.63 s warm against 0.47 s native.
_DEVICE_DYNAMICS_BACKENDS = ("cpu",)


def device_dynamics_preferred() -> bool:
    """Policy gate the engine checks before taking the batched device paths
    (engine/track.py); the functions below compute unconditionally.

    Auto (THESIA_DEVICE_DYNAMICS unset): the backends in
    _DEVICE_DYNAMICS_BACKENDS, and only where f64 runs.  Set
    THESIA_DEVICE_DYNAMICS=1/0 to force/disable.
    """
    import os

    env = os.environ.get("THESIA_DEVICE_DYNAMICS")
    if env is not None:
        return env.lower() not in ("0", "false", "")
    return jax.default_backend() in _DEVICE_DYNAMICS_BACKENDS and device_dynamics_ok()


def device_dynamics_ok() -> bool:
    """True when the default backend executes f64 programs exactly (probed
    once).  An error from the probe propagates instead of switching the
    device paths off silently."""
    global _f64_ok
    if _f64_ok is None:
        with jax.enable_x64():
            x = jnp.cumsum(jnp.asarray(np.array([1.0, 2.0 ** -40], np.float64)))
            _f64_ok = bool(x.dtype == jnp.float64 and float(x[-1]) == 1.0 + 2.0 ** -40)
    return _f64_ok


def _bucket(n: int, base: int = 1 << 12) -> int:
    b = base
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# limiter building blocks (traced in x64 context; all causal)


def _sliding_min(x, window: int):
    """out[t] = min(x[t-window+1 .. t]) with +inf pre-history; (B, n) f64.

    van Herk-Gil-Werman blockwise: two cummins over (nb, window) blocks,
    combined with plain slices (no gather)."""
    if window <= 1:
        return x
    b, n = x.shape
    pad_front = window - 1
    n_tot = pad_front + n
    n_blocks = -(-n_tot // window)
    pad_back = n_blocks * window - n_tot
    xp = jnp.concatenate(
        [
            jnp.full((b, pad_front), jnp.inf, x.dtype),
            x,
            jnp.full((b, pad_back), jnp.inf, x.dtype),
        ],
        axis=1,
    ).reshape(b, n_blocks, window)
    fwd = jax.lax.cummin(xp, axis=2).reshape(b, -1)
    bwd = jnp.flip(jax.lax.cummin(jnp.flip(xp, 2), axis=2), 2).reshape(b, -1)
    # window ending at padded index j = pad_front + t starts at i = t
    return jnp.minimum(bwd[:, :n], fwd[:, pad_front : pad_front + n])


def _release_scan(x, slew):
    """y_t = min(x_t, y_{t-1} + (x_t - y_{t-1})*slew), y_{-1} = 1; (B, n).

    Step t is f_t(y) = min(c_t, a*y + b_t); composition closes over
    (A, B, C) triples (limiter.py exponential_release_scan, on device)."""
    a = 1.0 - slew
    A = jnp.full(x.shape, a, x.dtype)
    B = slew * x
    C = x

    def combine(l, r):
        A1, B1, C1 = l
        A2, B2, C2 = r
        return (A2 * A1, A2 * B1 + B2, jnp.minimum(C2, A2 * C1 + B2))

    A, B, C = jax.lax.associative_scan(combine, (A, B, C), axis=1)
    return jnp.minimum(C, A * 1.0 + B)


_BOX_BLOCK = 1 << 12


def _box_filter(x, length: int, fill: float):
    """Moving average of the trailing `length` samples, pre-history = fill.

    Window sums are cumsum differences taken within blocks of _BOX_BLOCK
    outputs (each block carries its length-1 halo), not along the whole
    row: a whole-row cumsum grows to ~n, and its differences lose ~n * eps
    of absolute precision (2e-9 of gain on a one-hour 48 kHz track)."""
    if length <= 1:
        return x
    b, n = x.shape
    blk = max(_BOX_BLOCK, length)  # the halo fits in the next block
    nb = -(-n // blk)
    xe = jnp.concatenate(
        [
            jnp.full((b, length - 1), fill, x.dtype),
            x,
            jnp.zeros((b, (nb + 1) * blk - (length - 1) - n), x.dtype),
        ],
        axis=1,
    ).reshape(b, nb + 1, blk)
    chunks = jnp.concatenate([xe[:, :nb], xe[:, 1:, : length - 1]], axis=2)
    c = jnp.cumsum(chunks, axis=2)
    c = jnp.concatenate([jnp.zeros((b, nb, 1), x.dtype), c], axis=2)
    sums = c[:, :, length : length + blk] - c[:, :, :blk]
    return (sums / length).reshape(b, nb * blk)[:, :n]


@functools.partial(
    jax.jit, static_argnames=("attack", "hold_length", "box_lengths")
)
def _limiter_gain_kernel(wavs, threshold, slew, *, attack, hold_length, box_lengths):
    """wavs (B, C, bucket) f32 (zero-padded rows/channels) -> gain (B, bucket)
    f64, NOT yet latency-shifted (caller reads [attack : attack+n])."""
    a = jnp.abs(wavs.astype(jnp.float64))
    # ignore NaNs in the cross-channel max like the reference's f32::max
    # fold and the native comparison loop — a NaN channel must not disable
    # limiting of the finite channels (jnp.max would propagate the NaN)
    v = jnp.max(jnp.where(jnp.isnan(a), -jnp.inf, a), axis=1)
    raw = jnp.where(v > threshold, threshold / (v + _F64_EPS), 1.0)
    ph = _sliding_min(raw, max(hold_length, 1))
    sm = _release_scan(ph, slew)
    for l in box_lengths:
        sm = _box_filter(sm, l, 1.0)
    return jnp.minimum(sm, 1.0)


def limiter_gain_seqs_batched(
    items,
    threshold: float = 1.0,
    attack_ms: float = 5.0,
    hold_ms: float = 15.0,
    release_ms: float = 40.0,
) -> dict | None:
    """items: [(key, wavs (C, n) f32, sr)] -> {key: gain (n,) f64}.

    One device program per (sr, bucket) group.  Causality of every stage
    means zero-padded rows reproduce the reference's appended-zeros latency
    handling exactly."""
    groups: dict[tuple, list] = {}
    for key, wavs, sr in items:
        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        b = _bucket(wavs.shape[1] + int(np.floor(attack_ms * sr / 1000.0 + 0.5)) + 1)
        groups.setdefault((sr, b), []).append((key, wavs))
    out: dict = {}
    with jax.enable_x64():
        for (sr, bucket), members in groups.items():
            ms = lambda x: x * sr / 1000.0
            attack = int(np.floor(ms(attack_ms) + 0.5))
            hold_length = int(np.floor(ms(attack_ms + hold_ms) + 0.5))
            release_samples = ms(release_ms)
            slew = 1.0 / (release_samples + 1.0)
            if attack > 0:
                box_lengths = tuple(
                    max(l, 1) for l in stack_layer_lengths(attack, optimal_ratios(3))
                )
            else:
                box_lengths = ()
            c_max = max(w.shape[0] for _, w in members)
            buf = np.zeros((len(members), c_max, bucket), np.float32)
            for i, (_k, w) in enumerate(members):
                buf[i, : w.shape[0], : w.shape[1]] = w
            gain = _limiter_gain_kernel(
                jnp.asarray(buf),
                jnp.float64(threshold),
                jnp.float64(slew),
                attack=attack,
                hold_length=hold_length,
                box_lengths=box_lengths,
            )
            host = np.asarray(gain)
            for i, (key, w) in enumerate(members):
                # copy, not a view: per-track gain sequences outlive this
                # call (guard-clip stats keep them) and a view would pin the
                # whole padded (B, bucket) f64 batch in memory
                out[key] = host[i, attack : attack + w.shape[1]].copy()
    return out


# ---------------------------------------------------------------------------
# LUFS / stats


def _biquad_scan(x, A, c, b0):
    """DF2T biquad via constant-matrix doubling scan.

    x (B, n) f64; A (2,2), c (2,), b0 scalar.  State recurrence
    s_t = A s_{t-1} + c*x_t; output y_t = b0*x_t + s_{t-1}[0]."""
    v = x[..., None] * c  # (B, n, 2)
    n = x.shape[1]
    Ak = A
    shift = 1
    while shift < n:
        v = v.at[:, shift:].add(jnp.einsum("ij,bnj->bni", Ak, v[:, :-shift]))
        Ak = Ak @ Ak
        shift *= 2
    z1_prev = jnp.concatenate([jnp.zeros((x.shape[0], 1), x.dtype), v[:, :-1, 0]], axis=1)
    return b0 * x + z1_prev


def _affine_from_biquad(b, a):
    """(A, c, b0) of s_t = A s_{t-1} + c x_t for a normalized biquad."""
    b0, b1, b2 = b
    a1, a2 = a[1], a[2]
    A = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
    c = np.array([b1 - a1 * b0, b2 - a2 * b0], np.float64)
    return A, c, b0


@functools.partial(jax.jit, static_argnames=("s100", "win", "n_blocks_max"))
def _lufs_kernel(wavs, ns, A1, c1, b01, A2, c2, b02, weights, *, s100, win, n_blocks_max):
    """wavs (B, C, bucket) f32, ns (B,) valid lengths -> per-row
    (lufs (B,), sum_sq (B,), peak (B,)) f64.

    Gating: 400 ms blocks stepped 100 ms; blocks binned into ebur128's
    0.1-LU histogram (bin-center energies), -70 LUFS absolute gate = the
    histogram floor, -10 LU relative gate over bin centers, energy-averaged
    (loudness.py histogram-mode semantics on device)."""
    x = wavs.astype(jnp.float64)
    b, c, bucket = x.shape
    flat = x.reshape(b * c, bucket)
    y = _biquad_scan(flat, A1, c1, b01)
    y = _biquad_scan(y, A2, c2, b02)
    sq = (y * y).reshape(b, c, bucket)
    csum = jnp.concatenate([jnp.zeros((b, c, 1), sq.dtype), jnp.cumsum(sq, axis=2)], axis=2)
    hi = csum[:, :, win::s100][:, :, :n_blocks_max]
    lo = csum[:, :, 0::s100][:, :, :n_blocks_max]
    block_sums = hi - lo  # (B, C, n_blocks_max)
    z = jnp.einsum("c,bct->bt", weights, block_sums) / win
    n_blocks = jnp.maximum((ns - win) // s100 + 1, 0)
    valid = jnp.arange(n_blocks_max)[None, :] < n_blocks[:, None]
    boundaries = jnp.asarray(HIST_BOUNDARIES)
    idx = jnp.clip(jnp.searchsorted(boundaries, z, side="right") - 1, 0, 999)
    zq = jnp.asarray(HIST_ENERGIES)[idx]  # bin-center energies
    m_abs = valid & (z >= boundaries[0])
    cnt_abs = m_abs.sum(axis=1)
    mean_abs = jnp.where(m_abs, zq, 0.0).sum(axis=1) / jnp.maximum(cnt_abs, 1)
    rel_thresh = mean_abs * _RELATIVE_GATE_FACTOR
    m_rel = m_abs & (zq > rel_thresh[:, None])
    cnt_rel = m_rel.sum(axis=1)
    mean_rel = jnp.where(m_rel, zq, 0.0).sum(axis=1) / jnp.maximum(cnt_rel, 1)
    lufs = jnp.where(
        cnt_rel > 0, -0.691 + 10.0 * jnp.log10(jnp.maximum(mean_rel, 1e-300)), -jnp.inf
    )
    # masked basic stats on the raw samples (stats.rs:56-86 semantics)
    mask = (jnp.arange(bucket)[None, None, :] < ns[:, None, None])
    xm = jnp.where(mask, x, 0.0)
    sum_sq = jnp.sum(xm * xm, axis=(1, 2))
    peak = jnp.max(jnp.abs(xm), axis=(1, 2))
    return lufs, sum_sq, peak


def lufs_stats_batched(items) -> dict | None:
    """items: [(key, wavs (C, n) f32, sr)] -> {key: (lufs, sum_sq, peak)}.

    One device program per (sr, n_ch, bucket) group; None when a sample
    rate is too low for 100 ms gating steps."""
    groups: dict[tuple, list] = {}
    for key, wavs, sr in items:
        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        s100 = (sr + 5) // 10
        if s100 == 0:
            return None
        groups.setdefault((sr, wavs.shape[0], _bucket(wavs.shape[1])), []).append(
            (key, wavs)
        )
    out: dict = {}
    with jax.enable_x64():
        for (sr, n_ch, bucket), members in groups.items():
            s100 = (sr + 5) // 10
            win = 4 * s100
            n_blocks_max = max((bucket - win) // s100 + 1, 1)
            if bucket < win + 1:
                continue  # group shorter than one gating block: host path
                # (keys stay absent; callers fill per-key fallbacks)
            b1, a1, b2, a2 = k_weighting_coeffs(sr)
            A1, c1, b01 = _affine_from_biquad(b1, a1)
            A2, c2, b02 = _affine_from_biquad(b2, a2)
            weights = np.array(
                [_SURROUND_WEIGHT if ch >= 3 else 1.0 for ch in range(n_ch)], np.float64
            )
            buf = np.zeros((len(members), n_ch, bucket), np.float32)
            ns = np.zeros(len(members), np.int64)
            for i, (_k, w) in enumerate(members):
                buf[i, :, : w.shape[1]] = w
                ns[i] = w.shape[1]
            lufs, sum_sq, peak = _lufs_kernel(
                jnp.asarray(buf),
                jnp.asarray(ns),
                jnp.asarray(A1), jnp.asarray(c1), jnp.float64(b01),
                jnp.asarray(A2), jnp.asarray(c2), jnp.float64(b02),
                jnp.asarray(weights),
                s100=s100, win=win, n_blocks_max=n_blocks_max,
            )
            lufs, sum_sq, peak = np.asarray(lufs), np.asarray(sum_sq), np.asarray(peak)
            for i, (key, _w) in enumerate(members):
                out[key] = (float(lufs[i]), float(sum_sq[i]), float(peak[i]))
    return out


def calc_stats_batched(items) -> dict | None:
    """items: [(key, wavs (C, n) f32, sr)] -> {key: AudioStats}.  Matches
    dynamics.stats.calc_stats field-for-field (f32 roundings included,
    stats.rs:56-86).  Tracks too short for a gating block fall back to the
    host path individually."""
    from .stats import AudioStats, calc_stats
    from ..dsp.decibel import db_from_amp_scalar, db_from_power_scalar

    raw = lufs_stats_batched(items)
    if raw is None:
        return None
    out = {}
    for key, wavs, sr in items:
        wavs = np.atleast_2d(np.asarray(wavs, np.float32))
        if key not in raw:
            out[key] = calc_stats(wavs, sr)
            continue
        lufs, sum_sq, peak = raw[key]
        n_elem = wavs.size
        mean_squared = float(np.float32(sum_sq / n_elem)) if n_elem else 0.0
        out[key] = AudioStats(
            global_lufs=lufs,
            rms_db=float(np.float32(db_from_power_scalar(mean_squared))),
            max_peak=float(np.float32(peak)),
            max_peak_db=float(np.float32(db_from_amp_scalar(float(np.float32(peak))))),
        )
    return out


def integrated_lufs_device(wavs: np.ndarray, sr: int) -> float | None:
    """Single-track device LUFS (parity/testing helper).  Tracks shorter
    than one gating block are dropped by the batched grouping — return the
    host convention (-inf) instead of KeyError."""
    res = lufs_stats_batched([(0, wavs, sr)])
    if res is None:
        return None
    if 0 not in res:
        return float("-inf")  # too short for any 400 ms block
    return res[0][0]
