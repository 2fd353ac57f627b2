"""Benchmark: batched STFT+mel+dB+raster throughput and viewport tile latency.

Needs an NVIDIA GPU: with no GPU (and no explicit CPU pin) it prints an
error line and exits non-zero.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "platform": ..., "device_kind":
   ..., "device_count": N, "card": "<name>, <power limit>", ...extras}

Each stage runs in a worker thread under its own time budget and degrades
to null fields; a global watchdog emits whatever has been measured if the
whole run overruns.  Either way the line carries an "error" field and the
exit code is non-zero.

Test/fault knobs (all env):
  THESIA_BENCH_FAST=1            tiny signal durations (CI exercise)
  THESIA_BENCH_BACKEND=cpu       pin the CPU backend (test rehearsal only;
                                 its numbers are not device numbers)
  THESIA_BENCH_FAULT=name[:hang] inject a failure (raise) or a wedge (hang)
                                 into the named stage
  THESIA_BENCH_TOTAL_BUDGET      watchdog seconds for the whole run
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

_FAST = os.environ.get("THESIA_BENCH_FAST") == "1"


def _T(seconds: float) -> float:
    """Internal drain/settle timeout, shrunk in fast mode."""
    return 30.0 if _FAST else seconds


def _progress(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def synth_stereo(sr: int, seconds: float, seed: int = 0) -> np.ndarray:
    """Deterministic music-like stereo test signal (sample_48k.wav is
    LFS-missing from the snapshot)."""
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    sig = np.zeros((2, n), np.float32)
    for f, a in [(110, 0.2), (220, 0.15), (440, 0.1), (880, 0.07), (3520, 0.02)]:
        ph = rng.uniform(0, 2 * np.pi, 2)[:, None]
        vib = np.sin(2 * np.pi * 0.5 * t) * 0.01
        sig += (a * np.sin(2 * np.pi * f * (t + vib)[None, :] + ph)).astype(np.float32)
    sig += rng.normal(0, 0.01, (2, n)).astype(np.float32)
    env = (0.5 + 0.5 * np.sin(2 * np.pi * 0.25 * t)).astype(np.float32)
    return sig * env[None, :]


def bench_spec_throughput(seconds: float | None = None, reps: int | None = None):
    from thesia_tpu.dsp.framing import SpecSetting
    from thesia_tpu.dsp.spectrogram import SpectrogramAnalyzer
    from thesia_tpu.dsp.stft import stft_frame_count

    seconds = seconds if seconds is not None else (2.0 if _FAST else 60.0)
    reps = reps if reps is not None else (2 if _FAST else 3)
    sr = 48000
    _progress("synthesizing test signal")
    wavs = synth_stereo(sr, seconds)
    setting = SpecSetting()  # 40 ms, 4x overlap, mel
    _progress("device warmup + analyzer init")
    analyzer = SpectrogramAnalyzer()
    hop, win, n_fft = setting.calc_framing_params(sr)
    _progress("compiling fused pipeline")

    # warmup/compile (also uploads the track to the device wav cache — the
    # steady-state recompute path starts from device-resident samples, as
    # the reference's recompute starts from RAM-resident samples)
    res = analyzer.calc_spec_multi(wavs, sr, setting, cache_key="bench", token=0)
    res.db_padded.block_until_ready()

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = analyzer.calc_spec_multi(wavs, sr, setting, cache_key="bench", token=0)
        res.db_padded.block_until_ready()
        times.append(time.perf_counter() - t0)
    best = min(times)
    audio_seconds = seconds  # stereo track of `seconds` (both channels together)
    realtime_factor = audio_seconds / best
    n_frames = stft_frame_count(wavs.shape[1], win, hop)
    frames_per_sec = 2 * n_frames / best
    return realtime_factor, frames_per_sec, np.asarray(res.db_padded[0, :n_frames])


def bench_tile_latency(spec_db, reps: int | None = None):
    _progress("tile latency")
    from thesia_tpu.render import (
        RenderTileCache,
        default_colormap_rgba8,
        convert_spectrogram_to_img,
        encode_waveform_tile,
    )

    reps = reps if reps is not None else (10 if _FAST else 40)
    img = convert_spectrogram_to_img(np.asarray(spec_db), (0, 128), (-100.0, 0.0), 258)
    cache = RenderTileCache()
    cache.set_colormap(default_colormap_rgba8())

    lat = []
    for i in range(reps):
        lx = (i % 3)
        t0 = time.perf_counter()
        cache.spectrogram_tile(img, lx, 0, (i // 3) % 4, 0)
        lat.append((time.perf_counter() - t0) * 1000)
    spec_p50 = statistics.median(lat)

    wav = synth_stereo(48000, 2.0 if _FAST else 20.0)[0]
    wlat = []
    for i in range(reps):
        lvl = i % 6
        t0 = time.perf_counter()
        encode_waveform_tile(wav, 1, lvl, 0)
        wlat.append((time.perf_counter() - t0) * 1000)
    wav_p50 = statistics.median(wlat)
    return spec_p50, wav_p50


def bench_sustained(minutes: float | None = None, reps: int | None = None):
    """Sustained per-chip throughput on one long track (per-dispatch fixed
    costs amortized over many frames)."""
    from thesia_tpu.dsp.framing import SpecSetting
    from thesia_tpu.dsp.spectrogram import SpectrogramAnalyzer

    minutes = minutes if minutes is not None else (0.1 if _FAST else 10.0)
    reps = reps if reps is not None else (2 if _FAST else 3)
    _progress("sustained long-track throughput")
    sr = 48000
    seconds = minutes * 60.0
    wavs = synth_stereo(sr, seconds, seed=9)
    analyzer = SpectrogramAnalyzer()
    setting = SpecSetting()
    res = analyzer.calc_spec_multi(wavs, sr, setting, cache_key="long", token=0)
    res.db_padded.block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = analyzer.calc_spec_multi(wavs, sr, setting, cache_key="long", token=0)
        res.db_padded.block_until_ready()
        times.append(time.perf_counter() - t0)
    return seconds / min(times)


def _multitrack_configs():
    sc = 0.05 if _FAST else 1.0
    return [
        (48000, 30.0 * sc, 2),
        (44100, 30.0 * sc, 2),
        (44100, 20.0 * sc, 1),
        (16000, 30.0 * sc, 1),
        (48000, 15.0 * sc, 1),
    ]


def bench_multitrack(reps: int | None = None):
    """Mixed-rate multi-track batched recompute (BASELINE.json config 3/4)."""
    from thesia_tpu.dsp.framing import SpecSetting
    from thesia_tpu.dsp.spectrogram import SpectrogramAnalyzer

    reps = reps if reps is not None else (2 if _FAST else 3)
    _progress("multi-track batched recompute")
    analyzer = SpectrogramAnalyzer()
    setting = SpecSetting()
    items = []
    total_audio_sec = 0.0
    for i, (sr, seconds, n_ch) in enumerate(_multitrack_configs()):
        wavs = synth_stereo(sr, seconds, seed=i)[:n_ch]
        # stable tokens vouch for sample identity -> the device wav/group
        # caches keep steady-state recomputes free of h2d transfers
        items.append((i, wavs, sr, i + 1))
        total_audio_sec += seconds
    # warm
    r = analyzer.calc_specs_batched(items, setting)
    for v in r.values():
        v.db_padded.block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = analyzer.calc_specs_batched(items, setting)
        for v in r.values():
            v.db_padded.block_until_ready()
        times.append(time.perf_counter() - t0)
    return total_audio_sec / min(times)


def bench_long_track_interactive(minutes: float | None = None):
    """A 1-hour stereo 48 kHz track must be INTERACTIVE: apply (quantize
    dispatch) and the first whole-track tile come back in seconds, and once
    the background stream lands every LOD level encodes under the 5 ms
    viewport budget.

    The track is written at 16-bit depth (how hour-long material actually
    ships), so the add takes the interleaved-s16 prefetch upload."""
    import pathlib
    import tempfile

    from thesia_tpu.engine.session import EngineSession
    from thesia_tpu.io.wav import encode_wav_s16
    from thesia_tpu.render import default_colormap_rgba8

    minutes = minutes if minutes is not None else (0.5 if _FAST else 60.0)
    _progress(f"long-track interactive ({minutes:.0f} min stereo 48k s16)")
    sr = 48000
    td = pathlib.Path(tempfile.mkdtemp(prefix="thesia_bench_"))
    wavs = synth_stereo(sr, minutes * 60.0, seed=4)
    path = td / "long.wav"
    path.write_bytes(encode_wav_s16(wavs, sr))
    del wavs

    session = EngineSession(settings_dir=str(td))
    session.init(default_colormap_rgba8())
    t0 = time.perf_counter()
    session.add_tracks([0], [str(path)])
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.apply_track_list_changes()
    apply_s = time.perf_counter() - t0
    # first whole-track paint: coarsest-LOD tile right after apply
    md = session.get_audio_render_metadata("0_0")
    w = md["spectrogramWidth"]
    lx = max(0, (w // 512).bit_length())
    t0 = time.perf_counter()
    session.get_spectrogram_tile("0_0", lx, 0, 0, 0)
    first_tile_s = time.perf_counter() - t0
    # settled: every LOD level under the viewport budget
    session.tm.images.drain()
    lat = []
    for level in range(0, lx + 1):
        for ly in (0, 1):
            for rep in range(3):
                t0 = time.perf_counter()
                session.get_spectrogram_tile("0_0", level, ly, 0, 0)
                lat.append((time.perf_counter() - t0) * 1000)
    settled_p50 = statistics.median(lat)
    settled_p95 = sorted(lat)[int(0.95 * (len(lat) - 1))]
    # warm global-range change: dynamic-scalar quantize redispatch only
    t0 = time.perf_counter()
    session.set_db_range(90.0)
    range_change_s = time.perf_counter() - t0
    session.tm.images.drain()
    # incremental apply (round 5): a second track added to the LIVE session.
    # max_sr is unchanged, so this takes the did-the-range-move path — the
    # deferred apply returns at dispatch instead of holding the write worker
    # until the new track's spec bounds land on the host; the probe +
    # conditional requantize settle in background (settings_settled).
    w2 = synth_stereo(sr, 3.0 if _FAST else 30.0, seed=5)
    p2 = td / "short.wav"
    p2.write_bytes(encode_wav_s16(w2, sr))
    session.add_tracks([1], [str(p2)])
    t0 = time.perf_counter()
    session.apply_track_list_changes(defer=True)
    add2_apply_s = time.perf_counter() - t0
    settled = session.settings_settled(timeout=_T(600))
    add2_settled_s = (time.perf_counter() - t0) if settled else -1.0
    session.tm.images.drain()
    return {
        "long1h_add_s": round(add_s, 2),
        "long1h_apply_s": round(apply_s, 2),
        "long1h_first_tile_s": round(first_tile_s, 2),
        "long1h_tile_p50_settled_ms": round(settled_p50, 2),
        "long1h_tile_p95_settled_ms": round(settled_p95, 2),
        "long1h_db_range_change_s": round(range_change_s, 3),
        "long1h_add2_apply_s": round(add2_apply_s, 4),
        "long1h_add2_apply_settled_s": round(add2_settled_s, 2),
    }


def bench_settings_change(reps: int | None = None):
    """Warm end-to-end set_spec_setting on a 5-row mixed-sr session."""
    import pathlib
    import tempfile

    from thesia_tpu.engine.session import EngineSession
    from thesia_tpu.io.wav import encode_wav_f32
    from thesia_tpu.render import default_colormap_rgba8

    reps = reps if reps is not None else (2 if _FAST else 4)
    _progress("warm settings change (5-row mixed-sr session)")
    td = pathlib.Path(tempfile.mkdtemp(prefix="thesia_bench_s_"))
    paths = []
    for i, (sr, seconds, n_ch) in enumerate(_multitrack_configs()):
        w = synth_stereo(sr, seconds, seed=10 + i)[:n_ch]
        p = td / f"s{i}.wav"
        p.write_bytes(encode_wav_f32(w, sr))
        paths.append(str(p))
    session = EngineSession(settings_dir=str(td))
    session.init(default_colormap_rgba8())
    session.add_tracks(list(range(5)), paths)
    session.apply_track_list_changes()
    session.tm.images.drain()
    a = {"winMillisec": 40.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}
    b = {"winMillisec": 40.0, "tOverlap": 8, "fOverlap": 1, "freqScale": "Mel"}
    # warm both shapes (defer=False: this benchmarks the switch WORK, not
    # the deferred dispatch)
    session.set_spec_setting(b, defer=False)
    session.tm.images.drain()
    session.set_spec_setting(a, defer=False)
    session.tm.images.drain()
    times = []
    for i in range(reps):
        target = b if i % 2 == 0 else a
        t0 = time.perf_counter()
        session.set_spec_setting(target, defer=False)
        times.append(time.perf_counter() - t0)
        session.tm.images.drain()
    return statistics.median(times)


def bench_cold_shape_with_warmer():
    """With the background shape warmer enabled, a settings change to a
    NEVER-executed neighbor shape (t_overlap one detent away) hits the
    persistent compile cache instead of compiling inline: the warmer runs at
    track-add time.  The warmer drain below stands in for user think-time."""
    import pathlib
    import tempfile

    from thesia_tpu.engine.session import EngineSession
    from thesia_tpu.io.wav import encode_wav_f32
    from thesia_tpu.render import default_colormap_rgba8

    _progress("cold-shape settings change with background warmer")
    sc = 0.1 if _FAST else 1.0
    prev = os.environ.get("THESIA_PRECOMPILE")
    os.environ["THESIA_PRECOMPILE"] = "1"
    try:
        td = pathlib.Path(tempfile.mkdtemp(prefix="thesia_bench_w_"))
        paths = []
        for i, (sr, seconds, n_ch) in enumerate([(48000, 20.0 * sc, 2), (44100, 15.0 * sc, 1)]):
            w = synth_stereo(sr, seconds, seed=20 + i)[:n_ch]
            p = td / f"w{i}.wav"
            p.write_bytes(encode_wav_f32(w, sr))
            paths.append(str(p))
        session = EngineSession(settings_dir=str(td))
        session.init(default_colormap_rgba8())
        session.add_tracks(list(range(len(paths))), paths)
        session.apply_track_list_changes()
        session.tm.images.drain()
        session.tm.shape_warmer.drain(timeout=_T(600))
        t0 = time.perf_counter()
        session.set_spec_setting(
            {"winMillisec": 40.0, "tOverlap": 16, "fOverlap": 1, "freqScale": "Mel"},
            defer=False,
        )
        dt = time.perf_counter() - t0
        session.tm.images.drain()
        return dt
    finally:
        if prev is None:
            os.environ.pop("THESIA_PRECOMPILE", None)
        else:
            os.environ["THESIA_PRECOMPILE"] = prev


def bench_knob_change_after_add():
    """A settings change fired IMMEDIATELY after add returns (warmer still
    busy) must stay interactive: the warmer pre-empts for interactive
    calls, orders the nearest-knob shapes first, and gets a header-probe
    head start during decode."""
    import pathlib
    import tempfile

    from thesia_tpu.engine.session import EngineSession
    from thesia_tpu.io.wav import encode_wav_f32
    from thesia_tpu.render import default_colormap_rgba8

    _progress("knob change immediately after add (warmer busy)")
    sc = 0.1 if _FAST else 1.0
    prev = os.environ.get("THESIA_PRECOMPILE")
    os.environ["THESIA_PRECOMPILE"] = "1"
    try:
        td = pathlib.Path(tempfile.mkdtemp(prefix="thesia_bench_k_"))
        paths = []
        for i, (sr, seconds, n_ch) in enumerate(
            [(48000, 25.0 * sc, 2), (44100, 18.0 * sc, 1), (16000, 25.0 * sc, 1)]
        ):
            w = synth_stereo(sr, seconds, seed=30 + i)[:n_ch]
            p = td / f"k{i}.wav"
            p.write_bytes(encode_wav_f32(w, sr))
            paths.append(str(p))
        session = EngineSession(settings_dir=str(td))
        session.init(default_colormap_rgba8())
        session.add_tracks(list(range(len(paths))), paths)
        session.apply_track_list_changes()
        # NO drain: the knob turns while the warmer is still working.
        # Production default is the DEFERRED switch: the call returns at
        # dispatch (the user-visible knob latency) and the recompute lands
        # in the background; report both.
        t0 = time.perf_counter()
        session.set_spec_setting(
            {"winMillisec": 40.0, "tOverlap": 8, "fOverlap": 1, "freqScale": "Mel"},
            defer=True,
        )
        call_s = time.perf_counter() - t0
        settled = session.settings_settled(timeout=_T(600))
        # -1 flags "never settled within the timeout" — do NOT report the
        # timeout itself as a measurement (review finding)
        settled_s = (time.perf_counter() - t0) if settled else -1.0
        session.tm.images.drain()
        # round-4 deferred dynamics switch: a Limiter-engaging normalize
        # re-derives gains + re-uploads under the write lock — the call
        # must still return at dispatch, the recompute lands in background
        _progress("deferred limiter-engaging normalize change")
        session.set_common_guard_clipping("Limiter", defer=True)
        session.settings_settled(timeout=_T(600))
        t0 = time.perf_counter()
        session.set_common_normalize({"type": "LUFS", "target": -0.5}, defer=True)
        norm_call_s = time.perf_counter() - t0
        settled = session.settings_settled(timeout=_T(600))
        norm_settled_s = (time.perf_counter() - t0) if settled else -1.0
        session.tm.images.drain()
        return call_s, settled_s, norm_call_s, norm_settled_s
    finally:
        if prev is None:
            os.environ.pop("THESIA_PRECOMPILE", None)
        else:
            os.environ["THESIA_PRECOMPILE"] = prev


# ---------------------------------------------------------------------------
# orchestration


def _device_fields() -> dict:
    """platform, device_kind, device_count and the card's name and power
    limit, for every result line.  Exits non-zero without a GPU unless
    THESIA_BENCH_BACKEND pins a platform (the CPU test rehearsal)."""
    import jax

    forced = os.environ.get("THESIA_BENCH_BACKEND")
    if forced:
        jax.config.update("jax_platforms", forced)
    dev = jax.devices()[0]
    fields = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    if dev.platform == "gpu":
        fields["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    elif forced:
        fields["card"] = f"none: {dev.platform} pinned by THESIA_BENCH_BACKEND"
    else:
        fields["error"] = f"no GPU: JAX's default backend is {dev.platform}"
        print(json.dumps(fields), flush=True)
        sys.exit(1)
    return fields


_ABANDONED: list = []  # stages whose worker thread was abandoned mid-run


def _run_stage(name: str, fn, budget_s: float):
    """Run one bench stage in a worker thread under a time budget.

    Returns (value, None) on success, (None, reason) on failure/timeout.
    A timed-out worker is abandoned (daemon), not joined: one wedged stage
    must not cost the rest of the artifact.  THESIA_BENCH_FAULT=name injects
    an exception, name:hang injects a wedge (exercises the timeout path)."""
    fault = os.environ.get("THESIA_BENCH_FAULT", "")
    box: dict = {}
    # stages mutate process env (THESIA_PRECOMPILE et al.) and restore it in
    # their finally blocks — an ABANDONED thread never ran its finally, so
    # snapshot here and restore on timeout or later measurements run under
    # the wedged stage's env (review finding)
    env_before = dict(os.environ)

    def work():
        try:
            if fault == name:
                raise RuntimeError("injected fault")
            if fault == f"{name}:hang":
                time.sleep(1e9)
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — degraded artifact > lost artifact
            box["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=work, daemon=True, name=f"bench-{name}")
    t0 = time.perf_counter()
    t.start()
    t.join(budget_s)
    if t.is_alive():
        _progress(f"stage {name} exceeded its {budget_s:.0f}s budget — abandoned")
        for k, v in env_before.items():
            if os.environ.get(k) != v:
                os.environ[k] = v
        for k in set(os.environ) - set(env_before):
            os.environ.pop(k, None)
        # the zombie thread still competes for the device — later numbers
        # may be polluted; the artifact must say so, not present them clean
        _ABANDONED.append(name)
        return None, f"timeout>{budget_s:.0f}s (thread abandoned; later stages may contend with it)"
    if "error" in box:
        _progress(f"stage {name} failed: {box['error']}")
        return None, box["error"]
    _progress(f"stage {name} done in {time.perf_counter() - t0:.1f}s")
    return box.get("value"), None


_FIELD_ORDER = [
    "metric",
    "value",
    "unit",
    "platform",
    "device_kind",
    "device_count",
    "card",
    "stft_frames_per_sec",
    "spec_tile_p50_ms",
    "waveform_tile_p50_ms",
    "multitrack_mixed_sr_x_realtime",
    "sustained_10min_x_realtime",
    "warm_settings_change_s",
    "cold_shape_precompiled_settings_change_s",
    "knob_change_after_add_s",
    "knob_change_after_add_settled_s",
    "normalize_limiter_change_s",
    "normalize_limiter_change_settled_s",
    "long1h_add_s",
    "long1h_apply_s",
    "long1h_first_tile_s",
    "long1h_tile_p50_settled_ms",
    "long1h_tile_p95_settled_ms",
    "long1h_db_range_change_s",
    "long1h_add2_apply_s",
    "long1h_add2_apply_settled_s",
]


def main():
    os.environ.setdefault("THESIA_PRECOMPILE", "0")  # clean timings
    device = _device_fields()

    result: dict = dict.fromkeys(_FIELD_ORDER)
    result.update(device)
    result["metric"] = "stft_mel_raster_realtime_factor_48k_stereo"
    result["unit"] = "x_realtime_per_chip"
    errors: dict[str, str] = {}
    emit_lock = threading.Lock()
    emitted = [False]

    def emit():
        with emit_lock:
            if emitted[0]:
                return
            emitted[0] = True
            if errors:
                result["error"] = "; ".join(
                    f"{k}: {v}" for k, v in errors.items()
                )
            if _ABANDONED:
                # every field measured after an abandoned stage shared the
                # device with its zombie thread — flag, don't falsify
                result["tainted_after_stage_timeout"] = list(_ABANDONED)
            print(json.dumps(result), flush=True)

    # global watchdog: if the whole run overruns, emit whatever has been
    # measured, marked as an error, and fail
    total_budget = float(
        os.environ.get("THESIA_BENCH_TOTAL_BUDGET", "900" if _FAST else "4200")
    )

    def overrun():
        _progress(f"TOTAL budget ({total_budget:.0f}s) exceeded — emitting partial artifact")
        errors["watchdog"] = f"total budget {total_budget:.0f}s exceeded"
        emit()
        os._exit(1)

    watchdog = threading.Timer(total_budget, overrun)
    watchdog.daemon = True
    watchdog.start()

    stage_override = os.environ.get("THESIA_BENCH_STAGE_BUDGET")

    def B(seconds: float) -> float:
        if stage_override:
            return float(stage_override)
        return 90.0 if _FAST else seconds

    spec = None
    v, e = _run_stage("throughput", bench_spec_throughput, B(1200))
    if v is not None:
        realtime_factor, frames_per_sec, spec = v
        result["value"] = round(realtime_factor, 2)
        result["stft_frames_per_sec"] = round(frames_per_sec)
    else:
        errors["throughput"] = e

    if spec is None:
        # host-side tile encoding doesn't need the device stage to have
        # succeeded — bench it on a synthetic dB grid of the same shape
        spec = np.random.default_rng(0).uniform(-100.0, 0.0, (4000, 128)).astype(np.float32)
    v, e = _run_stage("tile_latency", lambda: bench_tile_latency(spec), B(300))
    if v is not None:
        result["spec_tile_p50_ms"] = round(v[0], 3)
        result["waveform_tile_p50_ms"] = round(v[1], 3)
    else:
        errors["tile_latency"] = e

    v, e = _run_stage("multitrack", bench_multitrack, B(900))
    if v is not None:
        result["multitrack_mixed_sr_x_realtime"] = round(v, 2)
    else:
        errors["multitrack"] = e

    v, e = _run_stage("sustained", bench_sustained, B(900))
    if v is not None:
        result["sustained_10min_x_realtime"] = round(v, 2)
    else:
        errors["sustained"] = e

    v, e = _run_stage("settings_change", bench_settings_change, B(900))
    if v is not None:
        result["warm_settings_change_s"] = round(v, 3)
    else:
        errors["settings_change"] = e

    v, e = _run_stage("cold_shape", bench_cold_shape_with_warmer, B(1200))
    if v is not None:
        result["cold_shape_precompiled_settings_change_s"] = round(v, 3)
    else:
        errors["cold_shape"] = e

    v, e = _run_stage("knob_after_add", bench_knob_change_after_add, B(1500))
    if v is not None:
        result["knob_change_after_add_s"] = round(v[0], 3)
        result["knob_change_after_add_settled_s"] = round(v[1], 3)
        result["normalize_limiter_change_s"] = round(v[2], 3)
        result["normalize_limiter_change_settled_s"] = round(v[3], 3)
    else:
        errors["knob_after_add"] = e

    v, e = _run_stage("long_track", bench_long_track_interactive, B(1500))
    if v is not None:
        result.update(v)
    else:
        errors["long_track"] = e

    emit()
    # hard exit: abandoned stage threads / background warmers may still sit
    # inside XLA C++ — interpreter teardown then aborts (observed SIGABRT
    # "FATAL: exception not rethrown" on CPU AOT threads).  The artifact is
    # already flushed; skip teardown entirely.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1 if errors else 0)


if __name__ == "__main__":
    main()
