"""Drive the engine's served path once on one NVIDIA GPU and check it.

    python chip_smoke.py

Builds a seeded corpus (a 1-hour 48 kHz stereo s16 track and a mixed-rate
set at 44.1/96/22.05/16 kHz), runs a viewer session through the service's
own command dispatch (engine/dispatch.py) in the production deferred mode,
and compares what comes out with the numpy float64 reference
(thesia_tpu/dsp/reference.py): dB rows of every track and channel, u16
images, the rfft route, Linear scale, and the f64 limiter/LUFS programs.
Also replays requests over HTTP when aiohttp is installed.

Needs a GPU: anywhere else it exits non-zero before printing a result.  It
prints findings on the way (times, peak device memory, errors beside their
bounds); the last stdout line is {"ok": true, "device": {...}}.  Everything
runs in this one process, so one process holds the card.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
WORK = REPO / ".chip_smoke"  # corpus + session settings; removed at the end

# (name, sample rate, seconds, channels, WAV encoding)
LONG_TRACK = ("long_1h", 48000, 3600.0, 2, "s16")
MIXED_TRACKS = (
    ("mix_44k_f32", 44100, 300.0, 2, "f32"),
    ("mix_96k_s24", 96000, 300.0, 2, "s24"),
    ("mix_22k_s16", 22050, 180.0, 1, "s16"),
    ("mix_16k_s16", 16000, 60.0, 1, "s16"),
)
# the mixed-rate track whose quiet body with loud clicks makes the limiter
# engage after a -23 LUFS normalize
QUIET_TRACK = "mix_22k_s16"
SETTLE_TIMEOUT_S = 300.0
CPU_EXCERPT_S = 10.0
LONG_EDGE_FRAMES = 1024
LONG_FRAME_STRIDE = 97
SYNTH_POOL = 12
DEVICE_LUFS_SECONDS = 900.0

_t_start = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _t_start:8.2f}s] {msg}", flush=True)


def require_gpu():
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is {backend!r}",
              file=sys.stderr)
        sys.exit(2)
    return jax.devices()[0]


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# corpus


def synth(sr: int, seconds: float, n_ch: int, seed: int, quiet: bool = False) -> np.ndarray:
    """Seeded music-like signal in 10 s blocks: each block is a chord of
    five partials over noise under a slow envelope, drawn with a random gain
    from a pool of SYNTH_POOL distinct blocks (so an hour costs seconds to
    make).  quiet: -20 dB body with 1 ms clicks every 2 s, so a loudness
    normalize lifts the clicks past full scale."""
    rng = np.random.default_rng(seed)
    n = int(round(sr * seconds))
    block = 10 * sr
    n_blocks = -(-n // block)
    t = np.arange(block, dtype=np.float64) / sr
    env = 0.55 + 0.45 * np.sin(2.0 * np.pi * 0.25 * t)
    pool = []
    for _ in range(min(n_blocks, SYNTH_POOL)):
        x = rng.normal(0.0, 0.01, (n_ch, block))
        for f, amp in zip(rng.uniform(60.0, 0.4 * sr, 5), (0.2, 0.15, 0.1, 0.07, 0.02)):
            x += amp * np.sin(2.0 * np.pi * f * t + rng.uniform(0, 2 * np.pi, (n_ch, 1)))
        pool.append((x * env).astype(np.float32))
    out = np.empty((n_ch, n_blocks * block), np.float32)
    for k, (i, g) in enumerate(zip(rng.integers(0, len(pool), n_blocks),
                                   rng.uniform(0.6, 1.0, n_blocks))):
        np.multiply(pool[i], np.float32(g), out=out[:, k * block : (k + 1) * block])
    out = out[:, :n]
    if quiet:
        out *= np.float32(0.1)
        click = int(0.001 * sr)
        for a in range(sr, n - click, 2 * sr):
            out[:, a : a + click] = np.float32(0.9) * np.sign(
                np.sin(np.arange(click) * 0.3)
            ).astype(np.float32)
    return out


def write_corpus() -> dict:
    from thesia_tpu.io.wav import encode_wav_f32, encode_wav_s16, encode_wav_s24

    encoders = {"s16": encode_wav_s16, "s24": encode_wav_s24, "f32": encode_wav_f32}
    WORK.mkdir()
    corpus = {}
    for seed, (name, sr, sec, n_ch, enc) in enumerate((LONG_TRACK,) + MIXED_TRACKS):
        wavs = synth(sr, sec, n_ch, seed, quiet=name == QUIET_TRACK)
        path = WORK / f"{name}.wav"
        path.write_bytes(encoders[enc](wavs, sr))
        corpus[name] = (str(path), sr, path.stat().st_size)
        del wavs
    return corpus


# ---------------------------------------------------------------------------
# dispatch helpers


class Driver:
    """Viewer-style client of the command dispatch (the code behind
    POST /api/<command>)."""

    def __init__(self, dispatcher):
        self.d = dispatcher

    def __call__(self, name: str, body: dict | None = None):
        reply = self.d.dispatch(name, body or {})
        if reply.status != 200:
            raise RuntimeError(f"{name} -> {reply.status}: {reply.body[:500]!r}")
        if reply.content_type == "application/octet-stream":
            return reply.body
        return reply.json()["result"]

    def computing(self, id_chs) -> bool:
        return any(self("get_audio_render_metadata", {"idChStr": i})["isComputing"] for i in id_chs)

    def settle(self, id_chs, t0: float) -> float:
        while self.computing(id_chs):
            if time.perf_counter() - t0 > SETTLE_TIMEOUT_S:
                raise TimeoutError("session did not settle")
            time.sleep(0.02)
        return time.perf_counter() - t0

    def tiles(self, id_chs) -> dict:
        """Spectrogram tiles at LOD 0 and the coarsest LOD, waveform tiles at
        level 0 and a coarse level, for every track channel."""
        out = {}
        for i in id_chs:
            md = self("get_audio_render_metadata", {"idChStr": i})
            coarse = max(0, (md["spectrogramWidth"] // 512).bit_length())
            for lx in (0, coarse):
                out[("spec", i, lx)] = self("get_spectrogram_tile", {
                    "idChStr": i, "levelX": lx, "levelY": 0, "tileX": 0, "tileY": 0})
            for level in (0, 12):
                out[("wave", i, level)] = self("get_waveform_tile", {
                    "idChStr": i, "level": level, "tileIndex": 0})
        return out


def check_tiles(interim: dict, settled: dict) -> None:
    from thesia_tpu.render import decode_spectrogram_tile, decode_waveform_tile

    for key, body in settled.items():
        if interim[key] != body:
            raise AssertionError(f"interim tile {key} differs from the settled tile")
        if key[0] == "spec":
            t = decode_spectrogram_tile(body)
            assert t["width"] > 0 and t["height"] > 0 and t["levelX"] == key[2], (key, t)
            assert len(body) == 40 + t["width"] * t["height"] * 4, key
        else:
            t = decode_waveform_tile(body)
            assert t["binCount"] > 0 and np.isfinite(t["bins"]).all(), key
    log(f"tiles: {len(settled)} interim == settled, headers decode")


# ---------------------------------------------------------------------------
# comparisons with the reference


def long_frames(n_frames: int) -> np.ndarray:
    mid = np.arange(LONG_EDGE_FRAMES, n_frames - LONG_EDGE_FRAMES, LONG_FRAME_STRIDE)
    return np.unique(np.concatenate([
        np.arange(min(LONG_EDGE_FRAMES, n_frames)), mid,
        np.arange(max(n_frames - LONG_EDGE_FRAMES, 0), n_frames),
    ]))


def device_rows(db_padded, ch: int, frames: np.ndarray) -> np.ndarray:
    """dB rows of one channel, fetched 4096 frames at a time."""
    import jax.numpy as jnp

    parts = []
    for k in range(0, len(frames), 4096):
        idx = frames[k : k + 4096]
        if idx[-1] - idx[0] == len(idx) - 1:
            parts.append(np.asarray(db_padded[ch, idx[0] : idx[-1] + 1]))
        else:
            parts.append(np.asarray(db_padded[ch][jnp.asarray(idx)]))
    return np.concatenate(parts, axis=0)


def cpu_bound(setting, excerpts):
    """The CPU backend's own error against the reference on the excerpts,
    times BOUND_FACTOR: the bound the GPU result is held to."""
    import jax

    from thesia_tpu.dsp import reference
    from thesia_tpu.dsp.spectrogram import SpectrogramAnalyzer

    err = reference.DbError(0.0, 0.0, 0)
    with jax.default_device(jax.devices("cpu")[0]):
        analyzer = SpectrogramAnalyzer()
        for wavs, sr in excerpts:
            res = analyzer.calc_spec_multi(wavs, sr, setting)
            got = np.asarray(res.db_padded)[:, : res.n_frames]
            err = err.merge(reference.db_error(got, reference.spec_db(wavs, sr, setting)))
    return err.scaled(reference.BOUND_FACTOR)


def landed_image(session, tid: int, ch: int) -> np.ndarray:
    """A track channel's host u16 image; when the host-memory budget has
    evicted it, requantized first through the manager, as a tile request
    would."""
    store = session.tm.images
    store.drain()
    if store.needs_reload(tid):
        with session.rw.read():
            if not session.tm._reload_track_images(tid):
                raise AssertionError(f"track {tid}: image reload failed")
        store.drain()
    img = store.host_image(tid, ch)
    if img is None:
        raise AssertionError(f"track {tid} ch {ch}: no landed image")
    return np.asarray(img)


def check_session(label: str, session, setting, bound, long_id: int) -> None:
    """dB rows of every track and channel and every u16 image against the
    reference, under the session's current setting and dB range."""
    from thesia_tpu.dsp import reference
    from thesia_tpu.render.visualize import quantize_min_value

    tm = session.tm
    lo, span = (float(np.asarray(v)) for v in tm._quant_scalars())
    min_value = quantize_min_value(tm.colormap_length or None)
    worst = reference.DbError(0.0, 0.0, 0)
    for tid in session.tracklist.all_ids():
        track = session.tracklist[tid]
        res = tm._ensure_spec(session.tracklist, tid)
        wavs, _token, gain = tm._spec_source(track)
        frames = long_frames(res.n_frames) if tid == long_id else np.arange(res.n_frames)
        ref = reference.spec_db(wavs, track.sr, setting, frames, gain)
        i_start, i_end = setting.freq_scale.hz_range_to_idx(
            (0.0, tm.max_sr / 2.0), track.sr, res.n_freq)
        for ch in range(track.n_ch):
            err = reference.db_error(device_rows(res.db_padded, ch, frames), ref[ch])
            ref_img = reference.quantize_u16(ref[ch], lo, span, i_start, i_end - i_start, min_value)
            got_img = landed_image(session, tid, ch)[:, frames]
            near, overall, share = reference.u16_diff(got_img, ref_img, ref[ch], i_start)
            log(f"{label} track {tid} ({track.sr} Hz) ch {ch}: dB err near {err.near_db:.3e} dB "
                f"(bound {bound.near_db:.3e}), far {err.far_rel:.3e} of row max "
                f"(bound {bound.far_rel:.3e}), {len(frames)} frames; u16 max step "
                f"{near} near (bound 1), {overall} overall, {share:.4%} of pixels differ")
            if not err.within(bound):
                raise AssertionError(f"{label} track {tid} ch {ch}: {err} exceeds {bound}")
            if near > 1:
                raise AssertionError(f"{label} track {tid} ch {ch}: u16 off by {near} steps")
            worst = worst.merge(err)
    log(f"{label}: every track and channel within bounds ({worst.bins} bins compared)")


def default_precision_error(wavs, sr, setting, frames):
    """The same DFT/mel products at Precision.DEFAULT (TF32 on the GPU's
    tensor cores) against the reference."""
    import jax
    import jax.numpy as jnp

    from thesia_tpu.dsp import reference
    from thesia_tpu.dsp.spectrogram import SpectrogramAnalyzer

    analyzer = SpectrogramAnalyzer()
    hop, win, n_fft = setting.calc_framing_params(sr)
    cw, sw = analyzer._dft_mats(win, n_fft)
    mel = analyzer.mel_fb(sr, n_fft)
    padded = np.pad(wavs, ((0, 0), (win // 2, win // 2)), mode="reflect")
    x = padded[:, frames[:, None] * hop + np.arange(win)[None, :]]

    @jax.jit
    def tf32_db(x, cw, sw, mel):
        p = jax.lax.Precision.DEFAULT
        re = jnp.einsum("ctw,wf->ctf", x, cw, precision=p)
        im = jnp.einsum("ctw,wf->ctf", x, sw, precision=p)
        return 20.0 * jnp.log10(jnp.einsum("ctf,fm->ctm", jnp.sqrt(re * re + im * im), mel, precision=p))

    got = np.asarray(tf32_db(jnp.asarray(x), cw, sw, mel))
    return reference.db_error(got, reference.spec_db(wavs, sr, setting, frames))


# ---------------------------------------------------------------------------
# phases


def phase_first_touch() -> None:
    import jax.numpy as jnp

    t0 = time.perf_counter()
    np.asarray(jnp.arange(8, dtype=jnp.float32) * 2.0)
    t1 = time.perf_counter()
    np.asarray(jnp.arange(16, dtype=jnp.float32) * 3.0)
    t2 = time.perf_counter()
    log(f"first device round trip {1e3 * (t1 - t0):.2f} ms, second (also a new "
        f"program) {1e3 * (t2 - t1):.2f} ms")


def phase_dynamics(long_wavs: np.ndarray, sr: int) -> None:
    """Device f64 limiter (1-hour track) and LUFS (its first
    DEVICE_LUFS_SECONDS: the one-hour LUFS program asks for 73 GiB) against
    the native streaming implementations, at the repo's <= 1e-9."""
    from thesia_tpu.dynamics import stats_device
    from thesia_tpu.dynamics.limiter import PerfectLimiter
    from thesia_tpu.dynamics.stats import calc_stats

    assert stats_device.device_dynamics_ok(), "device f64 probe failed on the GPU"
    hot = (np.float32(3.0) * long_wavs).astype(np.float32)  # engages the limiter
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        g_dev = stats_device.limiter_gain_seqs_batched([(0, hot, sr)])[0]
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    g_nat = PerfectLimiter(sr).calc_gain_seq(hot)
    t_nat = time.perf_counter() - t0
    err = float(np.abs(g_dev - g_nat).max())
    log(f"limiter 1 h stereo: device cold {times[0]:.3f} s, warm {times[1]:.3f} s "
        f"(upload, f64 program, gain download); native {t_nat:.3f} s; max |gain "
        f"diff| {err:.3e} (bound 1e-9); min gain {g_nat.min():.4f}")
    if not err <= 1e-9:
        raise AssertionError(f"device limiter gain differs by {err}")
    del hot, g_dev, g_nat
    part = np.ascontiguousarray(long_wavs[:, : int(DEVICE_LUFS_SECONDS * sr)])
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        lufs_dev = stats_device.lufs_stats_batched([(0, part, sr)])[0][0]
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    lufs_nat = calc_stats(part, sr).global_lufs
    t_nat = time.perf_counter() - t0
    err = abs(lufs_dev - lufs_nat)
    log(f"LUFS {DEVICE_LUFS_SECONDS / 60:.0f} min stereo: device cold {times[0]:.3f} s, warm {times[1]:.3f} s; native "
        f"stats {t_nat:.3f} s; {lufs_dev:.6f} vs {lufs_nat:.6f} LUFS, |diff| {err:.3e} "
        f"(bound 1e-9)")
    if not err <= 1e-9:
        raise AssertionError(f"device LUFS differs by {err}")


def phase_routes(long_wavs: np.ndarray, sr: int, bound) -> None:
    """GEMM route against rfft route for the default setting on the 1-hour
    track: host clock around block_until_ready, warm, median of 3."""
    import jax.numpy as jnp

    from thesia_tpu.dsp import reference
    from thesia_tpu.dsp.framing import SpecSetting
    from thesia_tpu.dsp.spectrogram import SpectrogramAnalyzer, _spec_full, frame_cap

    setting = SpecSetting()
    hop, win, n_fft = setting.calc_framing_params(sr)
    analyzer = SpectrogramAnalyzer()
    res = analyzer.calc_spec_multi(long_wavs, sr, setting, cache_key="long", token=0)
    res.db_padded.block_until_ready()
    raw, n, _tok = analyzer._wav_cache["long"]
    window = jnp.asarray(reference.hann_normalized(win, n_fft).astype(np.float32))
    mel = analyzer.mel_fb(sr, n_fft)
    cw, sw = analyzer._dft_mats(win, n_fft)
    statics = dict(hop_length=hop, t_overlap=win // hop, use_mel=True,
                   bucket=raw.shape[-1], pad=win // 2, t_cap=frame_cap(res.n_frames))
    routes = {
        "gemm": lambda: _spec_full(raw, jnp.int32(n), jnp.float32(1.0), cw, sw, mel, **statics),
        "rfft": lambda: _spec_full(raw, jnp.int32(n), jnp.float32(1.0), window, window, mel,
                                   rfft_n_fft=n_fft, **statics),
    }
    frames = long_frames(res.n_frames)
    ref = reference.spec_db(long_wavs, sr, setting, frames)
    for name, run in routes.items():
        t0 = time.perf_counter()
        db = run()[0]
        db.block_until_ready()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()[0].block_until_ready()
            warm.append(time.perf_counter() - t0)
        err = reference.DbError(0.0, 0.0, 0)
        for ch in range(long_wavs.shape[0]):
            err = err.merge(reference.db_error(device_rows(db, ch, frames), ref[ch]))
        log(f"route {name} (40 ms Mel, 1 h stereo, {res.n_frames} frames/ch): cold "
            f"{cold:.3f} s, warm median {sorted(warm)[1] * 1e3:.2f} ms; dB err near "
            f"{err.near_db:.3e} far {err.far_rel:.3e}")
        if not err.within(bound):
            raise AssertionError(f"route {name}: {err} exceeds {bound}")
        del db
    tf32 = default_precision_error(long_wavs, sr, setting, frames[:: max(1, len(frames) // 2048)])
    log(f"Precision.DEFAULT (TF32) products: dB err near {tf32.near_db:.3e} (bound "
        f"{bound.near_db:.3e}), far {tf32.far_rel:.3e} (bound {bound.far_rel:.3e})")
    if tf32.within(bound):
        raise AssertionError("a TF32 spectrogram passed the HIGHEST-precision bound")
    analyzer.clear_wav_cache()


def phase_session(corpus: dict, bounds_for) -> object:
    """The viewer's session through the command dispatch."""
    from thesia_tpu.common.freqscale import FreqScale
    from thesia_tpu.dsp import spectrogram as sg
    from thesia_tpu.dsp.framing import SpecSetting
    from thesia_tpu.engine.dispatch import Dispatcher
    from thesia_tpu.engine.session import EngineSession

    session = EngineSession(settings_dir=str(WORK / "settings"))
    api = Driver(Dispatcher(session))
    names = [LONG_TRACK[0]] + [m[0] for m in MIXED_TRACKS]
    paths = [corpus[name][0] for name in names]
    api("init", {"colormapRgba": api("get_default_colormap")})

    t0 = time.perf_counter()
    ids = api("add_tracks", {"trackIds": list(range(len(paths))), "paths": paths})
    t_add = time.perf_counter() - t0
    api("apply_track_list_changes")
    t_apply = time.perf_counter() - t0
    api("get_spectrogram_tile", {"idChStr": "0_0", "levelX": 0, "levelY": 0, "tileX": 0, "tileY": 0})
    t_tile = time.perf_counter() - t0
    id_chs = [f"{tid}_{ch}" for tid in ids for ch in range(api("get_channel_counts", {"trackId": tid}))]
    streaming = sum(session.tm.images.is_computing(t) for t in ids)
    interim = api.tiles(id_chs)
    settle = api.settle(id_chs, t0)
    log(f"cold: add_tracks returned {t_add:.3f} s, apply {t_apply:.3f} s, first tile "
        f"{t_tile:.3f} s, settled {settle:.3f} s after add (5 tracks, {len(id_chs)} channels, "
        f"{streaming} still streaming at the interim tiles)")
    check_tiles(interim, api.tiles(id_chs))
    check_session("Mel 40 ms", session, SpecSetting(), bounds_for(SpecSetting()), ids[0])

    switches = [
        ("Linear 80 ms", {"winMillisec": 80.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Linear"}),
        ("Mel 100 ms", {"winMillisec": 100.0, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}),
    ]
    for label, body in switches:
        setting = SpecSetting.from_json(body)
        rfft = [session.tracklist[t].sr for t in ids
                if sg.use_rfft_for(*setting.calc_framing_params(session.tracklist[t].sr)[1:])]
        t0 = time.perf_counter()
        api("set_spec_setting", {"specSetting": body})
        # tiles keep serving the old revision until the deferred switch
        # lands; interim tiles of the NEW revision come after that
        while session.spec_switch_pending():
            if time.perf_counter() - t0 > SETTLE_TIMEOUT_S:
                raise TimeoutError("settings switch did not land")
            time.sleep(0.01)
        landed = time.perf_counter() - t0
        streaming = sum(session.tm.images.is_computing(t) for t in ids)
        interim = api.tiles(id_chs)
        settle = api.settle(id_chs, t0)
        assert api("get_spec_setting") == body
        log(f"set_spec_setting {label}: switch landed {landed:.3f} s ({streaming} tracks "
            f"still streaming), settled {settle:.3f} s (rfft route at {rfft or 'no'} Hz)")
        check_tiles(interim, api.tiles(id_chs))
        check_session(label, session, setting, bounds_for(setting), ids[0])
        if label.startswith("Mel 100"):
            assert 96000 in rfft, "no track took the rfft route"
            assert setting.freq_scale is FreqScale.Mel

    t0 = time.perf_counter()
    api("set_dB_range", {"dBRange": 80.0})
    settle = api.settle(id_chs, t0)
    log(f"set_dB_range 80: settled {settle:.3f} s")
    check_session("Mel 100 ms, 80 dB", session, setting, bounds_for(setting), ids[0])

    t0 = time.perf_counter()
    api("set_common_normalize", {"target": {"type": "LUFS", "target": -23.0}})
    api("set_common_guard_clipping", {"mode": "Limiter"})
    settle = api.settle(id_chs, t0)
    log(f"normalize LUFS -23 + Limiter: settled {settle:.3f} s")
    from thesia_tpu.dynamics.stats import calc_stats

    for tid, name in zip(ids, names):
        stats = api("get_guard_clip_stats", {"trackId": tid})
        lufs = api("get_global_lufs", {"trackId": tid})
        track = session.tracklist[tid]
        want = calc_stats(track.audio.wavs, track.sr).global_lufs
        got = lufs["value"]
        log(f"track {tid} {name}: global LUFS {got:.6f} (host {want:.6f}), guard clip stats {stats}")
        assert abs(got - want) <= 1e-9, (got, want)
        if name == QUIET_TRACK:
            result = track.audio.guard_clip_result
            assert result.kind == "gain_sequence" and result.gain_seq.min() < 0.5, "limiter did not engage"
    return session, api, id_chs


def phase_http(session, api, id_chs) -> None:
    """Replay requests over the real HTTP front; bytes must equal the
    dispatcher's own replies."""
    import asyncio
    import urllib.request

    from aiohttp import web

    from thesia_tpu.engine.service import EngineService

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(EngineService(session).make_app())
    thread = threading.Thread(target=loop.run_forever, name="http-front", daemon=True)
    thread.start()
    run = lambda coro: asyncio.run_coroutine_threadsafe(coro, loop).result(60)
    run(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    run(site.start())
    port = runner.addresses[0][1]
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost only
    requests = [("get_audio_render_metadata", {"idChStr": i}) for i in id_chs[:3]]
    requests += [("get_spectrogram_tile", {"idChStr": i, "levelX": 1, "levelY": 0, "tileX": 0, "tileY": 0})
                 for i in id_chs[:3]]
    requests += [("get_waveform_tile", {"idChStr": id_chs[0], "level": 3, "tileIndex": 1}),
                 ("get_global_lufs", {"trackId": 0}), ("get_spec_setting", {})]
    try:
        for name, body in requests:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/{name}", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with opener.open(req, timeout=60) as r:
                got = r.read()
            want = api.d.dispatch(name, body).body
            if got != want:
                raise AssertionError(f"HTTP {name} {body}: bytes differ from the dispatcher's")
    finally:
        run(runner.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
    log(f"http replay: {len(requests)} requests byte-identical to the dispatcher")


def main() -> None:
    from thesia_tpu import native, runtime  # fails first outside a checkout

    dev = require_gpu()
    import jax

    runtime.configure_jax_cache()
    card = card_name_and_power_limit()
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    print(f"jax {jax.__version__}; devices {jax.devices()}; compile cache "
          f"{runtime.compilation_cache_dir()}; native library {native.available()}", flush=True)
    try:
        import aiohttp  # noqa: F401

        http = True
    except ImportError:
        http = False
    print(f"http replay: {'runs' if http else 'skipped, aiohttp not installed'}", flush=True)

    compile_s = [0.0, 0]

    def on_event(event, duration, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += duration
            compile_s[1] += 1

    jax.monitoring.register_event_duration_secs_listener(on_event)
    phase_first_touch()

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    corpus = write_corpus()
    log(f"corpus written in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v[2] / 2**20:.0f} MiB" for k, v in corpus.items()))

    from thesia_tpu.io.decode import open_audio_file

    long_wavs, info = open_audio_file(corpus[LONG_TRACK[0]][0])
    long_sr = info.sr
    excerpts = []
    for name, *_rest in (LONG_TRACK,) + MIXED_TRACKS:
        wavs, info = open_audio_file(corpus[name][0])
        excerpts.append((np.ascontiguousarray(wavs[:, : int(CPU_EXCERPT_S * info.sr)]), info.sr))
    bound_cache = {}

    def bounds_for(setting):
        key = json.dumps(setting.to_json(), sort_keys=True)
        if key not in bound_cache:
            bound_cache[key] = cpu_bound(setting, excerpts)
            b = bound_cache[key]
            log(f"bound for {setting.to_json()}: near {b.near_db:.3e} dB, far "
                f"{b.far_rel:.3e} of row max (CPU error x BOUND_FACTOR)")
        return bound_cache[key]

    from thesia_tpu.dsp.framing import SpecSetting

    phase_dynamics(long_wavs, long_sr)
    log(f"peak device memory after dynamics: {dev.memory_stats()['peak_bytes_in_use'] / 2**30:.2f} GiB")
    phase_routes(long_wavs, long_sr, bounds_for(SpecSetting()))
    del long_wavs
    session, api, id_chs = phase_session(corpus, bounds_for)
    if http:
        phase_http(session, api, id_chs)
    log(f"backend compiles: {compile_s[1]} taking {compile_s[0]:.1f} s (all threads)")
    log(f"peak device memory: {dev.memory_stats()['peak_bytes_in_use'] / 2**30:.2f} GiB "
        f"on {card}")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}),
        flush=True)


if __name__ == "__main__":
    # os._exit: engine worker threads (image streamer, shape warmer) may
    # still sit inside XLA; skip interpreter teardown once the verdict is out
    try:
        main()
    except SystemExit as e:
        sys.stdout.flush()
        os._exit(e.code if isinstance(e.code, int) else 1)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
