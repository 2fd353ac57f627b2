"""What running on a GPU host asks of the package, checked on the CPU:
the compile-cache rule, the served path without aiohttp or matplotlib, and
chip_smoke.py's refusal to report anything without a GPU.  The one test
that needs the card runs chip_smoke.py itself."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _python(code_or_args, env_extra=None, cwd=REPO, timeout=300, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    args = [sys.executable] + (["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, capture_output=True, text=True, timeout=timeout, cwd=cwd, env=env)


_CACHE_PROBE = (
    "from thesia_tpu import runtime; runtime.configure_jax_cache(); import jax; "
    "print(jax.config.jax_compilation_cache_dir); print(runtime.compilation_cache_dir())"
)


def test_compile_cache_follows_env_variable(tmp_path):
    target = tmp_path / "cache"
    p = _python(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(target)})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == [str(target), str(target)]


def test_compile_cache_defaults_to_fixed_dir_in_checkout():
    p = _python(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert p.returncode == 0, p.stderr[-2000:]
    want = str(REPO / ".jax_cache")
    assert p.stdout.split() == [want, want]
    assert (REPO / ".jax_cache").is_dir()


def test_dispatcher_serves_without_aiohttp_or_matplotlib(tmp_path):
    """init -> add -> apply -> tile through the command dispatch with both
    packages shadowed by modules that refuse to import."""
    shadow = tmp_path / "shadow"
    for name in ("aiohttp", "matplotlib"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(f"raise ImportError('{name} shadowed')\n")
    from thesia_tpu.io.wav import encode_wav_s16

    rng = np.random.default_rng(0)
    wav = tmp_path / "a.wav"
    wav.write_bytes(encode_wav_s16(rng.uniform(-0.5, 0.5, (2, 16000)).astype(np.float32), 16000))
    code = f"""
import sys, time
from thesia_tpu.engine.dispatch import Dispatcher
from thesia_tpu.engine.session import EngineSession
from thesia_tpu.render import decode_spectrogram_tile
d = Dispatcher(EngineSession(settings_dir={str(tmp_path / 'settings')!r}))
def call(name, body=None):
    r = d.dispatch(name, body or {{}})
    assert r.status == 200, (name, r.status, r.body[:300])
    return r.body if r.content_type == "application/octet-stream" else r.json()["result"]
call("init", {{"colormapRgba": call("get_default_colormap")}})
assert call("add_tracks", {{"trackIds": [0], "paths": [{str(wav)!r}]}}) == [0]
call("apply_track_list_changes")
t0 = time.time()
while call("get_audio_render_metadata", {{"idChStr": "0_1"}})["isComputing"]:
    assert time.time() - t0 < 120
    time.sleep(0.05)
tile = decode_spectrogram_tile(call("get_spectrogram_tile",
    {{"idChStr": "0_1", "levelX": 0, "levelY": 0, "tileX": 0, "tileY": 0}}))
assert tile["width"] > 0 and tile["height"] > 0
assert "aiohttp" not in sys.modules and "matplotlib" not in sys.modules
print("SERVED_OK")
"""
    pythonpath = os.pathsep.join([str(shadow), str(REPO)])
    p = _python(code, {"PYTHONPATH": pythonpath, "THESIA_DEFER_SETTINGS": "1"}, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "SERVED_OK" in p.stdout


def _ok_line(stdout):
    return [l for l in stdout.splitlines() if l.startswith('{"ok"')]


def test_chip_smoke_refuses_the_cpu():
    p = _python(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"}, timeout=300)
    assert p.returncode != 0
    assert not _ok_line(p.stdout), p.stdout[-2000:]
    assert "needs a GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _python(["chip_smoke.py"], cwd=tmp_path, timeout=300, drop=("PYTHONPATH",))
    assert p.returncode != 0
    assert not _ok_line(p.stdout), p.stdout[-2000:]
    assert "thesia_tpu" in p.stderr


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_gpu(gpu_host):
    # the suite's CPU pin and test-mode knobs must not reach the card run
    drop = ("JAX_PLATFORMS", "XLA_FLAGS", "THESIA_DEFER_SETTINGS", "THESIA_PRECOMPILE")
    p = _python(["chip_smoke.py"], timeout=1500, drop=drop)
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-3000:])
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


def test_s24_wav_encoder_round_trips():
    from thesia_tpu.io.wav import decode_wav, encode_wav_s24

    rng = np.random.default_rng(5)
    w = rng.uniform(-1.0, 1.0, (2, 4000)).astype(np.float32)
    w[0, :3] = (-1.0, 0.0, 1.0)
    got, sr, codec = decode_wav(encode_wav_s24(w, 96000))
    assert (sr, codec, got.shape) == (96000, "pcm_s24le", w.shape)
    assert np.abs(got - w)[:, 3:].max() <= 0.5 / 8388608 + 6e-8  # half a step + f32 ulp
    assert got[0, 0] == -1.0 and got[0, 1] == 0.0
    assert got[0, 2] == np.float32(8388607 / 8388608)  # +1.0 clamps to full scale


def test_device_dynamics_gate(monkeypatch):
    """The engine asks device_dynamics_preferred() before the batched device
    paths; the compute functions themselves run on any f64 backend."""
    from thesia_tpu.dynamics import stats_device

    monkeypatch.delenv("THESIA_DEVICE_DYNAMICS", raising=False)
    assert stats_device.device_dynamics_ok()
    assert stats_device.device_dynamics_preferred() == (
        "cpu" in stats_device._DEVICE_DYNAMICS_BACKENDS
    )
    monkeypatch.setenv("THESIA_DEVICE_DYNAMICS", "0")
    assert not stats_device.device_dynamics_preferred()
    w = np.full((1, 9000), 3.0, np.float32)
    assert stats_device.limiter_gain_seqs_batched([("k", w, 8000)])["k"].shape == (9000,)
