"""HTTP service tests (aiohttp test client)."""

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from thesia_tpu.engine.dispatch import COMMANDS
from thesia_tpu.engine.service import EngineService
from thesia_tpu.engine.session import EngineSession
from thesia_tpu.render import decode_waveform_tile, default_colormap_rgba8


def test_command_registry_covers_reference_surface():
    # the reference registers 41 commands (lib.rs:759-816); menu/context-menu
    # commands are desktop-shell-only and are handled by the viewer directly
    assert len(COMMANDS) == 41


def test_service_round_trip(tmp_path, samples_dir):
    import asyncio

    if not (samples_dir / "sample_16k.wav").exists():
        pytest.skip("sample corpus incomplete")
    asyncio.run(_service_round_trip(tmp_path, samples_dir))


async def _service_round_trip(tmp_path, samples_dir):
    service = EngineService(EngineSession(settings_dir=tmp_path))
    server = TestServer(service.make_app())
    client = TestClient(server)
    await client.start_server()
    try:
        r = await client.post(
            "/api/init", json={"colormapRgba": default_colormap_rgba8().reshape(-1).tolist()}
        )
        assert r.status == 200
        init = (await r.json())["result"]
        assert init["constants"]["PLAY_JUMP_SEC"] == 1.0

        r = await client.post(
            "/api/add_tracks",
            json={"trackIds": [0], "paths": [str(samples_dir / "sample_16k.wav")]},
        )
        assert (await r.json())["result"] == [0]

        r = await client.post("/api/apply_track_list_changes", json={})
        assert (await r.json())["result"] == ["0_0"]

        r = await client.post("/api/get_audio_render_metadata", json={"idChStr": "0_0"})
        md = (await r.json())["result"]
        assert md["sampleRate"] == 16000

        r = await client.post(
            "/api/get_waveform_tile", json={"idChStr": "0_0", "level": 2, "tileIndex": 0}
        )
        assert r.status == 200
        assert r.content_type == "application/octet-stream"
        tile = decode_waveform_tile(await r.read())
        assert tile["binCount"] > 0

        r = await client.post(
            "/api/get_spectrogram_tile",
            json={"idChStr": "0_0", "levelX": 0, "levelY": 0, "tileX": 0, "tileY": 0},
        )
        assert r.status == 200
        body = await r.read()
        assert len(body) > 40

        r = await client.post("/api/get_max_dB", json={})
        assert (await r.json())["result"]["type"] in ("Finite", "NegInfinity")

        # unknown command -> 404; missing arg -> 400
        r = await client.post("/api/nope", json={})
        assert r.status == 404
        r = await client.post("/api/get_sample_rate", json={})
        assert r.status == 400
    finally:
        await client.close()


def test_service_debug_and_player_endpoints(tmp_path, samples_dir):
    import asyncio

    asyncio.run(_debug_and_player(tmp_path, samples_dir))


async def _debug_and_player(tmp_path, samples_dir):
    from thesia_tpu import obs

    service = EngineService(
        EngineSession(settings_dir=tmp_path),
        open_paths=["/a.wav", "/b.wav"],
    )
    server = TestServer(service.make_app())
    client = TestClient(server)
    await client.start_server()
    try:
        r = await client.post(
            "/api/init", json={"colormapRgba": default_colormap_rgba8().reshape(-1).tolist()}
        )
        assert r.status == 200
        r = await client.post(
            "/api/add_tracks",
            json={"trackIds": [0], "paths": [str(samples_dir / "sample_8k.wav")]},
        )
        assert (await r.json())["result"] == [0]
        await client.post("/api/apply_track_list_changes", json={})

        # timing metrics populated by the pipeline stages
        r = await client.get("/debug/metrics")
        m = (await r.json())["result"]
        assert "spec.recompute" in m and m["spec.recompute"]["count"] >= 1
        assert {"count", "total_ms", "p50_ms", "p95_ms", "last_ms"} <= set(
            m["spec.recompute"]
        )

        # argv open paths are one-shot
        r = await client.get("/pending_open_paths")
        assert (await r.json())["result"] == ["/a.wav", "/b.wav"]
        r = await client.get("/pending_open_paths")
        assert (await r.json())["result"] == []

        # player flow through HTTP: set track, resume, state advances
        r = await client.post("/api/set_track_player", json={"trackId": 0, "sec": 0.0})
        assert r.status == 200
        await client.post("/api/resume_player", json={})
        import asyncio as aio

        await aio.sleep(0.15)
        r = await client.get("/player/state")
        st = (await r.json())["result"]
        assert st["isPlaying"] and st["positionSec"] > 0.0
        # out-of-range seek clamps to track length
        await client.post("/api/seek_player", json={"sec": 1e9})
        r = await client.get("/player/state")
        st = (await r.json())["result"]
        assert st["positionSec"] <= 90.0  # sample_8k.wav length ceiling
        await client.post("/api/pause_player", json={})

        # one-shot profiler capture (tiny duration)
        r = await client.post("/debug/profile", json={"durationMs": 10})
        assert r.status in (200, 500)  # 500 only if profiler unavailable
        if r.status == 200:
            assert (await r.json())["result"]
    finally:
        await client.close()


def test_service_reads_are_consistent_during_writes(tmp_path, samples_dir):
    """A slow write (set_spec_setting) never exposes half-applied state to
    concurrent reads (the RwLock deliverable, reference lib.rs:36-42)."""
    import asyncio

    asyncio.run(_reads_during_writes(tmp_path, samples_dir))


async def _reads_during_writes(tmp_path, samples_dir):
    import asyncio as aio

    service = EngineService(EngineSession(settings_dir=tmp_path))
    server = TestServer(service.make_app())
    client = TestClient(server)
    await client.start_server()
    try:
        await client.post(
            "/api/init", json={"colormapRgba": default_colormap_rgba8().reshape(-1).tolist()}
        )
        await client.post(
            "/api/add_tracks",
            json={"trackIds": [0], "paths": [str(samples_dir / "sample_8k.wav")]},
        )
        await client.post("/api/apply_track_list_changes", json={})

        async def writer():
            for win in (20, 40):
                r = await client.post(
                    "/api/set_spec_setting",
                    json={"specSetting": {"winMillisec": win, "tOverlap": 4,
                                          "fOverlap": 1, "freqScale": "Mel"}},
                )
                assert r.status == 200

        async def reader():
            for _ in range(12):
                r = await client.post(
                    "/api/get_audio_render_metadata", json={"idChStr": "0_0"}
                )
                md = (await r.json())["result"]
                # metadata is always a complete, self-consistent snapshot
                assert md["spectrogramWidth"] > 0 and md["spectrogramHeight"] > 0
                await aio.sleep(0.01)

        await aio.gather(writer(), reader())
    finally:
        await client.close()


def test_malformed_requests_never_500(tmp_path, samples_dir):
    import asyncio

    if not (samples_dir / "sample_16k.wav").exists():
        pytest.skip("sample corpus incomplete")
    asyncio.run(_malformed_requests(tmp_path, samples_dir))


async def _malformed_requests(tmp_path, samples_dir):
    """Review findings: wrong-TYPED args, non-object bodies, negative
    channels, and junk user settings must all map to clean 400s (or be
    ignored), never 500."""
    service = EngineService(EngineSession(settings_dir=tmp_path))
    server = TestServer(service.make_app())
    client = TestClient(server)
    await client.start_server()
    try:
        cm = default_colormap_rgba8().reshape(-1).tolist()
        assert (await client.post("/api/init", json={"colormapRgba": cm})).status == 200
        await client.post(
            "/api/add_tracks",
            json={"trackIds": [0], "paths": [str(samples_dir / "sample_16k.wav")]},
        )
        await client.post("/api/apply_track_list_changes", json={})

        probes = [
            ("get_waveform_tile", {"idChStr": 3, "level": 0, "tileIndex": 0}),
            ("get_waveform_tile", {"idChStr": "0_-1", "level": 0, "tileIndex": 0}),
            ("get_spectrogram_tile", {"idChStr": "1_2_3", "levelX": 0, "levelY": 0, "tileX": 0, "tileY": 0}),
            ("set_dB_range", {"dBRange": "abc"}),
            ("set_dB_range", {"dBRange": -5}),
            # json.loads accepts the bare Infinity literal; an inf range
            # turns the quantize span into NaN -> blank images, and the
            # next init would persist it (review finding)
            ("set_dB_range", {"dBRange": float("inf")}),
            ("set_dB_range", {"dBRange": float("nan")}),
            # persisting what the entry points reject would poison init
            ("set_user_settings", {"userSettings": {"dBRange": float("inf")}}),
            ("set_user_settings", {"userSettings": {"specSetting": {
                "winMillisec": 1e9, "tOverlap": 4, "fOverlap": 1,
                "freqScale": "Mel"}}}),
            ("set_track_player", {"trackId": [1], "sec": 0}),
            ("set_user_settings", {"userSettings": 5}),
            ("add_tracks", {"trackIds": [0, 1], "paths": ["/x"]}),
            ("remove_tracks", {"trackIds": []}),
            ("set_spec_setting", {"specSetting": {"winMillisec": -1, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}),
            # absurd LODs/indices overflowed u32 headers, 1<<level bigints,
            # and ctypes int64 before the entry caps (review findings)
            ("get_waveform_tile", {"idChStr": "0_0", "level": 63, "tileIndex": 0}),
            ("get_waveform_tile", {"idChStr": "0_0", "level": 2, "tileIndex": 2**40}),
            ("get_spectrogram_tile", {"idChStr": "0_0", "levelX": 10**9, "levelY": 0, "tileX": 0, "tileY": 0}),
            ("get_spectrogram_tile", {"idChStr": "0_0", "levelX": 0, "levelY": 0, "tileX": 10**7, "tileY": 0}),
            # deferred switches answer OK at dispatch, so guaranteed-to-fail
            # normalize/guard input must 400 at parse time
            ("set_common_normalize", {"target": {"type": "Wat", "target": -3}}),
            ("set_common_normalize", {"target": {"type": "LUFS"}}),
            ("set_common_normalize", {"target": {"type": "PeakdB", "target": 2.0}}),
            ("set_common_normalize", {"target": {"type": "LUFS", "target": "nan"}}),
            ("set_common_guard_clipping", {"mode": "Bogus"}),
            # absurd spec shapes would OOM the folded-DFT GEMM; the service
            # caps them at entry (reference UI clamps client-side)
            ("set_spec_setting", {"specSetting": {"winMillisec": 1e9, "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}),
            ("set_spec_setting", {"specSetting": {"winMillisec": 40, "tOverlap": 10**9, "fOverlap": 1, "freqScale": "Mel"}}),
            ("set_spec_setting", {"specSetting": {"winMillisec": 40, "tOverlap": 4, "fOverlap": 1000, "freqScale": "Mel"}}),
            ("set_spec_setting", {"specSetting": {"winMillisec": "nan", "tOverlap": 4, "fOverlap": 1, "freqScale": "Mel"}}),
        ]
        for name, body in probes:
            r = await client.post(f"/api/{name}", json=body)
            assert r.status == 400, (name, body, r.status, await r.text())
        # non-object bodies
        for raw in (b"[1,2]", b"5", b"\xff\xfe\x00bad"):
            r = await client.post(
                "/api/find_id_by_path", data=raw,
                headers={"Content-Type": "application/json"},
            )
            assert r.status == 400, (raw, r.status)
        # the session still works after all of that
        r = await client.post("/api/get_audio_render_metadata", json={"idChStr": "0_0"})
        assert r.status == 200 and (await r.json())["result"]["sampleRate"] == 16000
    finally:
        await client.close()


def test_same_named_uploads_do_not_collide(tmp_path):
    """Two uploads with the same client filename must land on distinct
    server paths — a shared fixed path let a later upload silently replace
    a track's backing file mid-decode (review finding)."""
    import asyncio

    asyncio.run(_upload_collision(tmp_path))


async def _upload_collision(tmp_path):
    import aiohttp

    service = EngineService(EngineSession(settings_dir=tmp_path))
    server = TestServer(service.make_app())
    client = TestClient(server)
    await client.start_server()
    try:
        paths = []
        for payload in (b"first-bytes", b"second-bytes"):
            form = aiohttp.FormData()
            form.add_field("file", payload, filename="song.wav")
            r = await client.post("/upload", data=form)
            assert r.status == 200
            paths.append((await r.json())["result"])
        assert paths[0] != paths[1]
        assert open(paths[0], "rb").read() == b"first-bytes"
        assert open(paths[1], "rb").read() == b"second-bytes"
    finally:
        await client.close()


def test_prune_stale_uploads_spares_live_tracks(tmp_path, samples_dir):
    """Old upload dirs are pruned, but NEVER one whose file backs a live
    track (reload re-reads from the path) — compared via RESOLVED paths,
    since track paths are resolved and a symlinked tmpdir would otherwise
    defeat the protection (review finding)."""
    import os
    import shutil
    import time

    if not (samples_dir / "sample_8k.wav").exists():
        pytest.skip("sample corpus incomplete")
    session = EngineSession(settings_dir=tmp_path)
    session.init(default_colormap_rgba8())
    service = EngineService(session)
    updir = tmp_path / "uploads"
    updir.mkdir()
    # a stale upload (mtime 2 days old)
    stale = updir / "tmp_stale"
    stale.mkdir()
    (stale / "old.wav").write_bytes(b"x")
    old = time.time() - 2 * 24 * 3600
    os.utime(stale, (old, old))
    # an equally old upload that backs a LIVE track
    live = updir / "tmp_live"
    live.mkdir()
    shutil.copyfile(samples_dir / "sample_8k.wav", live / "song.wav")
    os.utime(live, (old, old))
    session.add_tracks([0], [str(live / "song.wav")])
    session.apply_track_list_changes()
    # a fresh upload (kept by age)
    fresh = updir / "tmp_fresh"
    fresh.mkdir()
    (fresh / "new.wav").write_bytes(b"y")

    service._prune_stale_uploads(updir)
    assert not stale.exists()
    assert live.exists() and (live / "song.wav").exists()
    assert fresh.exists()
    # the spared file still reloads
    reloaded, no_err = session.tracklist.reload_tracks([0])
    assert 0 in no_err
    session.tm.images.shutdown()


def test_poisoned_settings_store_degrades_to_defaults(tmp_path):
    """A corrupt settings.json must not brick init (review finding: the old
    path parsed mid-teardown and 500'd forever)."""
    import asyncio

    asyncio.run(_poisoned_settings(tmp_path))


async def _poisoned_settings(tmp_path):
    import json as _json

    (tmp_path / "settings.json").write_text(
        _json.dumps({"specSetting": 5, "dBRange": "junk", "blend": None,
                     "commonGuardClipping": "NoSuchMode", "commonNormalize": [1]})
    )
    service = EngineService(EngineSession(settings_dir=tmp_path))
    server = TestServer(service.make_app())
    client = TestClient(server)
    await client.start_server()
    try:
        cm = default_colormap_rgba8().reshape(-1).tolist()
        r = await client.post("/api/init", json={"colormapRgba": cm})
        assert r.status == 200
        us = (await r.json())["result"]["userSettings"]
        assert us["specSetting"]["winMillisec"] == 40.0  # defaults
        assert us["dBRange"] == 100.0 and us["blend"] == 0.5
        # and the poisoned store was rewritten with valid values
        r = await client.post("/api/init", json={"colormapRgba": cm})
        assert r.status == 200
    finally:
        await client.close()


def test_service_deferred_settings_switch(tmp_path, samples_dir, monkeypatch):
    """Production default (THESIA_DEFER_SETTINGS=1) over HTTP: the command
    returns at dispatch, metadata polls through isComputing, and the new
    revision + shape land without any 500s."""
    import asyncio

    if not (samples_dir / "sample_16k.wav").exists():
        pytest.skip("sample corpus incomplete")
    monkeypatch.setenv("THESIA_DEFER_SETTINGS", "1")
    asyncio.run(_service_deferred_switch(tmp_path, samples_dir))


async def _service_deferred_switch(tmp_path, samples_dir):
    import asyncio
    import time

    session = EngineSession(settings_dir=tmp_path)
    service = EngineService(session)
    server = TestServer(service.make_app())
    client = TestClient(server)
    await client.start_server()
    try:
        r = await client.post(
            "/api/init", json={"colormapRgba": default_colormap_rgba8().reshape(-1).tolist()}
        )
        assert r.status == 200
        r = await client.post(
            "/api/add_tracks",
            json={"trackIds": [0], "paths": [str(samples_dir / "sample_16k.wav")]},
        )
        assert r.status == 200
        await client.post("/api/apply_track_list_changes", json={})
        session.tm.images.drain()
        r = await client.post(
            "/api/get_audio_render_metadata", json={"idChStr": "0_0"}
        )
        before = (await r.json())["result"]

        t0 = time.perf_counter()
        r = await client.post(
            "/api/set_spec_setting",
            json={"specSetting": {"winMillisec": 20, "tOverlap": 4,
                                  "fOverlap": 1, "freqScale": "Mel"}},
        )
        assert r.status == 200
        # read-back immediately reflects the target (viewer persist flow)
        r = await client.post("/api/get_spec_setting", json={})
        assert (await r.json())["result"]["winMillisec"] == 20

        # poll metadata like the viewer's computing watchdog until the
        # switch lands (revision bump + new shape, isComputing false)
        deadline = time.perf_counter() + 120
        md = before
        while time.perf_counter() < deadline:
            r = await client.post(
                "/api/get_audio_render_metadata", json={"idChStr": "0_0"}
            )
            assert r.status == 200
            md = (await r.json())["result"]
            if not md["isComputing"] and md["spectrogramRevision"] > before["spectrogramRevision"]:
                break
            await asyncio.sleep(0.05)
        assert md["spectrogramRevision"] > before["spectrogramRevision"]
        assert md["spectrogramWidth"] != before["spectrogramWidth"]
        # tiles serve under the new revision
        r = await client.post(
            "/api/get_spectrogram_tile",
            json={"idChStr": "0_0", "levelX": 0, "levelY": 0, "tileX": 0, "tileY": 0},
        )
        assert r.status == 200
        assert len(await r.read()) > 40
    finally:
        session.tm.images.shutdown()
        await client.close()
