"""HTTP/WebSocket service exposing the EngineSession command surface.

Transport analogue of the reference's Tauri IPC (reference:
src-tauri/src/lib.rs:759-816 command registry): JSON commands via
POST /api/<command> (dispatched by engine/dispatch.py), binary tiles as
application/octet-stream, backend events (player-state-changed, menu
events) over WebSocket /events.  The only module that imports aiohttp.
"""

from __future__ import annotations

import asyncio
import json
import logging

from aiohttp import WSMsgType, web

from .. import obs
from .dispatch import Dispatcher
from .session import EngineSession

log = logging.getLogger("thesia_tpu.service")

class EngineService:
    def __init__(
        self,
        session: EngineSession | None = None,
        viewer_dir: str | None = None,
        media_dirs: list[str] | None = None,
        open_paths: list[str] | None = None,
    ):
        self.session = session or EngineSession()
        self.dispatcher = Dispatcher(self.session)
        self.viewer_dir = viewer_dir
        self.media_dirs = media_dirs or []
        # argv file-association paths: handed to the first viewer after its
        # init, like the reference's open-audio-tracks event for argv files
        # (reference: lib.rs:562-619 argv / deep-link open paths)
        self.open_paths = list(open_paths or [])
        self._ws_clients: set[web.WebSocketResponse] = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self.session.add_listener(self._on_event)

    # -- events ------------------------------------------------------------
    def _on_event(self, name: str, payload) -> None:
        if self._loop is None or not self._ws_clients:
            return
        msg = json.dumps({"event": name, "payload": payload})

        def _send_all() -> None:
            for ws in list(self._ws_clients):
                if ws.closed:
                    self._ws_clients.discard(ws)
                    continue
                task = asyncio.ensure_future(ws.send_str(msg))
                # retrieve exceptions (dead client mid-send) so they don't
                # spam 'Task exception was never retrieved' on every event
                task.add_done_callback(lambda t: t.exception())

        self._loop.call_soon_threadsafe(_send_all)

    # -- handlers ----------------------------------------------------------
    async def handle_command(self, request: web.Request) -> web.StreamResponse:
        name = request.match_info["command"]
        try:
            body = await request.json() if request.can_read_body else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            body = {}
        reply = await asyncio.get_event_loop().run_in_executor(
            None, self.dispatcher.dispatch, name, body
        )
        return web.Response(
            body=reply.body, status=reply.status, content_type=reply.content_type
        )

    async def handle_events_ws(self, request: web.Request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        self._ws_clients.add(ws)
        try:
            async for msg in ws:
                if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
        finally:
            self._ws_clients.discard(ws)
        return ws

    async def handle_player_tick(self, _request: web.Request) -> web.Response:
        self.session.player.tick()
        return web.json_response({"result": self.session.player.state()})

    # -- remote audio (browser playback) ------------------------------------
    # The reference plays sound through an in-process cpal stream on the
    # user's machine (src-tauri/src/player/stream.rs:501-639); here the
    # user's machine is the browser, so the viewer attaches its AudioContext
    # as the player's output device and pulls the PCM chunks it schedules
    # via Web Audio.  Single listener, latest attach wins (the reference has
    # exactly one output stream too).
    async def handle_player_attach_pcm(self, request: web.Request) -> web.Response:
        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            body = {}
        try:
            cfg = await asyncio.get_event_loop().run_in_executor(
                None,
                lambda: self.session.player.attach_remote_audio(
                    int(body.get("sampleRate", 48000)),
                    int(body.get("channels", 2)),
                ),
            )
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"result": cfg})

    async def handle_player_detach_pcm(self, _request: web.Request) -> web.Response:
        await asyncio.get_event_loop().run_in_executor(
            None, self.session.player.detach_remote_audio
        )
        return web.json_response({"result": None})

    async def handle_player_pcm(self, request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            body = {}
        try:
            chunk = await asyncio.get_event_loop().run_in_executor(
                None,
                lambda: self.session.player.pull_pcm(int(body.get("frames", 4096))),
            )
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.Response(body=chunk, content_type="application/octet-stream")

    async def handle_pending_open_paths(self, _request: web.Request) -> web.Response:
        """One-shot: argv/file-association paths the viewer should open."""
        paths, self.open_paths = self.open_paths, []
        return web.json_response({"result": paths})

    async def handle_metrics(self, _request: web.Request) -> web.Response:
        """Per-stage timing summary (decode, spec recompute/quantize, tile
        encode) — SURVEY §5 tracing deliverable."""
        out = obs.summary()
        warmer = self.session.tm.shape_warmer
        out["shape_warmer"] = {
            "compiled": warmer.compiled_count,
            "idle": warmer._pending is None,
        }
        return web.json_response({"result": out})

    async def handle_profile(self, request: web.Request) -> web.Response:
        """One-shot JAX profiler capture: POST {"durationMs": 1000} ->
        {"result": "<trace dir>"} (open with TensorBoard/XProf)."""
        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            body = {}
        duration = float(body.get("durationMs", 1000.0))
        try:
            path = await asyncio.get_event_loop().run_in_executor(
                None, lambda: obs.profile_trace(duration)
            )
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"result": path})

    def _prune_stale_uploads(self, updir, max_age_s: float = 24 * 3600.0) -> None:
        """Per-upload directories would otherwise accumulate without bound
        (review finding).  Prune old ones, but NEVER a directory whose file
        backs a live track — reload_tracks re-reads from the path."""
        import shutil
        import time as _time

        live = set()
        try:
            for tid in self.session.tracklist.all_ids():
                track = self.session.tracklist.get(tid)
                if track is not None:
                    live.add(track.path.parent)
        except Exception:
            return  # never let cleanup break an upload
        now = _time.time()
        try:
            for sub in updir.iterdir():
                # RESOLVE before the live check: track paths are resolved
                # (symlinked tmpdirs would defeat the protection and a live
                # track's backing file could be deleted — review finding)
                try:
                    resolved = sub.resolve()
                except OSError:
                    continue
                if not sub.is_dir() or resolved in live:
                    continue
                if now - sub.stat().st_mtime > max_age_s:
                    shutil.rmtree(sub, ignore_errors=True)
        except OSError:
            pass

    async def handle_upload(self, request: web.Request) -> web.Response:
        """Accept an uploaded audio file, store it, return its server path."""
        import tempfile
        from pathlib import Path

        reader = await request.multipart()
        field = await reader.next()
        if field is None or field.name != "file":
            return web.json_response({"error": "expected multipart field 'file'"}, status=400)
        filename = Path(field.filename or "upload.bin").name
        updir = Path(tempfile.gettempdir()) / "thesia_tpu_uploads"
        updir.mkdir(exist_ok=True)
        # off the event loop: rmtree of a stale multi-GB upload would stall
        # every concurrent request (review finding)
        await asyncio.get_event_loop().run_in_executor(
            None, self._prune_stale_uploads, updir
        )
        # unique per-upload subdirectory: same-named uploads must not
        # overwrite each other (a track decoding the first file could read
        # half-overwritten bytes — review finding); the original basename
        # is preserved because the UI displays it
        dest = Path(tempfile.mkdtemp(dir=updir)) / filename
        with open(dest, "wb") as f:
            while True:
                chunk = await field.read_chunk()
                if not chunk:
                    break
                f.write(chunk)
        return web.json_response({"result": str(dest)})

    async def handle_list_media(self, request: web.Request) -> web.Response:
        """List audio files in the configured media directories."""
        from pathlib import Path

        exts = {".wav", ".flac", ".mp3", ".m4a", ".aac", ".ogg", ".oga", ".opus"}
        out = []
        for d in self.media_dirs:
            p = Path(d)
            if not p.is_dir():
                continue
            for f in sorted(p.rglob("*")):
                if f.is_file() and (f.suffix.lower() in exts or f.suffix == ""):
                    out.append(str(f))
        return web.json_response({"result": out})

    # -- app ---------------------------------------------------------------
    def make_app(self) -> web.Application:
        app = web.Application(client_max_size=256 * 1024 * 1024)
        app.router.add_post("/api/{command}", self.handle_command)
        app.router.add_get("/events", self.handle_events_ws)
        app.router.add_get("/player/state", self.handle_player_tick)
        app.router.add_post("/player/attach_pcm", self.handle_player_attach_pcm)
        app.router.add_post("/player/detach_pcm", self.handle_player_detach_pcm)
        app.router.add_post("/player/pcm", self.handle_player_pcm)
        app.router.add_get("/debug/metrics", self.handle_metrics)
        app.router.add_post("/debug/profile", self.handle_profile)
        app.router.add_get("/pending_open_paths", self.handle_pending_open_paths)
        app.router.add_post("/upload", self.handle_upload)
        app.router.add_get("/media", self.handle_list_media)
        if self.viewer_dir:
            app.router.add_get("/", self._index)
            app.router.add_static("/", self.viewer_dir, show_index=True)
        return app

    async def _index(self, _request: web.Request) -> web.FileResponse:
        import os

        return web.FileResponse(os.path.join(self.viewer_dir, "index.html"))

    async def _player_loop(self):
        while True:
            await asyncio.sleep(0.02)  # reference tick: 20 ms (player.rs:23)
            try:
                self.session.player.tick()
            except Exception:
                # one bad tick (e.g. an audio backend hiccup) must not kill
                # playback progress and end-of-track events forever
                log.exception("player tick failed")

    def run(self, host: str = "127.0.0.1", port: int = 8707) -> None:
        async def main():
            self._loop = asyncio.get_event_loop()
            runner = web.AppRunner(self.make_app())
            await runner.setup()
            site = web.TCPSite(runner, host, port)
            await site.start()
            print(f"thesia_tpu engine listening on http://{host}:{port}")
            log.info("listening on http://%s:%s", host, port)
            # keep a reference: an unreferenced ensure_future task is
            # eligible for GC (documented asyncio pitfall)
            self._tick_task = asyncio.ensure_future(self._player_loop())
            while True:
                await asyncio.sleep(3600)

        asyncio.run(main())



def main():
    import argparse
    import faulthandler
    import os
    import signal

    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps all stacks
    logging.basicConfig(
        level=os.environ.get("THESIA_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )

    default_viewer = os.path.join(os.path.dirname(os.path.dirname(__file__)), "viewer")
    p = argparse.ArgumentParser(description="thesia_tpu engine service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8707)
    p.add_argument("--viewer-dir", default=default_viewer)
    p.add_argument("--media-dir", action="append", default=[], help="directory listed in the viewer's server-media dropdown")
    p.add_argument(
        "paths", nargs="*",
        help="audio files to open in the first connecting viewer "
        "(== the reference's argv file-association open)",
    )
    args = p.parse_args()
    EngineService(
        viewer_dir=args.viewer_dir, media_dirs=args.media_dir, open_paths=args.paths
    ).run(args.host, args.port)


if __name__ == "__main__":
    main()
