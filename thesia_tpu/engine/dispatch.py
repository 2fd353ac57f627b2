"""Transport-free command dispatch: the code behind POST /api/<command>.

The command tables, argument validation, the read/write locking around each
call, and the encoding of results as JSON or binary bodies.  Imports no HTTP
library: the aiohttp front (engine/service.py) and in-process drivers share
this one path (reference: src-tauri/src/lib.rs:759-816 command registry).
"""

from __future__ import annotations

import dataclasses
import json
import logging

import numpy as np

from .axis_api import AXIS_COMMANDS, AxisApi

log = logging.getLogger(__name__)

BINARY_COMMANDS = {"get_waveform_tile", "get_spectrogram_tile"}

# commands that mutate engine state — they serialize through the session's
# write worker under the exclusive lock; everything else runs under the
# shared read lock (reference: RwLock'd globals, lib.rs:36-42)
WRITE_COMMANDS = {
    "init", "set_user_settings", "set_open_files_dialog_path",
    "add_tracks", "reload_tracks", "remove_tracks", "apply_track_list_changes",
    "set_dB_range", "set_spec_setting", "set_common_guard_clipping",
    "set_common_normalize",
}

# command name -> (method name, [arg names in order])
COMMANDS = {
    "is_dev": ("is_dev", []),
    "init": ("init", ["colormapRgba"]),
    "set_user_settings": ("set_user_settings", ["userSettings"]),
    "get_open_files_dialog_path": ("get_open_files_dialog_path", []),
    "set_open_files_dialog_path": ("set_open_files_dialog_path", ["path"]),
    "add_tracks": ("add_tracks", ["trackIds", "paths"]),
    "reload_tracks": ("reload_tracks", ["trackIds"]),
    "remove_tracks": ("remove_tracks", ["trackIds"]),
    "apply_track_list_changes": ("apply_track_list_changes", []),
    "find_id_by_path": ("find_id_by_path", ["path"]),
    "get_dB_range": ("get_db_range", []),
    "set_dB_range": ("set_db_range", ["dBRange"]),
    "get_spec_setting": ("get_spec_setting", []),
    "set_spec_setting": ("set_spec_setting", ["specSetting"]),
    "get_common_guard_clipping": ("get_common_guard_clipping", []),
    "set_common_guard_clipping": ("set_common_guard_clipping", ["mode"]),
    "get_common_normalize": ("get_common_normalize", []),
    "set_common_normalize": ("set_common_normalize", ["target"]),
    "get_audio_render_metadata": ("get_audio_render_metadata", ["idChStr"]),
    "get_waveform_tile": ("get_waveform_tile", ["idChStr", "level", "tileIndex"]),
    "get_spectrogram_tile": (
        "get_spectrogram_tile",
        ["idChStr", "levelX", "levelY", "tileX", "tileY"],
    ),
    "get_limiter_gain": ("get_limiter_gain", ["trackId"]),
    "get_max_dB": ("get_max_db", []),
    "get_min_dB": ("get_min_db", []),
    "get_max_track_hz": ("get_max_track_hz", []),
    "get_longest_track_length_sec": ("get_longest_track_length_sec", []),
    "get_channel_counts": ("get_channel_counts", ["trackId"]),
    "get_length_sec": ("get_length_sec", ["trackId"]),
    "get_sample_rate": ("get_sample_rate", ["trackId"]),
    "get_format_info": ("get_format_info", ["trackId"]),
    "get_global_lufs": ("get_global_lufs", ["trackId"]),
    "get_rms_dB": ("get_rms_db", ["trackId"]),
    "get_max_peak_dB": ("get_max_peak_db", ["trackId"]),
    "get_guard_clip_stats": ("get_guard_clip_stats", ["trackId"]),
    "get_path": ("get_path", ["trackId"]),
    "get_file_name": ("get_file_name", ["trackId"]),
    "set_volume_dB": ("set_volume_db", ["volumeDB"]),
    "set_track_player": ("set_track_player", ["trackId", "sec"]),
    "seek_player": ("seek_player", ["sec"]),
    "pause_player": ("pause_player", []),
    "resume_player": ("resume_player", []),
}

OPTIONAL_ARGS = {"sec"}


class MiscApi:
    """Viewer-support commands that exist client-side in the reference."""

    def get_default_colormap(self) -> list:
        from ..render.colormap import default_colormap_rgba8

        return default_colormap_rgba8().reshape(-1).tolist()


MISC_COMMANDS = {"get_default_colormap": ("get_default_colormap", [])}


@dataclasses.dataclass(frozen=True)
class Reply:
    """An encoded command result: HTTP-style status, content type, body."""

    status: int
    content_type: str
    body: bytes

    def json(self):
        return json.loads(self.body)


def json_reply(payload, status: int = 200) -> Reply:
    return Reply(status, "application/json", json.dumps(payload).encode())


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x


class Dispatcher:
    """Runs one command against a session, returning an encoded Reply.

    Blocking: a server calls dispatch() from a worker thread."""

    def __init__(self, session):
        self.session = session
        self.axis = AxisApi()
        self.misc = MiscApi()
        self._tables = (
            (COMMANDS, session), (AXIS_COMMANDS, self.axis), (MISC_COMMANDS, self.misc)
        )

    def dispatch(self, name: str, body) -> Reply:
        """body: the decoded JSON request object ({} when absent)."""
        for table, target in self._tables:
            if name in table:
                method_name, arg_names = table[name]
                break
        else:
            return json_reply({"error": f"unknown command {name}"}, 404)
        if not isinstance(body, dict):
            return json_reply({"error": "request body must be a JSON object"}, 400)
        args = []
        for a in arg_names:
            if a in body:
                args.append(body[a])
            elif a in OPTIONAL_ARGS:
                args.append(None)
            else:
                return json_reply({"error": f"missing argument {a} for {name}"}, 400)
        method = getattr(target, method_name)
        try:
            if target is self.session and name not in WRITE_COMMANDS:
                # concurrent reads hold the shared lock so they never observe
                # a half-applied mutation from the write worker
                with self.session.rw.read():
                    result = method(*args)
            else:
                result = method(*args)
        except (KeyError, ValueError, AssertionError) as e:
            return json_reply({"error": str(e)}, 400)
        except (TypeError, AttributeError) as e:
            # wrong-typed args (string where float expected, int idChStr, …)
            # surface from deep in the command body — client errors, not 500s.
            # But the same exception types also flag REAL server defects
            # (a race leaving track=None then track.sr), so keep the full
            # traceback in the server log: the 400 contract must not hide
            # engine bugs from operators (review finding)
            log.warning("%s mapped to 400: %r", name, e, exc_info=True)
            return json_reply({"error": f"invalid argument: {e}"}, 400)
        if name in BINARY_COMMANDS:
            return Reply(200, "application/octet-stream", result)
        return json_reply({"result": _jsonable(result)})
