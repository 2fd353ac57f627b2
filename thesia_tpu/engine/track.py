"""AudioTrack + TrackList: decode, per-track normalize/guard state,
sparse id-keyed track storage with max_sec/max_sr bookkeeping.

reference: src-tauri/src/core/track.rs.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
from pathlib import Path

import numpy as np

from ..dynamics.guard import GuardClippingMode
from ..dynamics.normalize import NormalizeTarget, calc_normalize_gain
from ..dsp.framing import SpecSetting, SrWinNfft
from ..io.decode import AudioFormatInfo, open_audio_file
from .audio import Audio
from .utils import unique_filenames

log = logging.getLogger(__name__)


class AudioTrack:
    """reference: track.rs:48-171."""

    def __init__(self, path_str: str, data: bytes | None = None):
        path = Path(path_str).resolve(strict=True)
        wavs, format_info = open_audio_file(path, data)
        self.format_info: AudioFormatInfo = format_info
        self.path = path
        self.original = Audio(wavs, format_info.sr)
        self.audio = self.original

    def reload(self) -> bool:
        """Returns True if content changed. reference: track.rs:75-89."""
        wavs, format_info = open_audio_file(self.path)
        if (
            wavs.shape == self.original.wavs.shape
            and np.array_equal(wavs, self.original.wavs)
            and format_info == self.format_info
        ):
            return False
        self.format_info = format_info
        self.original = Audio(wavs, format_info.sr)
        self.audio = self.original
        return True

    # views
    def channel(self, ch: int) -> np.ndarray:
        return self.audio.channel(ch)

    def channel_for_drawing(self, ch: int):
        return self.audio.channel_for_drawing(ch)

    def interleaved_samples(self) -> np.ndarray:
        return self.audio.interleaved_samples()

    @property
    def sr(self) -> int:
        return self.audio.sr

    @property
    def n_ch(self) -> int:
        return self.audio.n_ch

    @property
    def sec(self) -> float:
        return self.audio.sec

    @property
    def stats(self):
        return self.audio.stats

    def path_string(self) -> str:
        return str(self.path)

    def is_path_same(self, path: str) -> bool:
        try:
            return Path(path).resolve(strict=True) == self.path
        except OSError:
            return False

    def guard_clipping_gain(self):
        return self.audio.guard_clipping_gain()

    def format_guard_clip_stats(self, mode: GuardClippingMode):
        return self.audio.format_guard_clip_stats(mode)

    def device_scalar_gain(self) -> float | None:
        """Scalar g such that audio.wavs == float32(g) * original.wavs
        BITWISE — i.e. the applied gain when guard clipping was a no-op
        (no sample exceeded +/-1, so Clip clamped nothing, ReduceGlobalLevel
        kept gain 1, the Limiter sequence is all-ones).  The spec path then
        uploads the ORIGINAL samples once and applies g on device, so
        normalize/guard changes never re-transfer.  None when the guard
        modified samples (clamps, f64 global reduce, limiter gains)."""
        if self.audio is self.original:
            return 1.0
        g = getattr(self.audio, "applied_scalar_gain", None)
        if g is None:
            return None
        if any(s.max_reduction_gain_db != 0.0 for s in self.audio.guard_clip_stats):
            return None
        return float(g)

    # normalize (gain always computed from ORIGINAL stats,
    # reference: track.rs:152-170)
    def normalize(self, target: NormalizeTarget, guard_clipping_mode: GuardClippingMode):
        gain = calc_normalize_gain(target, self.original.stats)
        self.apply_gain(gain, guard_clipping_mode)

    def apply_gain(
        self, gain: float, guard_clipping_mode: GuardClippingMode, gain_seq=None,
        gained: np.ndarray | None = None,
    ):
        """gained: the already-computed float32(gain) * original array, when
        the caller built it for a peak test (the batched limiter path) —
        recomputing it doubled full-array work on GB-scale tracks."""
        if not np.isfinite(gain) or gain == 1.0:
            self.audio = self.original
            return
        original_wavs = self.original.wavs
        mutated = Audio.__new__(Audio)
        mutated.wavs = original_wavs
        mutated.sr = self.original.sr
        mutated.stats = self.original.stats
        mutated.guard_clip_result = self.original.guard_clip_result
        mutated.guard_clip_stats = list(self.original.guard_clip_stats)
        mutated.mutate(
            (lambda wavs: gained)
            if gained is not None
            else (lambda wavs: (np.float32(gain) * original_wavs)
                  .astype(np.float32, copy=False)),  # f32*f32 is already f32
            guard_clipping_mode,
            gain_seq=gain_seq,
        )
        mutated.applied_scalar_gain = float(gain)  # for device_scalar_gain
        self.audio = mutated


class TrackList:
    """reference: track.rs:189-437."""

    def __init__(self):
        self.max_sec = 0.0
        self.common_normalize = NormalizeTarget()
        self.common_guard_clipping = GuardClippingMode.ReduceGlobalLevel
        self._tracks: dict[int, AudioTrack] = {}
        self._filenames: dict[int, str] = {}
        self._id_max_sec = 0

    def add_tracks(
        self, id_list: list[int], path_list: list[str], preread=None
    ) -> list[int]:
        """Parallel decode; failed paths are silently skipped (caller diffs
        ids to find errors). reference: track.rs:211-239.

        preread: optional {track_id: Future[bytes]} from the session's
        big-WAV prefetch — the decoder then shares that single file read
        instead of re-reading GB-scale files."""

        def load(args):
            track_id, path = args
            data = None
            fut = (preread or {}).get(track_id)
            if fut is not None:
                try:
                    data = fut.result()
                except Exception:
                    data = None  # decode does its own read (and error path)
            try:
                from ..obs import span

                with span("decode"):
                    return (track_id, AudioTrack(path, data))
            except Exception:
                return None

        if len(id_list) > 1 and (os.cpu_count() or 1) > 1:
            with concurrent.futures.ThreadPoolExecutor() as pool:
                results = list(pool.map(load, zip(id_list, path_list)))
        else:
            results = [load(x) for x in zip(id_list, path_list)]

        loaded = [res for res in results if res is not None]
        self._precompute_stats([track for _tid, track in loaded])
        self._normalize_tracks([track for _tid, track in loaded])
        added_ids = []
        for track_id, track in loaded:
            if track.sec > self.max_sec:
                self.max_sec = track.sec
                self._id_max_sec = track_id
            self._tracks[track_id] = track
            added_ids.append(track_id)
        self._update_filenames()
        return added_ids

    def reload_tracks(self, id_list: list[int]) -> tuple[list[int], list[int]]:
        """(reloaded_ids, no_err_ids). reference: track.rs:241-276."""
        reloaded, no_err = [], []
        for track_id in id_list:
            track = self._tracks.get(track_id)
            if track is None:
                raise KeyError(f"[reload_tracks] Wrong Track ID {track_id}")
            try:
                changed = track.reload()
            except Exception:
                continue
            if changed:
                track.normalize(self.common_normalize, self.common_guard_clipping)
                if track.sec > self.max_sec:
                    self.max_sec = track.sec
                    self._id_max_sec = track_id
                reloaded.append(track_id)
            no_err.append(track_id)
        return reloaded, no_err

    def remove_tracks(self, id_list: list[int]) -> list[tuple[int, int]]:
        removed_id_ch = []
        need_update_max_sec = False
        for track_id in id_list:
            track = self._tracks.pop(track_id, None)
            if track is None:
                continue
            removed_id_ch.extend((track_id, ch) for ch in range(track.n_ch))
            if track_id == self._id_max_sec:
                need_update_max_sec = True
        if need_update_max_sec:
            best = (0, 0.0)
            for track_id, track in self._tracks.items():
                if track.sec > best[1]:
                    best = (track_id, track.sec)
            self._id_max_sec, self.max_sec = best
        self._update_filenames()
        return removed_id_ch

    def set_common_normalize(self, target: NormalizeTarget) -> None:
        old = self.common_normalize
        self.common_normalize = target
        self._apply_or_rollback(lambda: setattr(self, "common_normalize", old))

    def set_common_guard_clipping(self, mode: GuardClippingMode) -> None:
        old = self.common_guard_clipping
        self.common_guard_clipping = mode
        self._apply_or_rollback(lambda: setattr(self, "common_guard_clipping", old))

    def _apply_or_rollback(self, restore) -> None:
        """A failure mid-apply (some tracks re-gained, others not) must not
        leave the mode attribute claiming the new state — restore it and
        best-effort re-apply the old so every track lands consistent
        (review finding)."""
        try:
            self._apply_normalize_guard_clipping()
        except Exception:
            restore()
            try:
                self._apply_normalize_guard_clipping()
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "rollback re-apply after failed normalize/guard switch"
                )
            raise

    def _apply_normalize_guard_clipping(self) -> None:
        self._normalize_tracks(list(self._tracks.values()))

    def _precompute_stats(self, tracks: list[AudioTrack]) -> None:
        """Inject batched device-computed stats (one program per (sr, n_ch,
        bucket) group) before normalize reads them; host thread-pool fallback
        mirrors the reference's rayon-parallel stats (track.rs:211-221)."""
        tracks = [t for t in tracks if t.original._stats is None]
        if len(tracks) < 2:
            return
        from ..dynamics import stats_device
        from ..obs import span

        items = [(i, t.original.wavs, t.sr) for i, t in enumerate(tracks)]
        stats = None
        if stats_device.device_dynamics_preferred():
            try:
                with span("stats.batched"):
                    stats = stats_device.calc_stats_batched(items)
            except Exception:
                log.warning("device stats failed; using the host path", exc_info=True)
        if stats is not None:
            for i, t in enumerate(tracks):
                t.original.stats = stats[i]
            return
        with concurrent.futures.ThreadPoolExecutor() as pool:
            # touching .stats computes + caches them, rayon-style in parallel
            list(pool.map(lambda t: t.original.stats, tracks))

    def _normalize_tracks(self, tracks: list[AudioTrack]) -> None:
        """Common normalize + guard clipping over a set of tracks.

        Limiter mode batches every engaging track's gain-sequence compute
        into one device program per (sr, bucket) group
        (dynamics.stats_device); other modes (and f64-less backends) take
        the per-track path.  reference: track.rs:152-170 + mod.rs loop."""
        from ..obs import span

        mode = self.common_guard_clipping
        target = self.common_normalize
        if mode is not GuardClippingMode.Limiter or len(tracks) < 2:
            with span("normalize"):
                for track in tracks:
                    track.normalize(target, mode)
            return
        with span("normalize"):
            self._normalize_tracks_limiter_batched(tracks, target, mode)

    def _normalize_tracks_limiter_batched(self, tracks, target, mode) -> None:
        plan: list[tuple[AudioTrack, float, np.ndarray]] = []
        for track in tracks:
            gain = calc_normalize_gain(target, track.original.stats)
            if not np.isfinite(gain) or gain == 1.0:
                track.apply_gain(gain, mode)
                continue
            # copy=False: the product is already f32; the default astype copied a
            # second full-size array (GB-scale transient; review finding)
            gained = (np.float32(gain) * track.original.wavs).astype(
                np.float32, copy=False
            )
            peak = float(np.abs(gained).max()) if gained.size else 0.0
            if peak > 1.0:
                plan.append((track, gain, gained))
            else:
                # non-clipping (the common case): reuse the peak-test
                # product instead of rebuilding it inside apply_gain, and
                # apply NOW so only one track's f32 copy is alive at a time
                # (review finding — GB-scale sessions)
                track.apply_gain(gain, mode, gained=gained)
                del gained
        gains = None
        from ..dynamics import stats_device

        if plan and stats_device.device_dynamics_preferred():
            try:
                gains = stats_device.limiter_gain_seqs_batched(
                    [(i, g, t.sr) for i, (t, _gain, g) in enumerate(plan)]
                )
            except Exception:
                log.warning("device limiter failed; using the native path", exc_info=True)
        if gains is not None:
            for i in range(len(plan)):
                track, gain, gained = plan[i]
                plan[i] = None  # release the f32 copy as soon as consumed
                track.apply_gain(gain, mode, gain_seq=gains[i], gained=gained)
        elif plan:
            # streaming-native fallback, thread-parallel (ctypes drops the GIL)
            with concurrent.futures.ThreadPoolExecutor() as pool:
                list(
                    pool.map(
                        lambda item: item[0].apply_gain(
                            item[1], mode, gained=item[2]
                        ),
                        plan,
                    )
                )

    # -- queries -----------------------------------------------------------
    def all_ids(self) -> list[int]:
        return sorted(self._tracks)

    def id_ch_tuples(self) -> list[tuple[int, int]]:
        return self.id_ch_tuples_from(self.all_ids())

    def id_ch_tuples_from(self, id_list) -> list[tuple[int, int]]:
        out = []
        for track_id in id_list:
            track = self._tracks.get(track_id)
            if track is not None:
                out.extend((track_id, ch) for ch in range(track.n_ch))
        return out

    def max_sr(self) -> int:
        return max((t.sr for t in self._tracks.values()), default=0)

    def construct_sr_win_nfft_set(self, ids, setting: SpecSetting) -> set[SrWinNfft]:
        return {setting.calc_sr_win_nfft(self[track_id].sr) for track_id in ids}

    def construct_all_sr_win_nfft_set(self, setting: SpecSetting) -> set[SrWinNfft]:
        return self.construct_sr_win_nfft_set(self.all_ids(), setting)

    @property
    def is_empty(self) -> bool:
        return not self._tracks

    def has(self, track_id: int) -> bool:
        return track_id in self._tracks

    def get(self, track_id: int) -> AudioTrack | None:
        return self._tracks.get(track_id)

    def __getitem__(self, track_id: int) -> AudioTrack:
        return self._tracks[track_id]

    def find_id_by_path(self, path: str) -> int | None:
        for track_id in sorted(self._tracks):
            if self._tracks[track_id].is_path_same(path):
                return track_id
        return None

    def filename(self, track_id: int) -> str:
        return self._filenames.get(track_id, "")

    def _update_filenames(self) -> None:
        self._filenames = unique_filenames(
            {track_id: str(t.path) for track_id, t in self._tracks.items()}
        )
