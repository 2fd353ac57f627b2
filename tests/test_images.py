"""SpecImageStore: device-resident images, background streaming, interim
region-served tiles (VERDICT r2 #1/#2/#9 surface)."""

import threading
import time

import numpy as np
import pytest

from thesia_tpu.engine.manager import TrackManager
from thesia_tpu.engine.track import TrackList
from thesia_tpu.io.wav import encode_wav_f32
from thesia_tpu.render.colormap import default_colormap_rgba8
from thesia_tpu.render.tiles import spectrogram_tile_header


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    td = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(11)
    paths = []
    for i, (sr, c, sec) in enumerate([(8000, 2, 30.0), (16000, 1, 10.0)]):
        w = rng.uniform(-0.8, 0.8, (c, int(sr * sec))).astype(np.float32)
        p = td / f"t{i}.wav"
        p.write_bytes(encode_wav_f32(w, sr))
        paths.append(str(p))
    tl = TrackList()
    tm = TrackManager()
    ids = tl.add_tracks(list(range(len(paths))), paths)
    tm.add_tracks(tl, ids)
    tm.apply_track_list_changes(tl)
    return tl, tm


def test_geometry_known_before_landing(engine):
    _tl, tm = engine
    geo = tm.images.geometry(0)
    assert geo is not None
    h, w = geo
    assert h > 0 and w > 0
    tm.images.drain()
    img = tm.images.host_image(0, 0)
    assert img is not None and img.shape == (h, w)


def test_streamed_image_matches_device(engine):
    """Host bytes after streaming == direct full d2h of the device image."""
    _tl, tm = engine
    tm.images.drain()
    img = tm.images.host_image(0, 1)
    assert img is not None and img.dtype == np.uint16
    assert not tm.images.is_computing(0)


def test_interim_region_tile_equals_final_tile(engine):
    """A tile served from a device-region fetch (before the host image
    lands) must be byte-identical to the tile served after landing."""
    tl, tm = engine
    cm = default_colormap_rgba8()
    # force a fresh quantize so the store re-enters the streaming state
    tm.set_db_range(tl, 90.0)
    interim = {}
    for args in [(0, 0, 0, 0), (1, 0, 0, 0), (3, 1, 0, 0), (2, 0, 1, 0)]:
        interim[args] = tm.images.tile_body(0, 0, cm, *args)
    tm.images.drain()
    for args, body in interim.items():
        assert body is not None
        final = tm.images.tile_body(0, 0, cm, *args)
        assert body == final, f"interim != final for {args}"
    tm.set_db_range(tl, 100.0)
    tm.images.drain()


def test_tile_header_and_empty_tiles(engine):
    _tl, tm = engine
    tm.images.drain()
    cm = default_colormap_rgba8()
    h, w = tm.images.geometry(0)
    # out-of-range tile -> empty body, zero-size header
    body = tm.images.tile_body(0, 0, cm, 0, 0, 10**6, 0)
    assert body == b""
    hdr = spectrogram_tile_header(7, h, w, 0, 0, 10**6, 0)
    assert len(hdr) == 40
    # bad channel -> None
    assert tm.images.tile_body(0, 99, cm, 0, 0, 0, 0) is None
    # unknown track -> None
    assert tm.images.tile_body(42, 0, cm, 0, 0, 0, 0) is None


def test_remove_mid_stream_is_safe(engine):
    tl, tm = engine
    tm.set_db_range(tl, 80.0)  # re-queue streaming
    tm.images.remove(1)
    assert tm.images.geometry(1) is None
    tm.images.drain()
    assert tm.images.host_image(1, 0) is None
    # re-add via full requantize
    tm.update_all_specs_imgs(tl)
    tm.images.drain()
    assert tm.images.host_image(1, 0) is not None
    tm.set_db_range(tl, 100.0)
    tm.images.drain()


def test_concurrent_tiles_during_stream(engine):
    """Tile fetches from several threads while the streamer runs: no
    exceptions, all bodies equal the settled result."""
    tl, tm = engine
    cm = default_colormap_rgba8()
    tm.set_db_range(tl, 95.0)
    results = {}
    errors = []

    def fetch(tid, args):
        try:
            results[(tid, args)] = tm.images.tile_body(tid, 0, cm, *args)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [
        threading.Thread(target=fetch, args=(tid, args))
        for tid in (0, 1)
        for args in [(0, 0, 0, 0), (2, 1, 0, 0), (4, 0, 0, 0)]
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    tm.images.drain()
    for (tid, args), body in results.items():
        assert body == tm.images.tile_body(tid, 0, cm, *args)
    tm.set_db_range(tl, 100.0)
    tm.images.drain()


def test_set_images_replace_mid_stream_streams_replacement(monkeypatch):
    """set_images skips re-queueing ids already in the queue; if the worker
    had already captured the OLD entry for that id, it must NOT pop the id
    after aborting — the replacement has to stream (found via a dryrun
    sequence where a track's image silently never landed)."""
    import threading

    import jax.numpy as jnp

    from thesia_tpu.engine.images import SpecImageStore, TrackImages

    def make(seed):
        img = jnp.asarray(
            (np.random.default_rng(seed).integers(1, 65535, (1, 8, 32))).astype(np.uint16)
        )
        return TrackImages(0, 1, 32, 8, img, {})

    t_old, t_new = make(1), make(2)
    store = SpecImageStore()
    entered = threading.Event()
    block = threading.Event()
    orig = SpecImageStore._stream_one

    def slow(self, t):
        entered.set()
        assert block.wait(10)
        return orig(self, t)

    monkeypatch.setattr(SpecImageStore, "_stream_one", slow)
    store.set_images(0, t_old)
    assert entered.wait(10)  # worker captured t_old
    store.set_images(0, t_new)  # replacement; id 0 already queued
    block.set()
    assert store.drain(timeout=30)
    assert t_old.dropped and not t_old.complete
    assert t_new.complete  # the replacement streamed
    assert store.host_image(0, 0) is not None
    store.shutdown()


def test_store_churn_every_live_entry_lands():
    """Randomized lifecycle stress: concurrent set_images / remove churn
    against the streamer must leave EVERY live entry complete after
    quiescence — the invariant the replace-race fixes protect (an entry
    stranded incomplete means isComputing never clears for that track)."""
    import threading

    import jax.numpy as jnp

    from thesia_tpu.engine.images import SpecImageStore, TrackImages

    store = SpecImageStore()

    def make(tid, seed):
        img = jnp.asarray(
            np.random.default_rng(seed).integers(1, 65535, (1, 16, 64)).astype(np.uint16)
        )
        return TrackImages(tid, 1, 64, 16, img, {})

    stop = threading.Event()

    def churn(tid):
        rng = np.random.default_rng(100 + tid)  # per-thread: rngs aren't thread-safe
        seed = tid * 10_000
        while not stop.is_set():
            op = rng.integers(0, 10)
            seed += 1
            if op < 7:
                store.set_images(tid, make(tid, seed))
            elif op < 9:
                store.remove(tid)
            else:
                store.drain(timeout=5)

    threads = [threading.Thread(target=churn, args=(tid,)) for tid in range(4)]
    for th in threads:
        th.start()
    import time

    time.sleep(1.5)
    stop.set()
    for th in threads:
        th.join(timeout=10)
    assert store.drain(timeout=30), "streamer failed to quiesce"
    with store._lock:
        live = dict(store._tracks)
    for tid, t in live.items():
        assert t.complete and not t.dropped, f"track {tid} stranded incomplete"
        assert store.host_image(tid, 0) is not None
    store.shutdown()


def test_interim_parity_covers_device_mips(tmp_path):
    """Deep-LOD parity through the DEVICE mip / host-mip branches (review
    finding: the module fixture's tracks are too short for chain_len >=
    DEVICE_MIP_FROM, leaving the core coarse-LOD byte-parity mechanism
    untested).  A ~90 s track has n_frames ~9000 -> chain levels 3+."""
    from thesia_tpu.engine.images import DEVICE_MIP_FROM, mip_plan
    from thesia_tpu.render.mips import chain_len

    rng = np.random.default_rng(17)
    sr, sec = 8000, 90.0
    w = rng.uniform(-0.8, 0.8, (1, int(sr * sec))).astype(np.float32)
    p = tmp_path / "long.wav"
    p.write_bytes(encode_wav_f32(w, sr))
    tl = TrackList()
    tm = TrackManager()
    tm.add_tracks(tl, tl.add_tracks([0], [str(p)]))
    tm.apply_track_list_changes(tl)
    _h, n_frames = tm.images.geometry(0)
    assert chain_len(n_frames) >= DEVICE_MIP_FROM, "fixture too short"
    assert mip_plan(n_frames)  # device mips exist
    cm = default_colormap_rgba8()
    # fresh quantize -> streaming state; fetch every LOD level while the
    # stream is in flight (device mips + host deepest mip + region paths)
    tm.set_db_range(tl, 90.0)
    with tm.images._lock:
        t = tm.images._tracks[0]
    assert t.dev_mips, "device mips not built"
    interim = {}
    max_lx = (n_frames // 512).bit_length() + 1
    for lx in range(0, max_lx + 1):
        interim[lx] = tm.images.tile_body(0, 0, cm, lx, 0, 0, 0)
    tm.images.drain()
    for lx, body in interim.items():
        assert body is not None, lx
        final = tm.images.tile_body(0, 0, cm, lx, 0, 0, 0)
        assert body == final, f"interim != final at levelX={lx}"


# ---------------------------------------------------------------------------
# Viewport-priority streaming (VERDICT r3 weak #2): tile requests for
# not-yet-landed regions pull that region (and its track) to the front of
# the stream work; landed intervals make out-of-order progress resumable.


def test_landed_interval_bookkeeping():
    import jax.numpy as jnp

    from thesia_tpu.engine.images import TrackImages

    t = TrackImages(0, 1, 100, 4, jnp.zeros((1, 4, 100), jnp.uint16), {})
    t._merge_landed(10, 20)
    t._merge_landed(30, 40)
    assert t.covers(12, 18) and not t.covers(5, 12) and not t.covers(15, 35)
    t._merge_landed(0, 10)
    assert t.landed[0] == [0, 20]
    t._merge_landed(18, 32)  # bridges the gap
    assert t.landed == [[0, 40]]
    assert t.next_gap(1000) == (40, 100)
    assert t.next_gap(25) == (40, 65)
    t._merge_landed(40, 100)
    assert t.next_gap(1000) is None and t.covers(0, 100)


class _SliceLogger:
    """dev_img stand-in that records the (x0, x1) spans the streamer pulls."""

    def __init__(self, arr):
        self.arr = arr
        self.spans = []

    def __getitem__(self, key):
        ch, rows, cols = key
        if isinstance(cols, slice):
            self.spans.append((cols.start or 0, cols.stop))
        return self.arr[key]

    @property
    def shape(self):
        return self.arr.shape


def test_stream_hint_pulls_region_forward(monkeypatch):
    import jax.numpy as jnp

    from thesia_tpu.engine import images as I

    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 8)  # 1024-col chunks
    h, n = 4, 8192
    data = np.random.default_rng(3).integers(1, 65535, (1, h, n)).astype(np.uint16)
    logger = _SliceLogger(jnp.asarray(data))
    t = I.TrackImages(0, 1, n, h, logger, {})
    t.stream_hint = (5120, 6144)  # viewport asked for this region
    store = I.SpecImageStore()
    store.set_images(0, t)
    assert store.drain(timeout=30)
    assert t.complete
    # the hinted region streamed FIRST, then the loop swept the gaps
    assert logger.spans[0] == (5120, 6144), logger.spans[:3]
    # every byte landed exactly once and matches the device image
    np.testing.assert_array_equal(np.asarray(store.host_image(0, 0)), data[0])
    total = sum(b - a for a, b in logger.spans)
    assert total == n  # no column fetched twice by the streamer
    store.shutdown()


def test_stream_hint_skips_already_landed_columns(monkeypatch):
    """A wider hint arriving after a region already landed must not
    re-fetch the landed columns: the hint chunk is capped at the next
    landed interval like the non-hint sweep (review finding — up to a
    full chunk of duplicate d2h per occurrence)."""
    import jax.numpy as jnp

    from thesia_tpu.engine import images as I

    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 32)  # 4096-col chunks
    h, n = 4, 16384
    data = np.random.default_rng(5).integers(1, 65535, (1, h, n)).astype(np.uint16)
    logger = _SliceLogger(jnp.asarray(data))
    t = I.TrackImages(0, 1, n, h, logger, {})
    t.stream_hint = (5120, 6144)
    store = I.SpecImageStore()
    gate = threading.Event()
    entered = threading.Event()
    first = [True]
    orig_yield = I.SpecImageStore._yield_to_interactive

    def gated_yield(self):
        if first[0]:
            first[0] = False
            entered.set()
            assert gate.wait(10)
        orig_yield(self)

    monkeypatch.setattr(I.SpecImageStore, "_yield_to_interactive", gated_yield)
    store.set_images(0, t)
    assert entered.wait(10)  # the hinted (5120, 6144) chunk is streaming
    with store._lock:
        # the viewer now wants a WIDER region spanning the landing hole
        t.stream_hint = (4096, 12288)
    gate.set()
    assert store.drain(timeout=30)
    assert t.complete
    np.testing.assert_array_equal(np.asarray(store.host_image(0, 0)), data[0])
    total = sum(b - a for a, b in logger.spans)
    assert total == n, f"columns double-fetched: {logger.spans}"


def test_tile_request_prioritizes_track_and_region(monkeypatch):
    """A tile request on a QUEUED (not yet streaming) track moves it to the
    stream-queue front and records its region hint; the blocked head track
    yields, the prioritized track streams first, and the head resumes to
    completion afterwards."""
    import jax.numpy as jnp

    from thesia_tpu.engine import images as I
    from thesia_tpu.render.colormap import default_colormap_rgba8

    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 8)
    h, n = 4, 8192
    rng = np.random.default_rng(4)
    data_a = rng.integers(1, 65535, (1, h, n)).astype(np.uint16)
    data_b = rng.integers(1, 65535, (1, h, n)).astype(np.uint16)
    t_a = I.TrackImages(0, 1, n, h, jnp.asarray(data_a), {})
    t_b = I.TrackImages(1, 1, n, h, jnp.asarray(data_b), {})
    store = I.SpecImageStore()

    gate = threading.Event()
    entered = threading.Event()
    orig_yield = I.SpecImageStore._yield_to_interactive

    def gated_yield(self):
        entered.set()
        assert gate.wait(10)
        orig_yield(self)

    monkeypatch.setattr(I.SpecImageStore, "_yield_to_interactive", gated_yield)
    store.set_images(0, t_a)
    assert entered.wait(10)  # A is mid-stream (blocked at the gate)
    store.set_images(1, t_b)

    cm = default_colormap_rgba8()
    # request a tile on B: level 1 -> full-res region fetch + priority
    fetch_thread = threading.Thread(
        target=lambda: store.tile_body(1, 0, cm, 1, 0, 3, 0), daemon=True
    )
    fetch_thread.start()
    t0 = time.time()
    while t_b.stream_hint is None and time.time() - t0 < 10:
        time.sleep(0.01)
    assert t_b.stream_hint is not None
    with store._lock:
        assert store._queue[0] == 1  # B pulled to the front
    gate.set()
    fetch_thread.join(timeout=10)
    assert store.drain(timeout=30)
    assert t_a.complete and t_b.complete  # A resumed after yielding
    np.testing.assert_array_equal(np.asarray(store.host_image(0, 0)), data_a[0])
    np.testing.assert_array_equal(np.asarray(store.host_image(1, 0)), data_b[0])
    store.shutdown()


def test_priority_landed_region_serves_byte_identical(monkeypatch):
    """Interim tiles across all three serving paths — direct device fetch,
    landed-interval host serve, settled host image — are byte-identical."""
    import jax.numpy as jnp

    from thesia_tpu.engine import images as I
    from thesia_tpu.render.colormap import default_colormap_rgba8

    monkeypatch.setattr(I, "STREAM_CHUNK_BYTES", 1024 * 8)
    h, n = 4, 8192
    data = np.random.default_rng(5).integers(1, 65535, (1, h, n)).astype(np.uint16)
    t = I.TrackImages(0, 1, n, h, jnp.asarray(data), {})
    store = I.SpecImageStore()

    hold = threading.Event()
    entered = threading.Event()
    orig_yield = I.SpecImageStore._yield_to_interactive

    def gated_yield(self):
        entered.set()
        assert hold.wait(10)
        orig_yield(self)

    monkeypatch.setattr(I.SpecImageStore, "_yield_to_interactive", gated_yield)
    store.set_images(0, t)
    assert entered.wait(10)
    cm = default_colormap_rgba8()
    args = (0, 0, cm, 1, 0, 3, 0)  # level (1,0) tile 3: cols 3072..3640ish
    from_device = store.tile_body(*args)  # direct fetch + hint
    assert t.stream_hint is not None
    hold.set()
    # wait until the hinted region lands, then serve from the interval
    t0 = time.time()
    while time.time() - t0 < 10:
        with store._lock:
            if t.stream_hint is None or t.covers(*t.stream_hint):
                break
        time.sleep(0.01)
    from_interval = store.tile_body(*args)
    assert store.drain(timeout=30)
    from_settled = store.tile_body(*args)
    assert from_device == from_interval == from_settled
    store.shutdown()
