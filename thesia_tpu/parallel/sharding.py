"""Multi-chip sharding of the PRODUCTION batched spectrogram pipeline.

The meaningful parallel axes for this workload (the reference has only rayon
thread-parallelism, SURVEY §2.9; per-(id,ch) fan-out at
reference: src-tauri/src/core/mod.rs:152-163) are:

  * "tracks": (track x channel) rows of the batched STFT — pure data
    parallelism, no collectives.  This is the axis the engine itself shards:
    `SpectrogramAnalyzer.calc_specs_batched` pads its row batch to a multiple
    of the mesh "tracks" size and constrains the batched program's inputs and
    outputs with `active_spec_sharding()`.
  * "time": STFT frame blocks of each row — sequence parallelism.  Frames
    are mutually independent (each DFT/mel GEMM row is one frame), so the
    only cross-shard traffic is the halo of the strided framing (overlapping
    windows at shard edges) and the masked min/max tree — and min/max are
    exactly associative, so time-parallel results are BIT-EXACT vs
    single-device.  This is the load-balancing axis for few-row sessions
    (one long stereo track = 2 rows; rows-only DP would idle n-2 chips).
  * "freq": columns of the DFT matrices and rows of the mel filterbank —
    tensor-parallel GEMMs.  The mel GEMM contracts over the sharded freq
    axis, so GSPMD inserts a psum over the "freq" axis.
    Freq parallelism changes the mel reduction order (sum of partial sums),
    so it is opt-in; the engine default is rows-only sharding, which is
    bit-exact vs single-device.

Everything is expressed with jax.sharding + NamedSharding constraints inside
the one jitted engine program (`dsp.spectrogram._spec_full_multi`); GSPMD
places the collectives.  `set_active_mesh` installs a process-wide mesh that
the engine picks up on the next recompute — no engine code knows about
devices beyond this module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_active_mesh: Mesh | None = None


def make_mesh(
    n_devices: int | None = None, freq_parallel: int = 1, time_parallel: int = 1
) -> Mesh:
    devices = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devices)
    assert n % (freq_parallel * time_parallel) == 0
    return Mesh(
        np.array(devices).reshape(
            n // (freq_parallel * time_parallel), time_parallel, freq_parallel
        ),
        axis_names=("tracks", "time", "freq"),
    )


def set_active_mesh(mesh: Mesh | None) -> None:
    """Install the mesh the engine's batched recompute shards over (None to
    return to single-device execution)."""
    global _active_mesh
    _active_mesh = mesh


def active_mesh() -> Mesh | None:
    return _active_mesh


def auto_mesh(min_devices: int = 2) -> Mesh | None:
    """All-device "tracks" mesh when more than one chip is visible."""
    n = len(jax.devices())
    return make_mesh(n) if n >= min_devices else None


class SpecSharding(NamedTuple):
    """Hashable bundle of shardings for the batched spectrogram program
    (passed as a static arg to the jitted pipeline).

    rows1/rows2/rows3: (C,), (C, L), (C, T, F) arrays sharded over "tracks"
    (rows3 additionally over "time" when time_parallel > 1 — the frames
    axis; sequence parallelism, bit-exact).
    frames: (C, T, win) framing constraint for the time axis (None when
    time-parallel is off; GSPMD materializes each shard's window halo).
    mat/fb: DFT matrices (win, F) / mel filterbank (F, M) sharded over
    "freq" when freq_parallel > 1, else None (replicated).
    """

    rows1: NamedSharding
    rows2: NamedSharding
    rows3: NamedSharding
    frames: NamedSharding | None
    mat: NamedSharding | None
    fb: NamedSharding | None
    n_rows: int  # size of the "tracks" axis (row batches pad to a multiple)
    n_freq: int  # size of the "freq" axis
    n_time: int  # size of the "time" axis


def spec_sharding(
    mesh: Mesh, freq_parallel: bool = False, time_parallel: bool = False
) -> SpecSharding:
    n_rows = mesh.shape["tracks"]
    n_freq = mesh.shape["freq"]
    n_time = mesh.shape["time"]
    use_freq = freq_parallel and n_freq > 1
    use_time = time_parallel and n_time > 1
    t_axis = "time" if use_time else None
    return SpecSharding(
        rows1=NamedSharding(mesh, P("tracks")),
        rows2=NamedSharding(mesh, P("tracks", None)),
        rows3=NamedSharding(mesh, P("tracks", t_axis, None)),
        frames=NamedSharding(mesh, P("tracks", "time", None)) if use_time else None,
        mat=NamedSharding(mesh, P(None, "freq")) if use_freq else None,
        fb=NamedSharding(mesh, P("freq", None)) if use_freq else None,
        n_rows=n_rows,
        n_freq=n_freq,
        n_time=n_time,
    )


def active_spec_sharding() -> SpecSharding | None:
    """The sharding bundle the engine applies to batched recomputes, or None
    when no multi-device mesh is active.  A mesh built with
    make_mesh(freq_parallel=k>1) or make_mesh(time_parallel=m>1) opts those
    axes in here — without this, a freq-parallel mesh replicated the
    DFT/mel operands and half the chips redid identical work (review
    finding)."""
    mesh = _active_mesh
    if mesh is None or mesh.size < 2:
        return None
    return spec_sharding(
        mesh,
        freq_parallel=mesh.shape["freq"] > 1,
        time_parallel=mesh.shape["time"] > 1,
    )


def pad_rows_for(shardings: SpecSharding | None, rows: int) -> int:
    """Row-batch size: next power of two (executable reuse), rounded up to a
    multiple of the mesh "tracks" axis so every shard is equal."""
    c = 1
    while c < rows:
        c *= 2
    if shardings is not None:
        m = shardings.n_rows
        c = max(c, m)
        if c % m:
            c = ((c + m - 1) // m) * m
    return c
