"""RIFF/WAVE decoder -> planar float32 (n_ch, n_samples).

Sample conversion follows the reference decode convention (symphonia):
s16 -> x / 32768 (golden: first nonzero samples of sample_48k.wav are
-3.0517578e-5 = -1/32768, reference: src-tauri/src/core/audio.rs:466-512).

Supports PCM u8/s16/s24/s32, IEEE float 32/64, and WAVE_FORMAT_EXTENSIBLE.
"""

from __future__ import annotations

import struct

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavError(ValueError):
    pass


def s24_bytes_to_f32(raw: np.ndarray) -> np.ndarray:
    """Packed little-endian 24-bit bytes (n*3,) u8 -> (n,) f32 in [-1, 1).
    Shared by the decode fallback and the device-prefetch probe so the two
    host conversions can never drift apart."""
    raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
    as32 = (
        raw[:, 0].astype(np.uint32)
        | (raw[:, 1].astype(np.uint32) << 8)
        | (raw[:, 2].astype(np.uint32) << 16)
    ).astype(np.int32)
    as32 = (as32 << 8) >> 8  # sign-extend 24 -> 32
    return as32.astype(np.float32) / 8388608.0


def _codec_name(fmt: int, bits: int) -> str:
    if fmt == WAVE_FORMAT_IEEE_FLOAT:
        return f"pcm_f{bits}le"
    if bits == 8:
        return "pcm_u8"
    return f"pcm_s{bits}le"


def probe_wav(data: bytes) -> tuple[int, int, int, int, memoryview]:
    """Header scan only: (fmt_tag, bits, n_ch, sr, payload view).
    Raises WavError on malformed input; does not touch sample data."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt_tag = None
    n_ch = sr = bits = 0
    payload = None
    view = memoryview(data)  # chunk bodies stay zero-copy (a bytes slice of
    # a GB-scale data chunk costs seconds on the build host)
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body = view[pos + 8 : pos + 8 + csize]
        if cid == b"fmt ":
            if len(body) < 16:
                raise WavError("truncated fmt chunk")
            fmt_tag, n_ch, sr, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
            if fmt_tag == WAVE_FORMAT_EXTENSIBLE:
                if len(body) < 40:
                    raise WavError("truncated extensible fmt chunk")
                # first 2 bytes of the SubFormat GUID are the real format tag
                (fmt_tag,) = struct.unpack_from("<H", body, 24)
        elif cid == b"data":
            payload = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned
    if fmt_tag is None or payload is None:
        raise WavError("missing fmt or data chunk")
    if n_ch == 0 or sr == 0:
        raise WavError("invalid channel count or sample rate")
    return fmt_tag, bits, n_ch, sr, payload


def decode_wav(data: bytes) -> tuple[np.ndarray, int, str]:
    """Returns (planar f32 (n_ch, n), sample_rate, codec_name)."""
    fmt_tag, bits, n_ch, sr, payload = probe_wav(data)

    from .. import native

    _native_fmt = {
        (WAVE_FORMAT_IEEE_FLOAT, 32): "f32",
        (WAVE_FORMAT_IEEE_FLOAT, 64): "f64",
        (WAVE_FORMAT_PCM, 8): "u8",
        (WAVE_FORMAT_PCM, 16): "s16",
        (WAVE_FORMAT_PCM, 24): "s24",
        (WAVE_FORMAT_PCM, 32): "s32",
    }.get((fmt_tag, bits))
    if _native_fmt is not None and native.available():
        # single-pass C decode+deinterleave (numpy's astype + transposed
        # copy measured ~25 s for a 1-hour stereo f32 wav on the build host)
        bpp = native._PCM_BYTES[_native_fmt]
        usable = len(payload) - len(payload) % (bpp * n_ch)
        if usable == 0:
            raise WavError("no audio samples decoded")
        planar = native.pcm_to_f32_planar(payload[:usable], n_ch, _native_fmt)
        return planar, sr, _codec_name(fmt_tag, bits)

    def whole(bpp: int):
        # truncate to whole samples like the native path: a payload cut
        # mid-sample otherwise made np.frombuffer raise a bare ValueError,
        # escaping the WavError/DecodeError contract
        return payload[: len(payload) - len(payload) % bpp]

    if fmt_tag == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(whole(4), "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(whole(8), "<f8").astype(np.float32)
        else:
            raise WavError(f"unsupported float bit depth {bits}")
    elif fmt_tag == WAVE_FORMAT_PCM:
        if bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(whole(2), "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            x = s24_bytes_to_f32(np.frombuffer(payload, np.uint8))
        elif bits == 32:
            x = np.frombuffer(whole(4), "<i4").astype(np.float32) / 2147483648.0
        else:
            raise WavError(f"unsupported PCM bit depth {bits}")
    else:
        raise WavError(f"unsupported wav format tag 0x{fmt_tag:04x}")

    n = len(x) // n_ch
    if n == 0:
        raise WavError("no audio samples decoded")
    planar = np.ascontiguousarray(x[: n * n_ch].reshape(n, n_ch).T)
    return planar, sr, _codec_name(fmt_tag, bits)


def _wav_bytes(fmt_tag: int, n_ch: int, sr: int, bits: int, payload: bytes) -> bytes:
    block = n_ch * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, n_ch, sr, sr * block, block, bits)
    chunks = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(chunks)) + chunks


def encode_wav_f32(wavs: np.ndarray, sr: int) -> bytes:
    """Planar f32 (n_ch, n) -> IEEE-float WAV bytes (for test fixtures)."""
    n_ch, _n = wavs.shape
    interleaved = np.ascontiguousarray(wavs.T, np.float32).tobytes()
    return _wav_bytes(WAVE_FORMAT_IEEE_FLOAT, n_ch, sr, 32, interleaved)


def encode_wav_s16(wavs: np.ndarray, sr: int) -> bytes:
    n_ch, _n = wavs.shape
    ints = np.clip(np.round(wavs * 32768.0), -32768, 32767).astype("<i2")
    interleaved = np.ascontiguousarray(ints.T).tobytes()
    return _wav_bytes(WAVE_FORMAT_PCM, n_ch, sr, 16, interleaved)


def encode_wav_s24(wavs: np.ndarray, sr: int) -> bytes:
    """Planar f32 (n_ch, n) -> packed 24-bit little-endian PCM WAV bytes."""
    n_ch, _n = wavs.shape
    ints = np.clip(np.round(wavs.T * 8388608.0), -8388608, 8388607).astype("<i4")
    packed = np.ascontiguousarray(ints).view(np.uint8).reshape(-1, 4)[:, :3]
    return _wav_bytes(WAVE_FORMAT_PCM, n_ch, sr, 24, packed.tobytes())
