"""Minimal WAV read/write (``neojax.io.wav``; counterpart of
``extra/cli/src/wav.hpp:50,89``).

Supports PCM 16/24/32-bit and IEEE float32, mono or multichannel, and
WAVE_FORMAT_EXTENSIBLE through its SubFormat GUID. Buffers are
``[channels, frames]`` float32 numpy arrays in [-1, 1] — the audio-domain
equivalent of the reference's ``audio_buffer`` mdarray. Host numpy only:
the bytes written equal ``neojax``'s.
"""

from __future__ import annotations

import struct
import wave

import numpy as np

__all__ = ["read_wav", "write_wav"]


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> ([channels, frames] float32, sample_rate)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = struct.unpack("<4sI", chunk)
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
                fmt_payload = payload
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"missing fmt/data chunk in {path}")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # The real format code is the first two bytes of the SubFormat GUID
        # at offset 24 of the fmt chunk (the reference reads the full fmt:
        # ``extra/cli/src/wav.hpp:50-89``).
        if len(fmt_payload) < 40:
            raise ValueError(f"truncated WAVE_FORMAT_EXTENSIBLE fmt chunk in {path}")
        audio_format = struct.unpack_from("<H", fmt_payload, 24)[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")

    frames = len(x) // channels
    return x[: frames * channels].reshape(frames, channels).T.copy(), sample_rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Write [channels, frames] (or [frames]) float32 to a PCM WAV file."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    channels, frames = audio.shape
    interleaved = np.clip(audio.T.reshape(-1), -1.0, 1.0)

    if bits == 16:
        pcm = (interleaved * 32767.0).round().astype("<i2").tobytes()
        sampwidth = 2
    elif bits == 32:
        # Scale in float64: in float32, 1.0 * (2^31 - 1) rounds up to 2^31,
        # which wraps to INT32_MIN on cast — full-scale samples flip sign.
        scaled = interleaved.astype(np.float64) * float((1 << 31) - 1)
        pcm = np.clip(scaled.round(), -(1 << 31), (1 << 31) - 1).astype("<i4").tobytes()
        sampwidth = 4
    else:
        raise ValueError("write_wav supports 16 or 32 bits")

    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(sample_rate)
        w.writeframes(pcm)
