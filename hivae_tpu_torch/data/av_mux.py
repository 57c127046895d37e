"""Muxing the driving audio into a generated video (the port's own copy of
``hivae_tpu/data/av_mux.py``).

``export_video_with_audio`` takes the reference's path where an ``ffmpeg``
binary is on PATH: a silent mp4, the wav trimmed to the video's span, then
the two merged with AAC audio. Without one it writes an AVI with a pure
Python RIFF muxer (``write_avi_with_audio``): MJPG frames (OpenCV's JPEG
encoder) interleaved with 16-bit PCM, an index, and an audio stream a
player reads.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile
import wave
from typing import Optional, Tuple

import numpy as np

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10


def read_wav_segment(path: str, start: float = 0.0,
                     duration: Optional[float] = None
                     ) -> Tuple[int, np.ndarray]:
    """The [start, start + duration) seconds of a wav file -> (sample rate,
    int16 samples (n, channels)); 8-bit and 32-bit PCM are converted to
    16-bit."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        n = w.getnframes()
        first = min(int(round(start * rate)), n)
        count = n - first
        if duration is not None:
            count = min(count, int(round(duration * rate)))
        w.setpos(first)
        raw = w.readframes(count)
    if width == 2:
        pcm = np.frombuffer(raw, dtype="<i2")
    elif width == 1:  # 8-bit unsigned -> 16-bit signed
        pcm = ((np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128)
               << 8)
    elif width == 4:
        pcm = (np.frombuffer(raw, dtype="<i4") >> 16).astype(np.int16)
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    return rate, pcm.reshape(-1, ch)


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    data = struct.pack("<4sI", fourcc, len(payload)) + payload
    return data + (b"\x00" if len(payload) % 2 else b"")


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def write_avi_with_audio(path: str, frames: np.ndarray, fps: float,
                         rate: int, pcm: np.ndarray,
                         jpeg_quality: int = 92) -> None:
    """(F, H, W, 3) RGB uint8 frames and (n, ch) int16 PCM -> an MJPG/PCM
    AVI: 'hdrl' (avih, one 'vids' and one 'auds' stream), 'movi' with each
    frame's 00dc chunk followed by its span of audio in a 01wb chunk, and
    an idx1 index."""
    import cv2

    f, h, wpx = frames.shape[:3]
    ch = pcm.shape[1] if pcm.ndim == 2 else 1
    pcm = pcm.reshape(-1, ch).astype("<i2")
    block = 2 * ch
    spf = rate / fps  # audio samples per video frame

    jpegs = []
    for img in frames:
        ok, enc = cv2.imencode(
            ".jpg", cv2.cvtColor(np.ascontiguousarray(img),
                                 cv2.COLOR_RGB2BGR),
            [int(cv2.IMWRITE_JPEG_QUALITY), jpeg_quality])
        if not ok:
            raise IOError("JPEG encode failed")
        jpegs.append(enc.tobytes())
    max_jpeg = max(len(j) for j in jpegs)

    avih = struct.pack(
        "<14I", int(1e6 / fps), int(max_jpeg * fps), 0, AVIF_HASINDEX,
        f, 0, 2, max_jpeg, wpx, h, 0, 0, 0, 0)
    vstrh = struct.pack(
        "<4s4sIHHIIIIIIii4H", b"vids", b"MJPG", 0, 0, 0, 0,
        1000, int(fps * 1000), 0, f, max_jpeg, 0xFFFFFFFF - (1 << 32), 0,
        0, 0, wpx, h)
    vstrf = struct.pack("<IiiHH4sIiiII", 40, wpx, h, 1, 24, b"MJPG",
                        wpx * h * 3, 0, 0, 0, 0)
    astrh = struct.pack(
        "<4s4sIHHIIIIIIii4H", b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0,
        block, rate * block, 0, len(pcm), rate * block // 2, 0xFFFFFFFF -
        (1 << 32), block, 0, 0, 0, 0)
    astrf = struct.pack("<HHIIHH", 1, ch, rate, rate * block, block, 16)

    hdrl = _list(b"hdrl", _chunk(b"avih", avih) +
                 _list(b"strl", _chunk(b"strh", vstrh) +
                       _chunk(b"strf", vstrf)) +
                 _list(b"strl", _chunk(b"strh", astrh) +
                       _chunk(b"strf", astrf)))

    movi = []
    idx = []
    size = 0

    def add(fourcc: bytes, payload: bytes):
        nonlocal size
        idx.append(struct.pack("<4sIII", fourcc, AVIIF_KEYFRAME, 4 + size,
                               len(payload)))
        movi.append(_chunk(fourcc, payload))
        size += len(movi[-1])

    cursor = 0
    for i, j in enumerate(jpegs):
        add(b"00dc", j)
        end = int(round((i + 1) * spf))
        seg = pcm[cursor:min(end, len(pcm))]
        cursor = min(end, len(pcm))
        if len(seg):
            add(b"01wb", seg.tobytes())

    riff = (b"AVI " + hdrl + _list(b"movi", b"".join(movi)) +
            _chunk(b"idx1", b"".join(idx)))
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sI", b"RIFF", len(riff)) + riff)


def export_video_with_audio(output_path: str, frames: np.ndarray,
                            fps: float, audio_path: str,
                            audio_start: float = 0.0) -> str:
    """Write ``frames`` with the [audio_start, audio_start + F / fps)
    seconds of ``audio_path`` muxed in. Returns the path written: with
    ``ffmpeg`` on PATH an mp4 at ``output_path`` (the trim copies the wav's
    samples, the merge copies the video and encodes AAC), else the AVI of
    ``write_avi_with_audio`` at ``output_path`` with an ``.avi`` extension.
    """
    from .video import to_hwc_frames, write_video

    frames = to_hwc_frames(frames)
    duration = frames.shape[0] / fps

    if shutil.which("ffmpeg"):
        tmp_vid = tempfile.NamedTemporaryFile(suffix=".mp4",
                                              delete=False).name
        tmp_aud = tempfile.NamedTemporaryFile(suffix=".wav",
                                              delete=False).name
        try:
            write_video(tmp_vid, frames, fps=fps)
            subprocess.run(
                ["ffmpeg", "-i", audio_path, "-y", "-ss", str(audio_start),
                 "-t", str(duration), "-acodec", "copy", tmp_aud],
                check=True, capture_output=True)
            subprocess.run(
                ["ffmpeg", "-y", "-i", tmp_vid, "-i", tmp_aud, "-c:v",
                 "copy", "-c:a", "aac", "-strict", "experimental",
                 output_path],
                check=True, capture_output=True)
        finally:
            for p in (tmp_vid, tmp_aud):
                if os.path.exists(p):
                    os.remove(p)
        return output_path

    rate, pcm = read_wav_segment(audio_path, audio_start, duration)
    base, ext = os.path.splitext(output_path)
    if ext.lower() != ".avi":
        output_path = base + ".avi"
    write_avi_with_audio(output_path, frames, fps, rate, pcm)
    return output_path
