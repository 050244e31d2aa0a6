"""Video files without cv2: the port's counterpart of cv2.VideoCapture and
cv2.VideoWriter, which the machine that holds the card lacks.

`VideoReader` gives a video's frames as (H, W, 3) uint8 RGB, in order, from

- a directory of PNG/JPEG frames (`.png`, `.jpg`, `.jpeg` in any case),
  sorted by name, at `fps` (default 25, cv2's fallback in the JAX driver);
- a RIFF AVI whose video stream holds MJPEG (`MJPG`) or PNG (`png `)
  frames, its frame rate the stream header's rate / scale: the chunks of
  the stream's `movi` lists (OpenDML `AVIX` parts and `rec ` lists
  included), decoded by io/images.py; an MJPEG frame without Huffman
  tables gets the standard ones, as libjpeg's MJPEG rule gives them;
- any other file where `ffmpeg` is on the PATH, through an
  `ffmpeg -i FILE -f rawvideo -pix_fmt rgb24 -` pipe.

Without `ffmpeg` any other file raises ValueError naming the forms that
are read. `VideoWriter` writes an MJPEG AVI (AVI 1.0 with an idx1 index,
under 4 GiB) through the port's baseline JPEG encoder, at quality 95 by
default, and with `frames_dir` also every frame as a PNG there.
"""

from __future__ import annotations

import fractions
import functools
import os
import re
import shutil
import struct
import subprocess

import numpy as np

from reface_tpu_torch.io.images import imdecode, imencode, imread, imwrite

__all__ = ["VideoReader", "VideoWriter", "read_frames", "FORMS"]

FORMS = ("a directory of PNG/JPEG frames", "an AVI of MJPEG (MJPG) or PNG (png ) frames",
         "any file ffmpeg decodes, where ffmpeg is on the PATH")
_FRAME_EXT = (".png", ".jpg", ".jpeg")
_AVI_CODECS = {b"MJPG": "mjpeg", b"png ": "png", b"PNG ": "png", b"MPNG": "png"}
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_RIFF_LIMIT = 2**32 - 1


def _u32(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", b, at)[0]


class _Avi:
    """The video stream of a RIFF AVI: its codec, rate and the (offset,
    size) of every frame chunk."""

    def __init__(self, path: str):
        self.path = path
        self.frames: list = []
        self.stream = None
        self.codec = None
        self.fps = None
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            pos = 0
            while pos + 12 <= size:
                f.seek(pos)
                head = f.read(12)
                if head[:4] != b"RIFF" or head[8:12] not in (b"AVI ", b"AVIX"):
                    if pos == 0:
                        raise ValueError(f"{path}: not a RIFF AVI file")
                    break
                end = min(pos + 8 + _u32(head, 4), size)
                self._walk(f, pos + 12, end)
                pos = end + (end & 1)
        if self.codec is None:
            raise ValueError(f"{path}: no MJPEG or PNG video stream (the AVI forms read)")

    def _walk(self, f, pos: int, end: int):
        index = 0
        while pos + 8 <= end:
            f.seek(pos)
            head = f.read(8)
            cc, n = head[:4], _u32(head, 4)
            body = pos + 8
            if cc == b"LIST":
                kind = f.read(4)
                if kind == b"strl":
                    self._stream_list(f, body + 4, min(body + n, end), index)
                    index += 1
                else:  # hdrl, movi, rec , odml, INFO
                    self._walk(f, body + 4, min(body + n, end))
            elif (self.stream is not None and len(cc) == 4 and cc[2:] in (b"dc", b"db")
                  and cc[:2].isdigit() and int(cc[:2]) == self.stream):
                self.frames.append((body, min(n, end - body)))
            pos = body + n + (n & 1)

    def _stream_list(self, f, pos: int, end: int, index: int):
        strh = strf = None
        while pos + 8 <= end:
            f.seek(pos)
            head = f.read(8)
            n = _u32(head, 4)
            if head[:4] == b"strh":
                strh = f.read(min(n, 56))
            elif head[:4] == b"strf":
                strf = f.read(min(n, 40))
            pos += 8 + n + (n & 1)
        if strh is None or strh[:4] != b"vids" or self.stream is not None:
            return
        handler = strh[4:8]
        compression = strf[16:20] if strf is not None and len(strf) >= 20 else b""
        codec = _AVI_CODECS.get(compression) or _AVI_CODECS.get(handler)
        if codec is None:
            raise ValueError(f"{self.path}: video stream {compression or handler!r} is "
                             f"neither MJPEG nor PNG; read forms: {'; '.join(FORMS)}")
        scale, rate = _u32(strh, 20), _u32(strh, 24)
        self.stream, self.codec = index, codec
        self.fps = rate / scale if scale else None


@functools.cache
def _standard_dht() -> bytes:
    """The DHT segments of the standard tables (JPEG Annex K.3), as the
    port's encoder writes them."""
    data = imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    segs, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF and data[pos + 1] != 0xDA:
        n = struct.unpack_from(">H", data, pos + 2)[0]
        if data[pos + 1] == 0xC4:
            segs.append(data[pos: pos + 2 + n])
        pos += 2 + n
    return b"".join(segs)


def _mjpeg_frame(data: bytes) -> bytes:
    """An MJPEG frame with the standard Huffman tables put in before its
    first scan where it carries none (AVI1 MJPEG leaves them out)."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xC4:
            return data
        if marker == 0xDA:
            return data[:pos] + _standard_dht() + data[pos:]
        pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    return data


def _ffmpeg_probe(ffmpeg: str, path: str):
    """(width, height, fps) of the first video stream from `ffmpeg -i`'s
    stream line."""
    err = subprocess.run([ffmpeg, "-hide_banner", "-i", path], capture_output=True,
                         text=True).stderr
    line = next((ln for ln in err.splitlines() if "Video:" in ln), None)
    size = line and re.search(r"[ ,](\d{2,5})x(\d{2,5})[ ,\]]", line)
    if not size:
        raise ValueError(f"{path}: ffmpeg finds no video stream: {err.strip()[-500:]}")
    fps = re.search(r"([\d.]+) (?:fps|tbr)", line)
    return int(size.group(1)), int(size.group(2)), float(fps.group(1)) if fps else None


class VideoReader:
    """Frames of a video in one of FORMS, as (H, W, 3) uint8 RGB.

    fps: the file's rate (None where it gives none); `count`: the number
    of frames where the form says it before decoding (a directory, an AVI),
    else None."""

    def __init__(self, path: str, fps: float = 25.0):
        self.path = str(path)
        self._proc = None
        if os.path.isdir(self.path):
            self.kind = "frames"
            self.files = sorted(os.path.join(self.path, n) for n in os.listdir(self.path)
                                if n.lower().endswith(_FRAME_EXT))
            self.fps, self.count = fps, len(self.files)
            return
        if not os.path.isfile(self.path):
            raise ValueError(f"{self.path}: no such video file or frame directory")
        with open(self.path, "rb") as f:
            head = f.read(12)
        if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
            try:
                self.avi = _Avi(self.path)
            except ValueError:
                if not shutil.which("ffmpeg"):
                    raise
            else:
                self.kind = "avi"
                self.fps, self.count = self.avi.fps, len(self.avi.frames)
                return
        ffmpeg = shutil.which("ffmpeg")
        if not ffmpeg:
            raise ValueError(f"{self.path}: not a form read without ffmpeg, and there is no "
                             f"ffmpeg on the PATH; read forms: {'; '.join(FORMS)}")
        self.kind = "ffmpeg"
        self.ffmpeg = ffmpeg
        self.width, self.height, self.fps = _ffmpeg_probe(ffmpeg, self.path)
        self.count = None

    def __iter__(self):
        if self.kind == "frames":
            for p in self.files:
                yield imread(p)
        elif self.kind == "avi":
            yield from self._avi_frames()
        else:
            yield from self._pipe_frames()

    def _avi_frames(self):
        last = None
        with open(self.path, "rb") as f:
            for offset, n in self.avi.frames:
                if n == 0:  # a dropped frame repeats the one before
                    if last is not None:
                        yield last
                    continue
                f.seek(offset)
                data = f.read(n)
                if self.avi.codec == "mjpeg":
                    data = _mjpeg_frame(data)
                last = imdecode(data)
                yield last

    def _pipe_frames(self):
        w, h = self.width, self.height
        self._proc = subprocess.Popen(
            [self.ffmpeg, "-v", "error", "-i", self.path, "-map", "0:v:0", "-f", "rawvideo",
             "-pix_fmt", "rgb24", "-"], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        n = w * h * 3
        try:
            while True:
                buf = self._proc.stdout.read(n)
                if len(buf) < n:
                    break
                yield np.frombuffer(buf, np.uint8).reshape(h, w, 3).copy()
        finally:
            self.close()

    def close(self):
        if self._proc is not None:
            proc, self._proc = self._proc, None
            proc.stdout.close()
            proc.kill()
            proc.wait()
            proc.stderr.close()


def read_frames(path: str, limit: int = 0) -> tuple:
    """(list of frames, fps) of a whole video; `limit` > 0 keeps the first."""
    reader = VideoReader(path)
    frames = []
    try:
        for frame in reader:
            frames.append(frame)
            if limit and len(frames) >= limit:
                break
    finally:
        reader.close()
    return frames, reader.fps


class VideoWriter:
    """An MJPEG AVI of (H, W, 3) uint8 RGB frames, all of one size, written
    as they come; `close()` writes the index and the header's counts.
    With `frames_dir`, also each frame as `frames_dir/NNNNNN.png`."""

    def __init__(self, path: str, fps: float, quality: int = 95, frames_dir: str | None = None):
        self.path, self.quality, self.frames_dir = str(path), int(quality), frames_dir
        rate = fractions.Fraction(float(fps)).limit_denominator(100000)
        self.rate, self.scale = rate.numerator, rate.denominator
        self.fps = float(fps)
        self.index: list = []
        self.size = None
        self.biggest = 0
        self.f = open(self.path, "wb")
        if frames_dir:
            os.makedirs(frames_dir, exist_ok=True)

    def _headers(self, w: int, h: int, n: int, movi_size: int, riff_size: int) -> bytes:
        us = int(round(1e6 * self.scale / self.rate))
        avih = struct.pack("<14I", us, int(self.biggest * self.rate / self.scale), 0,
                           _AVIF_HASINDEX, n, 0, 1, self.biggest, w, h, 0, 0, 0, 0)
        strh = (b"vidsMJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, self.scale, self.rate,
                                          0, n, self.biggest, 0xFFFFFFFF, 0)
                + struct.pack("<4h", 0, 0, w, h))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        strl = (b"LIST" + struct.pack("<I", 4 + 64 + 48) + b"strl"
                + b"strh" + struct.pack("<I", 56) + strh + b"strf" + struct.pack("<I", 40) + strf)
        hdrl = b"hdrl" + b"avih" + struct.pack("<I", 56) + avih + strl
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI " + b"LIST"
                + struct.pack("<I", len(hdrl)) + hdrl + b"LIST" + struct.pack("<I", movi_size)
                + b"movi")

    def write(self, frame: np.ndarray):
        frame = np.asarray(frame, np.uint8)
        h, w = frame.shape[:2]
        if self.size is None:
            self.size = (w, h)
            self.f.write(self._headers(w, h, 0, 4, 4))
            self.movi = self.f.tell() - 4  # idx1 offsets count from the 'movi' word
        elif self.size != (w, h):
            raise ValueError(f"frame of {w}x{h} in a video of {self.size[0]}x{self.size[1]}")
        data = imencode(".jpg", frame, self.quality)
        at = self.f.tell()
        if at + 8 + len(data) + 1 + 16 * (len(self.index) + 1) + 8 > _RIFF_LIMIT:
            raise ValueError(f"{self.path}: an AVI 1.0 file stops at 4 GiB")
        self.f.write(b"00dc" + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1))
        self.index.append((at - self.movi, len(data)))
        self.biggest = max(self.biggest, len(data))
        if self.frames_dir:
            imwrite(os.path.join(self.frames_dir, f"{len(self.index) - 1:06d}.png"), frame)

    def close(self):
        if self.f is None:
            return
        if self.size is None:
            self.f.close()
            self.f = None
            raise ValueError(f"{self.path}: no frame was written")
        end = self.f.tell()
        self.f.write(b"idx1" + struct.pack("<I", 16 * len(self.index)))
        self.f.write(b"".join(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME, off, n)
                              for off, n in self.index))
        total = self.f.tell()
        self.f.seek(0)
        self.f.write(self._headers(*self.size, len(self.index), end - self.movi, total - 8))
        self.f.close()
        self.f = None

    def abort(self):
        """Close the file without its index (a run that failed)."""
        if self.f is not None:
            self.f.close()
            self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
