"""Video-stream input (port of yolo_tpu/data/video.py): a whole stream's
frames share one shape, so they ride one detector through the batched
device letterbox, staged as directory inference stages its batches.

Two readers, chosen by data.pipeline.set_decoder:
  * "native" (the default, and the only one on a host without OpenCV):
    the port's RIFF/AVI parser and its JPEG decoder (native/jpeg.c), for
    Motion JPEG AVI files. It takes the header lists (avih, strh, strf,
    odml), `movi` lists with ##dc/##db chunks, `LIST rec ` groups, JUNK
    and odd-size padding, idx1 where it is there, and the OpenDML
    `RIFF AVIX` parts that follow a file's first 1 GiB. Each frame is
    byte for byte what cv2.imdecode gives for its payload (a payload
    without DHT takes the standard tables, as libjpeg-turbo does);
    FFmpeg, behind cv2.VideoCapture, upsamples chroma otherwise, so the
    two readers' frames differ at colour edges (ROADMAP C13). A webcam
    index raises ValueError.
  * "cv2": cv2.VideoCapture, exactly as the JAX package reads (webcam
    indices too).
channels=1 is cv2.cvtColor(frame, COLOR_BGR2GRAY) of the colour frame,
as in the JAX package: OpenCV 5's 15-bit fixed point,
(9798 R + 19235 G + 3735 B + 2^14) >> 15, equal to cv2 over the whole
RGB cube (the 14-bit coefficients of older builds differ on 0.26% of
it).

VideoAnnotator writes the annotated copy (detect --save-video) as an
MJPG AVI with the port's JPEG writer (native/jpeg_enc.c), its frame rate
the rational OpenCV's FFmpeg writer stores for the same float fps; past
1 GiB (PART_SIZE) the file goes on in OpenDML parts as FFmpeg's muxer
writes them (AviWriter).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import struct
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from yolo_tpu_torch.native.preproc import decode_jpeg, encode_jpeg

MJPEG_FOURCCS = (b"MJPG", b"mjpg")
# FFmpeg's AVI_MAX_RIFF_SIZE: a RIFF part ends once a frame would start
# this far past its start (tests lower it)
PART_SIZE = 1 << 30
# FFmpeg's AVI_MASTER_INDEX_SIZE_DEFAULT: the super index's entries
MAX_PARTS = 256


def _is_webcam(path) -> bool:
    return str(path).isdigit()


def _native() -> bool:
    from yolo_tpu_torch.data.pipeline import get_decoder

    return get_decoder() == "native"


def check_source(path: str) -> None:
    """Raise ValueError where the selected reader cannot read ``path``
    at all: a webcam index under the native reader."""
    if _native() and _is_webcam(path):
        raise ValueError(
            f"video source {path!r} is a webcam index: the port's native "
            f"reader reads Motion JPEG AVI files only (ROADMAP A12a); "
            f"call data.pipeline.set_decoder(\"cv2\") (--decoder cv2) to "
            f"read cameras through OpenCV")


# ---------------------------------------------------------------- AVI reader

class AviFile:
    """The video stream of a Motion JPEG AVI file: ``fps``, ``width``,
    ``height`` and ``frames``, the (offset, size) of each frame's JPEG
    payload in file order. Raises FileNotFoundError for a missing file
    and ValueError for a file it does not read."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        if not os.path.isfile(self.path):
            raise FileNotFoundError(f"cannot open video: {path}")
        self._size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            self._f = f
            self._parse()
        self._f = None

    def _fail(self, why: str):
        raise ValueError(f"{self.path}: {why}")

    def _read(self, off: int, n: int) -> bytes:
        self._f.seek(off)
        return self._f.read(n)

    def _chunks(self, start: int, end: int):
        """(fourcc, body offset, body size, list type or None) of each
        chunk in [start, end); a chunk cut off by the file's end ends
        the walk."""
        off = start
        end = min(end, self._size)
        while off + 8 <= end:
            fcc, size = struct.unpack("<4sI", self._read(off, 8))
            body = off + 8
            if body + size > self._size:
                size = self._size - body
                if fcc in (b"RIFF", b"LIST"):
                    yield fcc, body + 4, max(size - 4, 0), \
                        self._read(body, 4)
                return
            if fcc in (b"RIFF", b"LIST") and size >= 4:
                yield fcc, body + 4, size - 4, self._read(body, 4)
            else:
                yield fcc, body, size, None
            off = body + size + (size & 1)

    def _parse(self) -> None:
        head = self._read(0, 12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            self._fail("not an AVI file (the native video reader reads "
                       "Motion JPEG AVI; set_decoder(\"cv2\") reads other "
                       "containers through OpenCV)")
        self.fps, self.width, self.height = 0.0, 0, 0
        self._stream = None
        idx1, movis, parts = None, [], []
        for fcc, off, size, typ in self._chunks(0, self._size):
            if fcc == b"RIFF" and typ in (b"AVI ", b"AVIX"):
                parts.append((typ, off, size))
        for n, (typ, start, size) in enumerate(parts):
            for fcc, off, sz, ltyp in self._chunks(start, start + size):
                if fcc == b"LIST" and ltyp == b"hdrl" and n == 0:
                    self._hdrl(off, sz)
                elif fcc == b"LIST" and ltyp == b"movi":
                    movis.append((n, off - 4, off, off + sz))
                elif fcc == b"idx1" and n == 0:
                    idx1 = (off, sz)
        if self._stream is None:
            self._fail("no Motion JPEG video stream (the native video "
                       "reader decodes MJPG AVI only; set_decoder(\"cv2\") "
                       "reads other codecs through OpenCV)")
        self.frames: List[Tuple[int, int]] = []
        first = [m for m in movis if m[0] == 0]
        indexed = idx1 is not None and first and self._from_idx1(
            *idx1, first[0])
        for n, _, start, end in movis:
            if n == 0 and indexed:
                continue
            self._scan(start, end)

    def _hdrl(self, start: int, size: int) -> None:
        stream = 0
        for fcc, off, sz, typ in self._chunks(start, start + size):
            if fcc == b"avih" and sz >= 40:
                w, h = struct.unpack("<II", self._read(off + 32, 8))
                self.width, self.height = self.width or w, self.height or h
            elif fcc == b"LIST" and typ == b"strl":
                if self._stream is None:
                    self._strl(off, sz, stream)
                stream += 1

    def _strl(self, start: int, size: int, stream: int) -> None:
        kind = handler = None
        fps, wh, comp = 0.0, None, None
        for fcc, off, sz, _ in self._chunks(start, start + size):
            if fcc == b"strh" and sz >= 28:
                body = self._read(off, 28)
                kind, handler = body[:4], body[4:8]
                scale, rate = struct.unpack("<II", body[20:28])
                fps = rate / scale if scale and rate else 0.0
            elif fcc == b"strf" and sz >= 20:
                body = self._read(off, 20)
                w, h = struct.unpack("<ii", body[4:12])
                wh, comp = (w, abs(h)), body[16:20]
        if kind != b"vids":
            return
        if comp not in MJPEG_FOURCCS and handler not in MJPEG_FOURCCS:
            self._fail(f"video codec {(comp or handler)!r} is not Motion "
                       f"JPEG (the native video reader decodes MJPG only; "
                       f"set_decoder(\"cv2\") reads other codecs through "
                       f"OpenCV)")
        self._stream = stream
        self._ids = (b"%02ddc" % stream, b"%02ddb" % stream)
        self.fps = fps
        if wh is not None:
            self.width, self.height = wh

    def _from_idx1(self, start: int, size: int, movi) -> bool:
        """The first part's frames from idx1, whose offsets count from
        the `movi` fourcc or from the file's start; False (and nothing
        taken) where the index does not point at the chunks."""
        _, fourcc_at, body, end = movi
        raw = self._read(start, size - size % 16)
        entries = [struct.unpack("<4sIII", raw[i:i + 16])
                   for i in range(0, len(raw), 16)]
        entries = [e for e in entries if e[0] in self._ids]
        if not entries:
            return False
        base = fourcc_at if entries[0][2] < fourcc_at else 0
        frames = []
        for fcc, _flags, off, sz in entries:
            at = base + off
            if not body - 8 <= at <= end - 8 or \
                    self._read(at, 8) != struct.pack("<4sI", fcc, sz):
                return False
            if sz:
                frames.append((at + 8, sz))
        self.frames += frames
        return True

    def _scan(self, start: int, end: int) -> None:
        for fcc, off, sz, typ in self._chunks(start, end):
            if fcc == b"LIST" and typ == b"rec ":
                self._scan(off, off + sz)
            elif fcc in self._ids and sz:
                self.frames.append((off, sz))

    def payloads(self, indices) -> Iterator[bytes]:
        """The JPEG payloads of the frames at ``indices``, in order."""
        with open(self.path, "rb") as f:
            for i in indices:
                off, size = self.frames[i]
                f.seek(off)
                yield f.read(size)


def _gray_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(bgr, COLOR_BGR2GRAY) of an RGB uint8 image, its
    fixed-point luma: (9798 R + 19235 G + 3735 B + 2^14) >> 15, (H, W, 1)."""
    c = rgb.astype(np.int32)
    y = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
         + (1 << 14)) >> 15
    return y.astype(np.uint8)[..., None]


def _decode_frame(payload: bytes, channels: int = 3) -> np.ndarray:
    """One Motion JPEG frame -> (H, W, channels) uint8: RGB, or the gray
    of the colour frame."""
    rgb = decode_jpeg(payload, 3)
    return _gray_from_rgb(rgb) if channels == 1 else rgb


# ------------------------------------------------------------ the JAX API

def _open_capture(path: str):
    """cv2.VideoCapture for a file path OR a webcam index ("0")."""
    import cv2

    return cv2.VideoCapture(int(path) if _is_webcam(path) else path)


def video_info(path: str) -> Dict:
    """{'fps', 'width', 'height', 'frames'} for a video source (fps 30.0
    where the file states none)."""
    if not _native():
        import cv2

        cap = _open_capture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        info = {"fps": cap.get(cv2.CAP_PROP_FPS) or 30.0,
                "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT))}
        cap.release()
        return info
    check_source(path)
    avi = AviFile(path)
    return {"fps": avi.fps or 30.0, "width": avi.width,
            "height": avi.height, "frames": len(avi.frames)}


def _batches(frames: Iterator[Tuple[int, np.ndarray]],
             batch_size: int) -> Iterator[Dict]:
    chunk, idxs = [], []
    for idx, frame in frames:
        chunk.append(frame)
        idxs.append(idx)
        if len(chunk) == batch_size:
            yield {"images": np.stack(chunk), "frames": idxs}
            chunk, idxs = [], []
    if chunk:
        pad = batch_size - len(chunk)
        yield {"images": np.stack(chunk + [chunk[-1]] * pad),
               "frames": idxs, "pad": pad}


def _cv2_frames(path, stride, max_frames, channels):
    import cv2

    cap = _open_capture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        taken, idx = 0, 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % stride == 0:
                yield idx, (cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)[..., None]
                            if channels == 1
                            else cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                taken += 1
                if max_frames is not None and taken >= max_frames:
                    break
            idx += 1
    finally:
        cap.release()


def _native_frames(path, stride, max_frames, channels, batch_size):
    """The sampled frames of an MJPG AVI, decoded on a thread pool (each
    C call releases the interpreter lock) one batch ahead of the
    consumer; frames between samples are not decoded."""
    check_source(path)
    avi = AviFile(path)
    picks = list(range(0, len(avi.frames), stride))
    if max_frames is not None:   # the first sampled frame is always taken
        picks = picks[:max(max_frames, 1)]
    workers = max(1, min(batch_size, os.cpu_count() or 1, 8))
    payloads = avi.payloads(picks)
    with cf.ThreadPoolExecutor(workers) as pool:
        pending = []
        for idx, data in zip(picks, payloads):
            pending.append((idx, pool.submit(_decode_frame, data, channels)))
            if len(pending) >= 2 * workers:
                i, fut = pending.pop(0)
                yield i, fut.result()
        for i, fut in pending:
            yield i, fut.result()


def video_batches(path: str, batch_size: int,
                  stride: int = 1,
                  max_frames: Optional[int] = None,
                  channels: int = 3) -> Iterator[Dict]:
    """Decode a video into fixed-shape batches at the model's channel
    count.

    Yields {'images': (B, H, W, C) uint8, 'frames': [frame_index, ...]}
    with the final partial batch padded (repeating its last frame) and
    tagged with 'pad'. ``stride`` samples every Nth frame (3 = 10 Hz
    from 30 fps); ``max_frames`` stops after that many sampled frames.
    """
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if _native():
        frames = _native_frames(path, stride, max_frames, channels,
                                batch_size)
    else:
        frames = _cv2_frames(path, stride, max_frames, channels)
    try:
        yield from _batches(frames, batch_size)
    finally:
        frames.close()


# ------------------------------------------------------------- AVI writer

def ffmpeg_time_base(fps: float) -> Tuple[int, int]:
    """(dwScale, dwRate) of the AVI that OpenCV's FFmpeg writer makes
    for ``fps``: the rate is found with a decimal base grown tenfold
    until it lies within 1e-3 of fps, then reduced."""
    rate, base = int(fps + 0.5), 1
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    q = Fraction(rate, base)
    return q.denominator, q.numerator


class AviWriter:
    """A Motion JPEG AVI file (hdrl, movi, idx1), written as frames come.
    Past PART_SIZE bytes it becomes an OpenDML file as FFmpeg's avienc
    writes one (OpenCV's VideoWriter backend): when a frame would start
    more than PART_SIZE bytes past its RIFF's start, the first RIFF AVI
    gains an ``indx`` super index in its strl and ``LIST odml`` /
    ``dmlh`` (the total frame count) in its hdrl (its movi data moves
    down by the header's growth, once), each part ends its movi with an
    ``ix00`` standard index, the first keeps its idx1, and the frames go
    on in ``RIFF AVIX`` parts of their own. A file that stays under the
    part size is plain AVI 1.0, byte for byte the same either way."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        if fps <= 0 or width < 1 or height < 1:
            raise ValueError(f"an AVI at fps={fps} of {width}x{height}")
        self.width, self.height = int(width), int(height)
        self.scale, self.rate = ffmpeg_time_base(float(fps))
        self._f = open(path, "w+b")    # read back when a header grows
        self._index: List[Tuple[int, int]] = []    # the first RIFF's
        self._part = self._index                   # the current RIFF's
        self._super: List[Tuple[int, int, int]] = []   # ix00 pos, size, n
        self._frames = 0
        self._max = 0
        self._riff_start = 8                       # after its size field
        self._first_riff_size = 0
        self._f.write(self._header())
        self._movi = self._f.tell()          # the LIST header of movi
        self._f.write(b"LIST\0\0\0\0movi")

    @property
    def opendml(self) -> bool:
        return bool(self._super)

    def _header(self, opendml: bool = False) -> bytes:
        n, w, h = len(self._index), self.width, self.height
        usec = (1_000_000 * self.scale + self.rate // 2) // self.rate
        buf = max(self._max, 1 << 20)
        avih = struct.pack("<10I4I", usec, 0, 0, 0x910, n, 0, 1, buf, w,
                           h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"MJPG", 0, 0,
                           0, 0, self.scale, self.rate, 0, self._frames,
                           buf, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                           w * h * 3, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
        odml = b""
        if opendml:
            entries = b"".join(struct.pack("<QII", pos, size, count)
                               for pos, size, count in self._super)
            indx = struct.pack("<HBBI4s3I", 4, 0, 0, len(self._super),
                               b"00dc", 0, 0, 0) + entries + bytes(
                16 * (MAX_PARTS - len(self._super)))
            strl += _chunk(b"indx", indx)
            odml = _chunk(b"LIST", b"odml" + _chunk(
                b"dmlh", struct.pack("<I", self._frames) + bytes(244)))
        hdrl = (b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
                + odml)
        return b"RIFF\0\0\0\0AVI " + _chunk(b"LIST", hdrl)

    def write_jpeg(self, payload: bytes) -> None:
        if self._f.tell() - self._riff_start > PART_SIZE:
            self._next_part()
        at = self._f.tell()
        size = len(payload)
        self._f.write(struct.pack("<4sI", b"00dc", size) + payload
                      + b"\0" * (size & 1))
        self._part.append((at - self._movi - 8, size))
        self._frames += 1
        self._max = max(self._max, size)

    def _to_opendml(self) -> None:
        """Grow the first RIFF's header: move its movi data down by the
        size of indx and LIST odml, from the end backwards."""
        f, end = self._f, self._f.tell()
        grow = len(self._header(True)) - self._movi
        src = end
        while src > self._movi:
            n = min(src - self._movi, 1 << 24)
            src -= n
            f.seek(src)
            block = f.read(n)
            f.seek(src + grow)
            f.write(block)
        f.seek(0)
        f.write(self._header(True))
        self._movi += grow
        f.seek(end + grow)

    def _end_part(self) -> None:
        """The current RIFF's ix00 (offsets from its movi fourcc), the
        sizes of its movi and RIFF, and the first RIFF's idx1."""
        f = self._f
        base = self._movi + 8
        ix_at = f.tell()
        ix = struct.pack("<HBBI4sQI", 2, 0, 1, len(self._part), b"00dc",
                         base, 0) + b"".join(
            struct.pack("<II", off + 8, size) for off, size in self._part)
        f.write(_chunk(b"ix00", ix))
        self._super.append((ix_at, 8 + len(ix), len(self._part)))
        end = f.tell()
        f.seek(self._movi + 4)
        f.write(struct.pack("<I", end - self._movi - 8))
        f.seek(end)
        if self._part is self._index:
            self._write_idx1()
        end = f.tell()
        if self._part is self._index:
            self._first_riff_size = end - self._riff_start
        f.seek(self._riff_start - 4)
        f.write(struct.pack("<I", end - self._riff_start))
        f.seek(end)

    def _next_part(self) -> None:
        if len(self._super) + 1 >= MAX_PARTS:
            raise ValueError(f"an OpenDML AVI of more than {MAX_PARTS} parts "
                             f"of {PART_SIZE} bytes")
        if not self.opendml:
            self._to_opendml()
        self._end_part()
        f = self._f
        f.write(b"RIFF\0\0\0\0AVIX")
        self._riff_start = f.tell() - 4
        self._movi = f.tell()
        f.write(b"LIST\0\0\0\0movi")
        self._part = []

    def _write_idx1(self) -> None:
        f = self._f
        f.write(struct.pack("<4sI", b"idx1", 16 * len(self._index)))
        for off, size in self._index:
            f.write(struct.pack("<4sIII", b"00dc", 0x10, off, size))

    def close(self) -> None:
        if self._f is None:
            return
        f = self._f
        if self.opendml:
            self._end_part()
            f.seek(0)
            f.write(self._header(True))
            f.seek(4)
            f.write(struct.pack("<I", self._first_riff_size))
        else:
            end = f.tell()
            f.seek(self._movi + 4)
            f.write(struct.pack("<I", end - self._movi - 8))
            f.seek(end)
            self._write_idx1()
            total = f.tell()
            f.seek(0)
            f.write(self._header())
            f.seek(4)
            f.write(struct.pack("<I", total - 8))
        f.close()
        self._f = None


def _chunk(fcc: bytes, body: bytes) -> bytes:
    return struct.pack("<4sI", fcc, len(body)) + body + b"\0" * (len(body) & 1)


class VideoAnnotator:
    """Write an annotated copy of the stream (detect --save-video): each
    frame with its detections drawn (utils/viz.draw_detections), as a
    JPEG frame (quality 95, cv2.imwrite's) of an MJPG AVI."""

    def __init__(self, out_path: str, fps: float, width: int, height: int):
        try:
            self._writer = AviWriter(out_path, fps, width, height)
        except OSError as e:
            raise RuntimeError(f"cannot open video writer: {out_path}: "
                               f"{e}") from None

    def write(self, frame_rgb: np.ndarray, boxes, scores, classes,
              class_names, valid) -> None:
        from yolo_tpu_torch.utils.viz import draw_detections

        annotated = draw_detections(frame_rgb, boxes, scores, classes,
                                    class_names, valid)
        h, w = annotated.shape[:2]
        if (w, h) != (self._writer.width, self._writer.height):
            raise ValueError(f"a {w}x{h} frame in a "
                             f"{self._writer.width}x{self._writer.height} "
                             f"video")
        self._writer.write_jpeg(encode_jpeg(annotated))

    def close(self) -> None:
        self._writer.close()
