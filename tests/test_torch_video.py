"""The port's video input (yolo_tpu_torch/data/video.py) and `detect
--video` against the JAX package and OpenCV on the CPU.

Tolerances:
  * the native reader's frames equal cv2.imdecode of each frame's
    payload byte for byte (files of both cv2 writer backends, payloads
    without DHT, hand-built AVI structures); channels=1 equals
    cv2.cvtColor(BGR2GRAY) of that frame;
  * against cv2.VideoCapture (FFmpeg's MJPEG decoder and swscale) the
    native frames differ by the bound measured here and recorded as
    ROADMAP C13: luma-only content within 1; seeded scenes at most 72,
    mean 2.1; uniform noise at most 90, mean 13;
  * under set_decoder("cv2"): video_batches and video_info equal JAX's;
  * the writer's files read back through cv2.VideoCapture with the fps,
    size and frame count of the JAX writer's files; under PART_SIZE byte
    for byte as before OpenDML output, past it (lowered) in three or more
    OpenDML parts that the port's reader and cv2.VideoCapture read back
    frame for frame;
  * detect --video: each frame's JSON line as the port's detect tests
    hold the JAX CLI's (fp32: scores within 1e-4, boxes within 0.1 px;
    int8: 2e-3 and 1 px), on the same frames (--decoder cv2), and the
    native reader's lines against the JAX detector on the frames that
    reader decoded.
"""

import contextlib
import json
import os
import re
import struct

import numpy as np
import pytest
import torch

import tests.test_video as jtv
import yolo_tpu
from tests.torch_port import PortCli, he_weights, jax_test_names, rerun_jax_test
from yolo_tpu.data import video as jvideo
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.data import pipeline as tpipe
from yolo_tpu_torch.data import video as tvideo
from yolo_tpu_torch.data.png import encode_png
from yolo_tpu_torch.data.synthetic import video_frames

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _native_reader(monkeypatch):
    """Each test starts on the native reader; the decoder a command's
    --decoder selects (process-wide) is undone after it."""
    monkeypatch.setattr(tpipe, "_DECODER", "native")


@pytest.fixture(params=["native", "cv2"])
def decoder(request, monkeypatch, _native_reader):
    """Each reader of the port in turn (restored after the test)."""
    monkeypatch.setattr(tpipe, "_DECODER", request.param)
    return request.param


def _cv2_avi(path, frames_rgb, fps=10.0, backend="ffmpeg"):
    import cv2

    api = {"ffmpeg": cv2.CAP_FFMPEG,
           "opencv": cv2.CAP_OPENCV_MJPEG}[backend]
    h, w = frames_rgb.shape[1:3]
    writer = cv2.VideoWriter(str(path), api, cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (w, h))
    assert writer.isOpened()
    for f in frames_rgb:
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    return str(path)


def _payloads(path) -> list:
    """Each ##dc chunk's JPEG payload, found by pattern (not by the
    port's parser): a chunk id, a size, the JPEG SOI."""
    data = open(path, "rb").read()
    out = []
    for m in re.finditer(rb"\d\ddc(....)\xff\xd8", data, re.S):
        size = struct.unpack("<I", m.group(1))[0]
        out.append(data[m.start() + 8:m.start() + 8 + size])
    return out


def _imdecode(payload, channels):
    import cv2

    bgr = cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
    return (cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)[..., None]
            if channels == 1 else bgr[..., ::-1])


def _native(path, channels=3, **kw) -> np.ndarray:
    return np.concatenate([b["images"][:len(b["frames"])]
                           for b in tvideo.video_batches(path, 4, channels=
                                                         channels, **kw)])


def _capture(path) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame[..., ::-1])
    cap.release()
    return np.stack(out)


class _Cli(PortCli):
    """The port's CLI with the reader of the ``decoder`` fixture."""
    extra: list = []

    @classmethod
    def main(cls, argv):
        PortCli.main(list(argv) + cls.extra)


@pytest.mark.parametrize("name", jax_test_names(jtv))
def test_jax_video_tests_hold_for_the_port(name, decoder, tmp_path,
                                           monkeypatch):
    """All of tests/test_video.py (int8 video detection among them) on
    the port's video_batches, video_info and CLI, with each reader."""
    import yolo_tpu.cli  # noqa: F401  (bound, then replaced)

    monkeypatch.setattr(jtv, "video_batches", tvideo.video_batches)
    monkeypatch.setattr(jtv, "video_info", tvideo.video_info)
    monkeypatch.setattr(_Cli, "extra", ["--decoder", decoder])
    monkeypatch.setattr(yolo_tpu, "cli", _Cli)
    rerun_jax_test(jtv, name, {"tmp_path": tmp_path})


@pytest.mark.parametrize("backend", ["ffmpeg", "opencv"])
@pytest.mark.parametrize("channels", [1, 3])
def test_native_frames_equal_imdecode(backend, channels, tmp_path):
    """Both cv2 writer backends' files (FFmpeg's: COM, DQT, DHT, SOF0
    and no APP0; OpenCV's own: JFIF and an odml header)."""
    path = _cv2_avi(tmp_path / "v.avi", video_frames(6, 64, 96, 1),
                    backend=backend)
    want = np.stack([_imdecode(p, channels) for p in _payloads(path)])
    got = _native(path, channels)
    assert len(want) == 6
    np.testing.assert_array_equal(got, want)


def _strip_dht(data: bytes) -> bytes:
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + data[pos:])


def test_dht_less_frames_take_the_standard_tables(tmp_path):
    """Motion JPEG that leaves out DHT (webcam MJPEG does): the frames
    equal cv2.imdecode (libjpeg-turbo's jstdhuff.c tables) of the same
    payloads."""
    import cv2

    frames = video_frames(4, 48, 64, 2)
    payloads = [_strip_dht(cv2.imencode(".jpg", f[..., ::-1])[1].tobytes())
                for f in frames]
    assert all(b"\xff\xc4" not in p for p in payloads)
    path = str(tmp_path / "nodht.avi")
    writer = tvideo.AviWriter(path, 10.0, 64, 48)
    for p in payloads:
        writer.write_jpeg(p)
    writer.close()
    for channels in (1, 3):
        want = np.stack([_imdecode(p, channels) for p in payloads])
        np.testing.assert_array_equal(_native(path, channels), want)


def _avi(payloads, kind) -> bytes:
    """A hand-built MJPG AVI of the payloads, stream 1 the video after an
    audio stream: "rec" (LIST rec groups, JUNK, odd sizes, no idx1),
    "abs" (idx1 with file offsets), "avix" (an OpenDML RIFF AVIX part
    holding the second half)."""
    def chunk(fcc, body):
        return struct.pack("<4sI", fcc, len(body)) + body + \
            b"\0" * (len(body) & 1)

    def lst(typ, body):
        return chunk(b"LIST", typ + body)

    strh_a = struct.pack("<4s4sIHHIIIIIIII4h", b"auds", b"\0" * 4, 0, 0, 0,
                         0, 1, 8000, 0, 0, 0, 0, 1, 0, 0, 0, 0)
    strh_v = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"MJPG", 0, 0, 0, 0,
                         2, 25, 0, len(payloads), 0, 0, 0, 0, 0, 64, 48)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, 64, 48, 1, 24, b"MJPG", 0, 0,
                         0, 0, 0)
    avih = struct.pack("<10I4I", 80000, 0, 0, 0x10, len(payloads), 0, 2, 0,
                       64, 48, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh_a)
                     + chunk(b"strf", b"\0" * 16))
               + lst(b"strl", chunk(b"strh", strh_v)
                     + chunk(b"strf", strf_v)))
    frames = [chunk(b"01dc", p) for p in payloads]
    audio = chunk(b"00wb", b"\x01" * 7)
    if kind == "rec":
        body = b"".join(lst(b"rec ", audio + f) + chunk(b"JUNK", b"\0" * 5)
                        for f in frames)
        return chunk(b"RIFF", b"AVI " + hdrl + lst(b"movi", body))
    if kind == "abs":
        head = b"RIFF\0\0\0\0AVI " + hdrl + b"LIST\0\0\0\0movi"
        body = b"".join(audio + f for f in frames)
        idx = b"".join(struct.pack("<4sIII", b"01dc", 0x10, off, size)
                       for off, size in _offsets(head, body))
        return chunk(b"RIFF", b"AVI " + hdrl + lst(b"movi", body)
                     + chunk(b"idx1", idx))
    half = len(frames) // 2
    first = chunk(b"RIFF", b"AVI " + hdrl
                  + lst(b"movi", b"".join(frames[:half])))
    return first + chunk(b"RIFF", b"AVIX"
                         + lst(b"movi", b"".join(frames[half:])))


def _offsets(head: bytes, body: bytes):
    """(file offset, size) of each 01dc chunk of a movi body that starts
    after ``head``."""
    out, pos = [], 0
    while pos < len(body):
        fcc, size = struct.unpack("<4sI", body[pos:pos + 8])
        if fcc == b"01dc":
            out.append((len(head) + pos, size))
        pos += 8 + size + (size & 1)
    return out


@pytest.mark.parametrize("kind", ["rec", "abs", "avix"])
def test_native_reader_takes_every_avi_structure(kind, tmp_path):
    import cv2

    frames = video_frames(5, 48, 64, 3)
    payloads = [cv2.imencode(".jpg", f[..., ::-1])[1].tobytes()
                for f in frames]
    payloads = [p + b"\0" if i % 2 else p for i, p in enumerate(payloads)]
    path = str(tmp_path / f"{kind}.avi")
    with open(path, "wb") as f:
        f.write(_avi(payloads, kind))
    info = tvideo.video_info(path)
    assert info == {"fps": 12.5, "width": 64, "height": 48, "frames": 5}
    want = np.stack([_imdecode(p, 3) for p in payloads])
    np.testing.assert_array_equal(_native(path), want)
    got = list(tvideo.video_batches(path, 2, stride=2))
    assert [b["frames"] for b in got] == [[0, 2], [4]]
    np.testing.assert_array_equal(got[1]["images"][0], want[4])


@pytest.mark.parametrize("content, max_d, mean_d", [
    ("stripes", 1, 0.5), ("scenes", 72, 2.1), ("noise", 90, 13.0)])
@pytest.mark.parametrize("backend", ["ffmpeg", "opencv"])
def test_native_reader_within_c13_of_videocapture(content, max_d, mean_d,
                                                  backend, tmp_path):
    """The kept difference ROADMAP C13: FFmpeg converts a frame's
    YCbCr with swscale (its own chroma upsampling and fixed point),
    libjpeg-turbo (the native reader, cv2.imdecode) with its fancy
    upsampling and jdcolor tables."""
    rng = np.random.default_rng(5)
    frames = {"stripes": np.repeat(np.repeat(
                  ((np.arange(96) // 4) % 2 * 255).astype(np.uint8)
                  [None, :, None], 64, 0)[None], 4, 0).repeat(3, -1),
              "scenes": video_frames(4, 64, 96, 1),
              "noise": rng.integers(0, 255, (4, 64, 96, 3), np.uint8)
              }[content]
    path = _cv2_avi(tmp_path / "v.avi", frames, backend=backend)
    d = np.abs(_capture(path).astype(int) - _native(path).astype(int))
    assert d.max() <= max_d and d.mean() <= mean_d


@pytest.mark.parametrize("channels", [1, 3])
def test_cv2_reader_equals_jax(channels, tmp_path, monkeypatch):
    monkeypatch.setattr(tpipe, "_DECODER", "cv2")
    path = _cv2_avi(tmp_path / "v.avi", video_frames(9, 48, 64, 4), 12.0)
    assert tvideo.video_info(path) == jvideo.video_info(path)
    for kw in (dict(), dict(stride=2), dict(stride=3, max_frames=2)):
        got = list(tvideo.video_batches(path, 2, channels=channels, **kw))
        want = list(jvideo.video_batches(path, 2, channels=channels, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w) and g["frames"] == w["frames"]
            assert g.get("pad") == w.get("pad")
            np.testing.assert_array_equal(g["images"], w["images"])


def test_webcam_index_needs_the_cv2_reader():
    with pytest.raises(ValueError, match="A12a.*set_decoder"):
        next(tvideo.video_batches("0", 2))
    with pytest.raises(ValueError, match="A12a"):
        tvideo.video_info("1")


@pytest.mark.parametrize("fps", [10.0, 30.0, 7.5, 29.97 / 2, 25 / 3])
def test_writer_reads_back_as_the_jax_writers_file(fps, tmp_path):
    """VideoAnnotator's AVI through cv2.VideoCapture (FFmpeg): the fps,
    size and frame count of the JAX VideoAnnotator's (cv2.VideoWriter,
    FFmpeg backend) file, fractional frame rates too; the port's reader
    reads it back alike."""
    import cv2

    frames = video_frames(3, 40, 56, 6)
    boxes = np.array([[4.0, 4.0, 30.0, 20.0]])
    props = []
    for mod, name in ((jvideo, "j.avi"), (tvideo, "t.avi")):
        path = str(tmp_path / name)
        ann = mod.VideoAnnotator(path, fps, 56, 40)
        for f in frames:
            ann.write(f, boxes, np.array([0.9]), np.array([1]),
                      ["a", "b"], np.array([True]))
        ann.close()
        cap = cv2.VideoCapture(path)
        props.append([cap.get(p) for p in (
            cv2.CAP_PROP_FPS, cv2.CAP_PROP_FRAME_WIDTH,
            cv2.CAP_PROP_FRAME_HEIGHT, cv2.CAP_PROP_FRAME_COUNT)])
        assert len(_capture(path)) == 3
        cap.release()
    assert props[0] == props[1]
    info = tvideo.video_info(str(tmp_path / "t.avi"))
    assert (info["width"], info["height"], info["frames"]) == (56, 40, 3)
    assert info["fps"] == pytest.approx(props[1][0], abs=1e-9)


def _write_avi(path, payloads, fps=25.0, size=(64, 48)):
    writer = tvideo.AviWriter(str(path), fps, *size)
    for p in payloads:
        writer.write_jpeg(p)
    opendml, parts = writer.opendml, len(writer._super)
    writer.close()
    return opendml, parts


def test_writer_under_the_part_size_is_unchanged(tmp_path):
    """Under PART_SIZE the file is plain AVI 1.0, byte for byte what the
    writer wrote before OpenDML parts existed (its sha256 then)."""
    import hashlib

    from yolo_tpu_torch.native.preproc import encode_jpeg

    path = tmp_path / "v.avi"
    opendml, _ = _write_avi(path, [encode_jpeg(f) for f in
                                   video_frames(7, 48, 64, 3)], fps=29.97)
    assert not opendml
    assert hashlib.sha256(path.read_bytes()).hexdigest() == (
        "1b7cda21d9bfa20097cbdbc473193010c6e3f859f1266ec446803ac419a99b63")


def _hold_opendml_indexes(data: bytes, avi, parts: int) -> None:
    """The OpenDML indexes against the frames AviFile found by walking the
    chunks: the super index's entries point at each part's ix00 (its
    offset, size and entry count), each ix00's entries (offset from its
    base, size) at that part's frames in order; dmlh and strh count every
    frame, avih the first RIFF's (which idx1 indexes)."""
    def u32(at):
        return struct.unpack_from("<I", data, at)[0]

    indx = data.index(b"indx")
    n = u32(indx + 12)
    assert n == parts and data[indx + 16:indx + 20] == b"00dc"
    frames = iter(avi.frames)
    for k in range(n):
        off, size, count = struct.unpack_from("<QII", data, indx + 32 + 16 * k)
        assert data[off:off + 4] == b"ix00" and u32(off + 4) + 8 == size
        assert u32(off + 12) == count and data[off + 16:off + 20] == b"00dc"
        base = struct.unpack_from("<Q", data, off + 20)[0]
        assert data[base:base + 4] == b"movi"
        for e in range(count):
            rel, sz = struct.unpack_from("<II", data, off + 32 + 8 * e)
            assert (base + rel, sz) == next(frames)
            assert data[base + rel - 8:base + rel - 4] == b"00dc"
            assert u32(base + rel - 4) == sz
    assert next(frames, None) is None
    dmlh = data.index(b"dmlh")
    assert u32(dmlh + 8) == len(avi.frames)
    strh = data.index(b"strh")
    assert u32(strh + 8 + 32) == len(avi.frames)
    first = u32(data.index(b"idx1") + 4) // 16
    assert u32(data.index(b"avih") + 8 + 16) == first < len(avi.frames)


@pytest.mark.parametrize("part_size", [12_000, 30_000])
def test_writer_past_the_part_size_writes_opendml_parts(part_size, tmp_path,
                                                        monkeypatch):
    """With PART_SIZE lowered, the writer's file takes three or more
    OpenDML parts (RIFF AVI with indx, odml and idx1, then RIFF AVIX,
    each with its ix00): the port's reader gives back every payload in
    order, and cv2.VideoCapture (FFmpeg) counts and reads every frame, in
    order: the frames of the same payloads in one RIFF, and within
    ROADMAP C13's bound of the port's decode."""
    import cv2

    from yolo_tpu_torch.native.preproc import encode_jpeg

    frames = video_frames(40, 64, 96, 1)
    payloads = [encode_jpeg(f) for f in frames]
    one = str(tmp_path / "one.avi")
    _write_avi(one, payloads, size=(96, 64))
    monkeypatch.setattr(tvideo, "PART_SIZE", part_size)
    path = str(tmp_path / "v.avi")
    opendml, ended = _write_avi(path, payloads, size=(96, 64))
    assert opendml and ended + 1 >= 3
    data = open(path, "rb").read()
    assert data.count(b"AVIX") == ended and data.count(b"ix00") == ended + 1
    avi = tvideo.AviFile(path)
    _hold_opendml_indexes(data, avi, ended + 1)
    assert list(avi.payloads(range(len(avi.frames)))) == payloads
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(frames)
    cap.release()
    got = _capture(path)
    np.testing.assert_array_equal(got, _capture(one))
    d = np.abs(got.astype(int) - _native(path).astype(int))
    assert d.max() <= 72 and d.mean() <= 2.1


@pytest.fixture(scope="module")
def det_files(tmp_path_factory):
    """Seeded tiny-voc weights shaped like a trained detector's (box
    channels x0.1, objectness -2) and a 96x80 noise video of 5 frames
    (cv2's FFmpeg writer)."""
    d = tmp_path_factory.mktemp("video")
    weights = str(d / "tiny-voc.weights")
    he_weights(get_variant("tiny-voc"), weights, box_scale=0.1,
               objectness_shift=-2.0)
    rng = np.random.default_rng(0)
    video = _cv2_avi(d / "in.avi",
                     rng.integers(0, 255, (5, 80, 96, 3), np.uint8))
    return {"dir": d, "weights": weights, "video": video}


def _argv(files, precision, *extra):
    """int8 runs one batch of 8, which the JAX command then runs
    eagerly (_hold_int8_apart)."""
    return ["detect", "--model", "tiny-voc", "--input-size", "96",
            "--weights", files["weights"], "--precision", precision,
            "--conf", "0.1", "--batch",
            "8" if precision == "int8" else "2",
            *extra]


def _lines(text):
    return [json.loads(l) for l in text.strip().splitlines() if l]


def _near(want, got, precision):
    score_tol, box_tol = (1e-4, 0.1) if precision == "fp32" else (2e-3, 1.0)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g["class"] == w["class"]
        assert abs(g["score"] - w["score"]) <= score_tol + 1e-9
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], rtol=0,
                                   atol=box_tol + 1e-6)


def _hold_int8_apart(precision, monkeypatch):
    """For int8, take out the two differences of the int8 commands that
    tests/test_torch_quantize_cli.py already holds, so that what is left
    is the video path: the port calibrates with the JAX CLI's
    _maybe_quantize on the frames the port's video path picks (the
    calibration scales of the two packages lie a few ulps apart), and
    the JAX command runs eagerly (jitted, XLA:CPU may contract the int8
    epilogue into an FMA; the port computes as the eager JAX block).
    Measured on these frames without this: scores up to 0.02 apart and
    one detection more or less on two of five frames."""
    if precision != "int8":
        return contextlib.nullcontext()
    import jax

    import yolo_tpu_torch.cli._common as tcommon
    from tests.torch_port import to_jax_config
    from yolo_tpu.cli._common import _maybe_quantize as jmaybe

    def via_jax(args, cfg, params, images):
        return [{k: np.asarray(v) for k, v in p.items()}
                for p in jmaybe(args, to_jax_config(cfg), params, images)]

    monkeypatch.setattr(tcommon, "_maybe_quantize", via_jax)
    return jax.disable_jit()


@pytest.mark.parametrize("precision, sampling", [
    ("fp32", []), ("fp32", ["--stride", "2", "--max-frames", "2"]),
    ("int8", ["--stride", "2", "--max-frames", "2"])])
def test_cli_detect_video_matches_jax(precision, sampling, det_files,
                                      capsys, tmp_path, monkeypatch):
    """The same frames in both CLIs (the port reads through OpenCV with
    --decoder cv2): one line a sampled frame, the JAX CLI's frame
    indices and detections; --save-video's copy holds as many frames."""
    import yolo_tpu.cli as jcli
    import yolo_tpu_torch.cli as tcli

    argv = _argv(det_files, precision, "--video", det_files["video"],
                 *sampling)
    with _hold_int8_apart(precision, monkeypatch):
        jcli.main(argv)
    want = _lines(capsys.readouterr().out)
    out = str(tmp_path / "ann.avi")
    tcli.main(argv + CPU + ["--decoder", "cv2", "--save-video", out])
    cap = capsys.readouterr()
    got = _lines(cap.out)
    assert [l["frame"] for l in got] == [l["frame"] for l in want] == \
        ([0, 1, 2, 3, 4] if not sampling else [0, 2])
    assert sum(len(l["detections"]) for l in want) >= 2 * len(want)
    for w, g in zip(want, got):
        _near(w["detections"], g["detections"], precision)
    assert f"wrote {out}" in cap.err
    assert len(_native(out)) == len(got)


def _frame_pngs(frames, d, n=None):
    """The frames as PNG files, repeated at the end up to n files (the
    padding of the video path's calibration batch)."""
    d.mkdir()
    for i in range(max(n or 0, len(frames))):
        (d / f"{i:04d}.png").write_bytes(
            encode_png(frames[min(i, len(frames) - 1)]))
    return str(d)


def test_cli_detect_video_native_reader_matches_jax_detector(
        det_files, capsys, tmp_path):
    """The native reader's stream (its frames differ from FFmpeg's,
    ROADMAP C13): each line against the JAX CLI's detections of the
    frames that reader decoded, given to it losslessly as PNG files
    (`detect --images`: the same raw-frame detector). int8 on this
    reader: test_cli_detect_video_int8_equals_the_images_path."""
    import yolo_tpu.cli as jcli
    import yolo_tpu_torch.cli as tcli

    precision = "fp32"
    frames = _native(det_files["video"])
    pngs = _frame_pngs(frames, tmp_path / "frames")
    jcli.main(_argv(det_files, precision, "--images", pngs))
    want = _lines(capsys.readouterr().out)
    tcli.main(_argv(det_files, precision, "--video", det_files["video"])
              + CPU)
    got = _lines(capsys.readouterr().out)
    assert [l["frame"] for l in got] == list(range(len(frames)))
    assert [os.path.basename(l["image"]) for l in want] == \
        [f"{i:04d}.png" for i in range(len(frames))]
    assert sum(len(l["detections"]) for l in want) >= 5
    for w, g in zip(want, got):
        _near(w["detections"], g["detections"], precision)


@pytest.mark.parametrize("decoder_name", ["native", "cv2"])
def test_cli_detect_video_int8_equals_the_images_path(
        decoder_name, det_files, capsys, tmp_path):
    """The port's own int8 calibration: `detect --video` calibrates on
    the stream's first batch of 8 sampled frames (padded) and then
    prints what `detect --images` prints for the same frames as PNG
    files, exactly."""
    import yolo_tpu_torch.cli as tcli

    dec = ["--decoder", decoder_name]
    tcli.main(_argv(det_files, "int8", "--video", det_files["video"])
              + CPU + dec)
    got = _lines(capsys.readouterr().out)
    frames = np.concatenate([
        b["images"][:len(b["frames"])] for b in _decoded(
            det_files["video"], decoder_name)])
    tcli.main(_argv(det_files, "int8", "--images",
                    _frame_pngs(frames, tmp_path / "f", 8)) + CPU)
    want = _lines(capsys.readouterr().out)[:len(frames)]
    assert len(got) == len(frames) == 5
    assert [l["detections"] for l in got] == [l["detections"] for l in want]


def _decoded(path, decoder_name):
    from yolo_tpu_torch.data.pipeline import get_decoder, set_decoder

    old = get_decoder()
    set_decoder(decoder_name)
    try:
        return list(tvideo.video_batches(path, 4))
    finally:
        set_decoder(old)


def test_cli_save_labels_refused_with_video(det_files, capsys):
    import yolo_tpu.cli as jcli
    import yolo_tpu_torch.cli as tcli

    argv = _argv(det_files, "fp32", "--video", det_files["video"],
                 "--save-labels")
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + CPU)
    assert str(got.value) == str(want.value)
    assert "--images mode only" in str(got.value)
