"""The port's host image decoder (yolo_tpu_torch/native/) against OpenCV,
byte for byte, on the CPU: JPEG through native/jpeg.c, PNG through zlib
and native/png.c, as cv2.imread / cv2.imdecode give them after
COLOR_BGR2RGB (IMREAD_COLOR) or as IMREAD_GRAYSCALE gives them, EXIF
orientation applied. Where the JAX package's native decoder
(yolo_tpu.native.preproc, the system libjpeg) does not decline a file,
it gives the same bytes too.

Also: the files the decoder raises for, with the file and the reason in
the message; the recorded hashes of tests/data/torch_jpeg/; the C
unfilter against the Python one; decodes on 8 threads at once; the
library build under concurrent builders; load_image / set_decoder; and
/detect with JPEG bodies on the CPU.
"""

import concurrent.futures as cf
import hashlib
import io
import itertools
import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tests.jpeg_writer import (Frame, random_coefficients, sequential_script,
                               write_jpeg)
from tests.torch_port import jax_native_library
from yolo_tpu.native import preproc as jpreproc
from yolo_tpu_torch.data import pipeline as tpipe
from yolo_tpu_torch.data.png import (_unfilter_sequential, decode_png,
                                     encode_png_rows, unfilter,
                                     unfilter_plain)
from yolo_tpu_torch.data.synthetic import encode_jpeg
from yolo_tpu_torch.native import build
from yolo_tpu_torch.native.preproc import (decode_image, decode_image_bytes,
                                           decode_letterbox_batch)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "gray": None}
SIZES = [(1, 1), (7, 13), (17, 33), (333, 517), (480, 640)]


def _picture(rng, h, w, noise=False):
    """Ramps and shapes with mild noise, or (noise=True) uniform noise."""
    if noise:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx * yy) % 256], -1).astype(np.int64)
    img[h // 4:h // 2 + 1, w // 3:w // 2 + 1] = rng.integers(0, 256, 3)
    img += rng.integers(-10, 11, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_jpeg(img, quality, sampling, restart=0, optimize=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize]
    if SAMPLING[sampling] is None:
        src = img[..., 0]
    else:
        src = img[..., ::-1]
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def _cv2_decode(data, channels):
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR if channels == 3
                       else cv2.IMREAD_GRAYSCALE)
    assert img is not None
    return img[..., ::-1] if channels == 3 else img[..., None]


def _same_as_cv2(data, channels=(1, 3), jax_too=True):
    for c in channels:
        want = _cv2_decode(data, c)
        got = decode_image_bytes(data, c)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if jax_too:
            ref = jpreproc.decode_image_bytes(data, c)
            if ref is not None:
                np.testing.assert_array_equal(got, ref)


# --- JPEG: cv2-written grid ----------------------------------------------------

@pytest.mark.parametrize("sampling,quality,size", list(itertools.product(
    SAMPLING, (50, 75, 95, 100), SIZES)))
def test_jpeg_grid_matches_cv2(sampling, quality, size):
    """Sampling x quality x size, each at restart interval 0 and 3 and
    with and without OPTIMIZE (its own Huffman tables), at 1 and 3
    channels; quality 100 on noise (the IDCT range limit)."""
    rng = np.random.default_rng(quality + size[0])
    img = _picture(rng, *size, noise=quality == 100)
    for restart, optimize in itertools.product((0, 3), (0, 1)):
        _same_as_cv2(_cv2_jpeg(img, quality, sampling, restart, optimize),
                     jax_too=restart == 0 and optimize == 0)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_written_jpegs_match_cv2(subsampling):
    """PIL's encoder: its own quantization tables and scaling."""
    rng = np.random.default_rng(subsampling)
    for (h, w), quality in itertools.product([(1, 1), (9, 31), (121, 90)],
                                             (30, 90)):
        b = io.BytesIO()
        Image.fromarray(_picture(rng, h, w)).save(
            b, "JPEG", quality=quality, subsampling=subsampling)
        _same_as_cv2(b.getvalue())
    b = io.BytesIO()
    Image.fromarray(_picture(rng, 40, 50)[..., 0]).save(b, "JPEG")
    _same_as_cv2(b.getvalue())


def test_adobe_rgb_jpeg_matches_cv2():
    """An Adobe APP14 transform-0 file is RGB, not YCbCr (PIL keep_rgb)."""
    b = io.BytesIO()
    Image.fromarray(_picture(np.random.default_rng(3), 33, 47)).save(
        b, "JPEG", quality=85, keep_rgb=True, subsampling=0)
    data = b.getvalue()
    assert b"Adobe" in data
    _same_as_cv2(data)


@pytest.mark.parametrize("sampling", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("restart", [0, 2])
def test_encode_jpeg_output_matches_cv2(sampling, restart):
    rng = np.random.default_rng(len(sampling) + restart)
    for (h, w), quality in itertools.product([(1, 1), (15, 9), (61, 130)],
                                             (40, 100)):
        data = encode_jpeg(_picture(rng, h, w), quality, sampling, restart)
        _same_as_cv2(data)
        got = decode_image_bytes(data, 1 if sampling == "gray" else 3)
        assert got.shape[:2] == (h, w)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(tmp_path, orientation):
    """cv2 applies EXIF orientation in imread and imdecode alike, at 1
    and 3 channels (transposes 5-8 swap the image's sides)."""
    rng = np.random.default_rng(orientation)
    img = _picture(rng, 13, 22)
    exif = Image.Exif()
    exif[0x0112] = orientation
    for sub in (0, 2):
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", quality=90, subsampling=sub,
                                  exif=exif.tobytes())
        for data in (b.getvalue(), encode_jpeg(img, 90, "420",
                                               orientation=orientation)):
            _same_as_cv2(data, jax_too=False)
            path = str(tmp_path / "o.jpg")
            with open(path, "wb") as f:
                f.write(data)
            want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(decode_image(path), want)
            hw = (22, 13) if orientation >= 5 else (13, 22)
            assert want.shape[:2] == hw


@settings(max_examples=40, deadline=None, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       sampling=st.sampled_from(sorted(SAMPLING)),
       quality=st.integers(1, 100), seed=st.integers(0, 2 ** 16))
def test_jpeg_random_sizes_match_cv2(h, w, sampling, quality, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    _same_as_cv2(_cv2_jpeg(img, quality, sampling), jax_too=False)


def test_fixtures_match_recorded_hashes():
    """tests/data/torch_jpeg/hashes.json records cv2's output for each
    fixture (tools/jpeg_fixtures.py); the port gives the same bytes, and
    raises where cv2 gives no image of those channels (null)."""
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        files = json.load(f)["files"]
    assert len(files) >= 10
    for name, want in files.items():
        for key, channels in (("rgb", 3), ("gray", 1)):
            if want[key] is None:
                with pytest.raises(ValueError):
                    decode_image(os.path.join(FIXTURES, name), channels)
                continue
            img = decode_image(os.path.join(FIXTURES, name), channels)
            assert list(img.shape) == want[key]["shape"], name
            assert hashlib.sha256(img.tobytes()).hexdigest() == \
                want[key]["sha256"], name


def test_fixtures_match_cv2():
    for name in sorted(os.listdir(FIXTURES)):
        if name.endswith((".jpg", ".png")):
            with open(os.path.join(FIXTURES, name), "rb") as f:
                _same_as_cv2(f.read(), jax_too=False)


# --- JPEG: what raises ---------------------------------------------------------

def _baseline(h=24, w=40, sampling="420"):
    return _cv2_jpeg(_picture(np.random.default_rng(0), h, w), 90, sampling)


def _patch_marker(data, old, new):
    i = data.index(bytes((0xFF, old)))
    return data[:i + 1] + bytes((new,)) + data[i + 2:]


def _patch_dri(data):
    """The DRI segment's length said as 5 (libjpeg: JERR_BAD_LENGTH)."""
    i = data.index(b"\xff\xdd")
    return data[:i + 2] + b"\x00\x05" + data[i + 4:i + 6] + b"\x00" + \
        data[i + 6:]


def _unsupported_files():
    """What cv2 gives no image for. Progressive, arithmetic, CMYK,
    multi-scan and damaged files decode: tests/test_torch_jpeg_kinds.py
    and the restart tests below hold them to cv2."""
    img = _picture(np.random.default_rng(1), 24, 40)
    base = _baseline()
    sof = base.index(b"\xff\xc0")
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    sos = base.index(b"\xff\xda")
    ok, prog = cv2.imencode(".jpg", img[..., ::-1],
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    prog = prog.tobytes()
    rng = np.random.default_rng(2)
    fr12 = Frame(16, 8, [(1, 1)], precision=12)
    fr2 = Frame(16, 8, [(1, 1)] * 2)
    fr5 = Frame(16, 8, [(1, 1)] * 5)
    fr3 = Frame(24, 16, [(2, 2), (1, 1), (1, 1)])
    arith = write_jpeg(fr3, random_coefficients(rng, fr3), arithmetic=True,
                       progressive=True)
    return {
        "lossless": (_patch_marker(base, 0xC0, 0xC3), "lossless"),
        "arithmetic lossless": (_patch_marker(base, 0xC0, 0xCB),
                                "arithmetic-coded lossless"),
        "hierarchical": (_patch_marker(base, 0xC0, 0xC5), "hierarchical"),
        "12-bit": (twelve, "12-bit"),
        "12-bit written": (write_jpeg(fr12, random_coefficients(rng, fr12)),
                           "12-bit"),
        "2 components": (write_jpeg(fr2, random_coefficients(rng, fr2)),
                         "2 components"),
        "5 components": (write_jpeg(fr5, random_coefficients(rng, fr5)),
                         "5 components"),
        "baseline scan in a progressive frame": (
            _patch_marker(base, 0xC0, 0xC2), "invalid progressive scan"),
        "truncated scan": (base[:len(base) * 2 // 3], "truncated"),
        "truncated header": (base[:sos - 20], "truncated"),
        "truncated progressive": (prog[:len(prog) * 2 // 3], "truncated"),
        "progressive without EOI": (prog[:-2], "truncated"),
        "truncated arithmetic": (arith[:len(arith) * 2 // 3], "truncated"),
        "DRI of 5 bytes": (_patch_dri(_cv2_jpeg(img, 90, "420", restart=1)),
                           "DRI"),
        # a box like JPEG 2000's signature but of no format
        "not an image": (b"\0\0\0\x0cjX  \r\n\x87\n" + bytes(40),
                         "not an image format"),
    }


@pytest.mark.parametrize("case", sorted(_unsupported_files()))
def test_unsupported_and_corrupt_files_raise_with_path(tmp_path, case):
    data, reason = _unsupported_files()[case]
    for channels in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert cv2.imdecode(np.frombuffer(data, np.uint8), channels) is None
    path = str(tmp_path / f"{case.replace(' ', '_')}.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for channels in (1, 3):
        with pytest.raises(ValueError) as err:
            decode_image(path, channels)
        assert path in str(err.value) and reason in str(err.value)
    with pytest.raises(ValueError, match=reason):
        decode_image_bytes(data)


def _same_as_cv2_or_both_refuse(data, shape):
    """cv2's bytes at 3 and 1 channels where cv2 gives an image, a
    ValueError where it gives none; True if cv2 gave one."""
    decoded = False
    for channels, flag in ((3, cv2.IMREAD_COLOR), (1, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if want is None:
            with pytest.raises(ValueError):
                decode_image_bytes(data, channels)
            continue
        want = want[..., ::-1] if channels == 3 else want[..., None]
        got = decode_image_bytes(data, channels)
        assert got.shape == shape[:2] + (channels,)
        np.testing.assert_array_equal(got, want)
        decoded = True
    return decoded


def test_corrupt_scan_bytes_raise_or_decode_like_libjpeg():
    """Random damage to the entropy-coded bytes decodes as libjpeg
    decodes it (bad codes read as symbol 0, data cut by a marker reads
    zeros): the port gives cv2's bytes wherever cv2 gives an image."""
    base = _baseline(64, 64)
    start = base.index(b"\xff\xda") + 14
    rng = np.random.default_rng(0)
    decoded = 0
    for _ in range(50):
        data = bytearray(base)
        for i in rng.integers(start, len(base) - 2, 4):
            data[i] = int(rng.integers(0, 256))
        decoded += _same_as_cv2_or_both_refuse(bytes(data), (64, 64))
    assert decoded > 0


def _rst_damage():
    """Restart markers lost, repeated, out of order or replaced, in
    cv2's baseline (restart every MCU or every 3) and progressive files
    and in an arithmetic file: each of jpeg_resync_to_restart's three
    actions."""
    img = _picture(np.random.default_rng(1), 40, 56)
    base1 = _cv2_jpeg(img, 90, "420", restart=1)
    base3 = _cv2_jpeg(img, 90, "gray", restart=3)
    ok, prog = cv2.imencode(".jpg", img[..., ::-1],
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                             cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    fr = Frame(56, 40, [(2, 2), (1, 1), (1, 1)])
    arith = write_jpeg(fr, random_coefficients(np.random.default_rng(2), fr),
                       sequential_script(fr, restart=2), arithmetic=True)

    def cut(data, n):   # drop the n-th RST marker (and its two bytes)
        i = -1
        for _ in range(n):
            i = min(j for j in (data.find(bytes((0xFF, m)), i + 1)
                                for m in range(0xD0, 0xD8)) if j >= 0)
        return data[:i] + data[i + 2:]

    return {
        "missing RST": base1.replace(b"\xff\xd1", b"\xff\xd3", 1),
        "RST one ahead": base1.replace(b"\xff\xd2", b"\xff\xd3", 1),
        "RST two behind": base1.replace(b"\xff\xd4", b"\xff\xd2", 1),
        "RST far off": base1.replace(b"\xff\xd2", b"\xff\xd6", 1),
        "lost RST": cut(base1, 3),
        "lost RST gray": cut(base3, 2),
        "RST as a reserved marker": base3.replace(b"\xff\xd1", b"\xff\x02", 1),
        "RST as COM": base3.replace(b"\xff\xd1", b"\xff\xfe", 1),
        "progressive lost RST": cut(prog.tobytes(), 5),
        "progressive RST one ahead": prog.tobytes().replace(
            b"\xff\xd2", b"\xff\xd3", 1),
        "arithmetic lost RST": cut(arith, 2),
        "arithmetic RST two ahead": arith.replace(b"\xff\xd1", b"\xff\xd3",
                                                  1),
    }


@pytest.mark.parametrize("case", sorted(_rst_damage()))
def test_damaged_restart_markers_match_cv2(case):
    """Where libjpeg warns of a restart marker and resyncs (discard the
    marker; scan forward; or leave it for a later restart, the interval
    reading as empty), the port gives cv2's bytes."""
    data = _rst_damage()[case]
    assert _same_as_cv2_or_both_refuse(data, (40, 56))


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        decode_image(str(tmp_path / "missing.jpg"))


# --- PNG -----------------------------------------------------------------------

PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
_SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png(rng, h, w, color, depth, filters):
    stride = (w * _SPP[color] * depth + 7) // 8
    if depth < 8:
        vals = rng.integers(0, 1 << depth, (h, w))
        bits = np.zeros((h, stride * 8), np.uint8)
        for k in range(depth):
            bits[:, np.arange(w) * depth + k] = (vals >> (depth - 1 - k)) & 1
        rows = np.packbits(bits, axis=1)
    else:
        rows = rng.integers(0, 256, (h, stride), dtype=np.uint8)
        rows = np.cumsum(rows, axis=1, dtype=np.uint8) // 2
    palette = None
    if color == 3:   # fewer entries than indices: the rest read black
        palette = rng.integers(0, 256, (min(1 << depth, 200), 3),
                               dtype=np.uint8)
    return encode_png_rows(rows, w, depth, color, filters, palette)


@pytest.mark.parametrize("color,depth", PNG_TYPES)
def test_png_types_match_cv2(color, depth):
    """Gray, RGB, palette, gray + alpha, RGBA at every bit depth, each
    row filter alone and all five mixed, at 1 and 3 channels."""
    rng = np.random.default_rng(color * 100 + depth)
    for (h, w), filters in itertools.product(
            [(1, 1), (5, 3), (23, 17)], [(0,), (1,), (2,), (3,), (4,),
                                         (0, 1, 2, 3, 4)]):
        _same_as_cv2(_png(rng, h, w, color, depth, filters), jax_too=False)


def test_gray_png_matches_the_jax_native_decoder():
    rng = np.random.default_rng(9)
    data = _png(rng, 19, 29, 0, 8, (4,))
    _same_as_cv2(data)


def test_png_raises_for_interlaced_and_gamma_gray(tmp_path):
    """Interlaced files and colour files with a gamma at channels=1 read
    as cv2 reads them now (tests/test_torch_png_kinds.py holds every
    type); an unknown interlace method and a bad CRC still raise, with
    the file named."""
    rng = np.random.default_rng(2)
    data = _png(rng, 8, 8, 2, 8, (0,))

    def with_interlace(method):
        ihdr = bytearray(data[16:29])
        ihdr[12] = method
        chunk = b"IHDR" + bytes(ihdr)
        return (data[:12] + chunk + struct.pack(
            ">I", zlib.crc32(chunk) & 0xFFFFFFFF) + data[33:])

    rows = rng.integers(0, 256, (8, 24), dtype=np.uint8)
    srgb = encode_png_rows(rows, 8, 8, 2, chunks=[(b"sRGB", b"\0")])
    for c in (1, 3):
        np.testing.assert_array_equal(decode_image_bytes(srgb, c),
                                      _cv2_decode(srgb, c))
    path = str(tmp_path / "laced.png")
    with open(path, "wb") as f:
        f.write(with_interlace(2))
    assert cv2.imread(path) is None
    with pytest.raises(ValueError, match=f"{path}.*interlace method 2"):
        decode_image(path)
    bad_crc = data[:30] + bytes((data[30] ^ 1,)) + data[31:]
    with pytest.raises(ValueError, match="CRC"):
        decode_image_bytes(bad_crc)


@settings(max_examples=30, deadline=None, database=None)
@given(h=st.integers(1, 12), stride=st.integers(1, 40),
       bpp=st.sampled_from([1, 2, 3, 4, 6, 8]), seed=st.integers(0, 9999))
def test_c_unfilter_matches_python(h, stride, bpp, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, h)
    got = unfilter(raw.tobytes(), h, stride, bpp)
    np.testing.assert_array_equal(got, unfilter_plain(raw.tobytes(), h,
                                                      stride, bpp))


def test_unfilter_sequential_is_the_plain_average_and_paeth():
    """The Python per-byte loop is the reference the C unfilter's
    Average and Paeth rows are held to."""
    rng = np.random.default_rng(4)
    for ft in (3, 4):
        line = bytearray(rng.integers(0, 256, 30, dtype=np.uint8).tobytes())
        prior = rng.integers(0, 256, 30, dtype=np.uint8).tobytes()
        want = bytearray(line)
        _unfilter_sequential(ft, want, prior, 3)
        raw = np.concatenate([[2], np.frombuffer(prior, np.uint8), [ft],
                              np.frombuffer(bytes(line), np.uint8)])
        out = unfilter(raw.astype(np.uint8).tobytes(), 2, 30, 3)
        np.testing.assert_array_equal(out[1], np.frombuffer(bytes(want),
                                                            np.uint8))
    with pytest.raises(ValueError, match="unknown filter type 7"):
        unfilter(bytes([7, 1, 2]), 1, 2, 1)


def test_decode_png_keeps_the_files_channels():
    rng = np.random.default_rng(1)
    assert decode_png(_png(rng, 4, 5, 0, 8, (0,))).shape == (4, 5, 1)
    assert decode_png(_png(rng, 4, 5, 4, 16, (0,))).shape == (4, 5, 1)
    assert decode_png(_png(rng, 4, 5, 3, 4, (0,))).shape == (4, 5, 3)


# --- threads, batch loader, build ---------------------------------------------

def test_eight_threads_decode_the_same_bytes():
    rng = np.random.default_rng(8)
    files = [_cv2_jpeg(_picture(rng, 120 + i, 160), 90, "420")
             for i in range(16)]
    want = [decode_image_bytes(d) for d in files]
    with cf.ThreadPoolExecutor(8) as pool:
        for _ in range(3):
            got = list(pool.map(decode_image_bytes, files))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_decode_letterbox_batch_semantics(tmp_path):
    """(batch, dims, ok) as the JAX package's native batch loader gives
    them; a file that does not decode leaves its slot zero with ok
    False; each image is the pipeline's own letterbox of the decode."""
    jax_native_library()
    rng = np.random.default_rng(6)
    paths = []
    for i, (h, w) in enumerate([(48, 80), (97, 61), (30, 30)]):
        p = str(tmp_path / f"{i}.jpg")
        with open(p, "wb") as f:
            f.write(_cv2_jpeg(_picture(rng, h, w), 90, "420"))
        paths.append(p)
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8junk")
    paths.insert(1, bad)
    for channels in (3, 1):
        batch, dims, ok = decode_letterbox_batch(paths, (64, 96), 4,
                                                 channels)
        jbatch, jdims, jok = jpreproc.decode_letterbox_batch(
            paths, (64, 96), 4, channels)
        assert batch.shape == jbatch.shape and batch.dtype == np.float32
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(dims, jdims)
        assert not batch[1].any()
        for i in np.nonzero(ok)[0]:
            img = decode_image(paths[i], channels)
            np.testing.assert_array_equal(
                batch[i], tpipe._host_resize(img, (64, 96), "letterbox"))
            np.testing.assert_allclose(batch[i], jbatch[i], atol=2e-6)


def test_build_under_concurrent_builders(tmp_path):
    """Six processes build the library into one empty directory at once
    (as pytest workers do): each loads a working library, and one file
    is left."""
    code = (
        "import sys; from yolo_tpu_torch.native import build as b; "
        f"b.BUILD_DIR = {str(tmp_path)!r}; "
        "lib = b.library(); print(b.library_path())")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    built = [n for n in os.listdir(tmp_path) if n.endswith(".so")]
    assert len(built) == 1 and not [n for n in os.listdir(tmp_path)
                                    if n.endswith(".tmp")]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "CC_FLAGS", build.CC_FLAGS + (
        "-DYOLO_BREAK=1", "-include", "no_such_header_xyz.h"))
    with pytest.raises(RuntimeError, match="no_such_header_xyz"):
        build.build()


# --- pipeline and server -------------------------------------------------------

def test_load_image_decoders(tmp_path):
    """native is the default; cv2 when asked for; both give the same
    bytes for JPEG and PNG at 1 and 3 channels."""
    assert tpipe.get_decoder() == "native"
    rng = np.random.default_rng(2)
    img = _picture(rng, 31, 45)
    jpg, png = str(tmp_path / "a.jpg"), str(tmp_path / "a.png")
    cv2.imwrite(jpg, img[..., ::-1])
    cv2.imwrite(png, img[..., ::-1])
    native = {(p, c): tpipe.load_image(p, c) for p in (jpg, png)
              for c in (1, 3)}
    try:
        tpipe.set_decoder("cv2")
        assert tpipe.get_decoder() == "cv2"
        for (p, c), got in native.items():
            np.testing.assert_array_equal(tpipe.load_image(p, c), got)
    finally:
        tpipe.set_decoder("native")
    with pytest.raises(ValueError, match="unknown decoder"):
        tpipe.set_decoder("pil")


def test_inference_batches_read_jpeg_like_cv2(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i, (h, w) in enumerate([(40, 60), (55, 33), (20, 90)]):
        p = str(tmp_path / f"{i}.jpg")
        with open(p, "wb") as f:
            f.write(encode_jpeg(_picture(rng, h, w), 85))
        paths.append(p)
    got = next(tpipe.inference_batches(paths, 3, net_size=64, workers=2))
    try:
        tpipe.set_decoder("cv2")
        want = next(tpipe.inference_batches(paths, 3, net_size=64,
                                            workers=2))
    finally:
        tpipe.set_decoder("native")
    np.testing.assert_array_equal(got["images"], want["images"])
    assert got["shapes"] == want["shapes"] == [(40, 60), (55, 33), (20, 90)]


def test_server_jpeg_bodies_equal_direct_calls(tmp_path):
    import http.client

    import yolo_tpu_torch
    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.serve import DetectionServer, detections_to_json
    from tests.torch_port import he_weights

    cfg = get_variant("tiny-voc", input_size=64)
    path = str(tmp_path / "w.weights")
    he_weights(cfg, path)
    model = yolo_tpu_torch.load(path, "tiny-voc", device="cpu",
                                precision="fp32", input_size=64,
                                conf_threshold=0.3)
    rng = np.random.default_rng(11)
    bodies = [encode_jpeg(rng.integers(0, 256, (120, 160, 3),
                                       dtype=np.uint8), 90),
              _cv2_jpeg(_picture(rng, 97, 130), 80, "422")]

    def post(port, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/detect", body=body,
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    server = DetectionServer(model.cfg, model.params, port=0,
                             conf_threshold=0.3)
    server.start()
    try:
        answers = [post(server.port, b) for b in bodies]
        bad = post(server.port, bodies[0][:len(bodies[0]) // 2])
    finally:
        server.stop()
    assert bad[0] == 400
    for (status, body), data in zip(answers, bodies):
        frame = decode_image_bytes(data)
        direct = detections_to_json(model(frame[None]), cfg.class_names)[0]
        assert status == 200 and body["detections"] == direct
    assert sum(len(b["detections"]) for _, b in answers) > 0
