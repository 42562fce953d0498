"""AVIF in the port's host decoder (data/avif.py, native/av1*.c), byte
for byte as cv2 reads it (OpenCV 5 on libavif 1.4.2 and libaom 3.14.1),
at 3 channels (after COLOR_BGR2RGB) and 1 (IMREAD_GRAYSCALE):

  * the files cv2.imwrite and PIL write at their defaults: odd sizes,
    one and selected transform sizes, past 64 a side, PIL's palettes and
    intra block copy, two tile columns and 128x128 superblocks, and the
    committed fixtures (tests/data/torch_jpeg/avif_*, hashes.json);
  * the AV1 layer alone: the decoded Y, U and V planes equal libavif's
    (tests/avif_oracle.py, libavif through ctypes);
  * what the port leaves out raises ValueError naming it (4:4:4, 4:2:2,
    10/12-bit, monochrome, alpha, lossless frames, derived items,
    rotation / mirroring / clean aperture, image sequences), and a cut
    or damaged file, or an iloc that names the file many times over,
    raises ValueError;
  * the dispatch: AVIF is the last signature of preproc.FORMATS; the JAX
    package's load_image (cv2) gives the same arrays; detect --images
    lists no .avif in either CLI.
"""

import io
import json
import os
import struct
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
from PIL import Image

from tests import avif_oracle
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu_torch.data import avif
from yolo_tpu_torch.native import preproc
from yolo_tpu_torch.native.preproc import decode_image, decode_image_bytes

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_jpeg")


def _fixtures():
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        files = json.load(f)["files"]
    return sorted(n for n in files if n.endswith(".avif"))


def _cv2(data, channels):
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR if channels == 3
                       else cv2.IMREAD_GRAYSCALE)
    if img is None:
        return None
    return img[..., ::-1] if channels == 3 else img[..., None]


def _picture(rng, h, w):
    """Ramps, flat rectangles and mild noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 127 // max(w + h - 2, 1)], -1)
    for _ in range(3):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + max(h // 3, 1), x0:x0 + max(w // 3, 1)] = \
            rng.integers(0, 256, 3)
    img = img + rng.integers(-10, 11, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_avif(img, params=()):
    ok, buf = cv2.imencode(".avif", np.ascontiguousarray(img[..., ::-1])
                           if img.ndim == 3 else img, list(params))
    assert ok
    return buf.tobytes()


def _pil_avif(img, mode=None, **kw):
    f = io.BytesIO()
    Image.fromarray(img, mode).save(f, format="AVIF", **kw)
    return f.getvalue()


def _same_as_cv2(data):
    for c in (3, 1):
        want = _cv2(data, c)
        assert want is not None
        got = decode_image_bytes(data, c)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(1, 1), (5, 3), (37, 53), (65, 130),
                                (70, 140), (97, 66)])
def test_cv2_defaults_read_as_cv2_reads_them(hw):
    """cv2.imwrite's defaults (quantizer matrices, delta q, CDEF; one
    transform size a block at 37x53 and 65x130, selected ones at 70x140)
    at odd sizes and past 64 a side."""
    _same_as_cv2(_cv2_avif(_picture(np.random.default_rng(hw), *hw)))


def _screen(rng, h, w, ncol):
    """Rows of six seeded 8x6 glyphs of ncol colours: screen content."""
    pal = rng.integers(0, 256, (ncol, 3))
    glyphs = [rng.integers(0, ncol, (8, 6)) for _ in range(6)]
    idx = np.zeros((h, w), np.int64)
    for y in range(0, h, 10):
        for x in range(0, w, 7):
            g = glyphs[int(rng.integers(0, len(glyphs)))]
            idx[y:y + 8, x:x + 6] = g[:min(8, h - y), :min(6, w - x)]
    return pal[idx].astype(np.uint8)


@pytest.mark.parametrize("kind", ["picture", "noise", "palette", "screen",
                                  "tiles", "sb128"])
def test_pil_defaults_read_as_cv2_reads_them(kind):
    """PIL's defaults: no CDEF and no quantizer matrices; palettes on a
    few-colour frame; palettes and intra block copy on screen content;
    two tile columns (300x900) and 128x128 superblocks (520x520) on
    smooth frames."""
    rng = np.random.default_rng(len(kind))
    if kind == "picture":
        img = _picture(rng, 45, 67)
    elif kind == "noise":
        img = rng.integers(0, 256, (33, 47, 3), np.uint8)
    elif kind == "palette":
        img = ((rng.random((48, 72, 3)) < 0.05) * 255).astype(np.uint8)
    elif kind == "screen":
        img = _screen(np.random.default_rng(52), 120, 160, 4)
    else:
        h, w = (300, 900) if kind == "tiles" else (520, 520)
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256],
                       -1).astype(np.uint8)
    _same_as_cv2(_pil_avif(img))


@pytest.mark.parametrize("name", _fixtures())
def test_fixtures_read_as_cv2_reads_them(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        _same_as_cv2(f.read())


@pytest.mark.skipif(not avif_oracle.available(),
                    reason="libavif of opencv-python is not installed")
@pytest.mark.parametrize("name", _fixtures())
def test_av1_planes_equal_libavifs(name):
    """The AV1 layer alone: Y, U and V as libavif (libaom) decodes
    them, before the colour step."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    y, u, v, info = avif.decode_yuv(data)
    for got, want in zip((y, u, v), avif_oracle.decode_planes(data)):
        np.testing.assert_array_equal(got, want)
    assert list(info[:4]) == [y.shape[1], y.shape[0], u.shape[1],
                              u.shape[0]]


def _left_out():
    img = _picture(np.random.default_rng(21), 24, 40)
    rgba = np.concatenate([img, img[..., :1]], -1)
    return {
        "4:4:4": (_pil_avif(img, subsampling="4:4:4"), "4:4:4"),
        "4:2:2": (_pil_avif(img, subsampling="4:2:2"), "4:2:2"),
        "alpha": (_pil_avif(rgba, "RGBA"), "alpha"),
        "10-bit": (_cv2_avif(img.astype(np.uint16) * 4,
                             [cv2.IMWRITE_AVIF_DEPTH, 10]), "10/12-bit"),
        "monochrome": (_cv2_avif(img[..., 0]), "monochrome"),
        "lossless": (_pil_avif(img, quality=100), "lossless"),
    }


@pytest.mark.parametrize("case", sorted(_left_out()))
def test_left_out_kinds_raise_naming_them(case, tmp_path):
    """cv2 reads these; the port raises ValueError naming the kind and
    the file."""
    data, what = _left_out()[case]
    assert _cv2(data, 3) is not None
    path = str(tmp_path / "x.avif")
    with open(path, "wb") as f:
        f.write(data)
    for c in (3, 1):
        with pytest.raises(ValueError) as err:
            decode_image(path, c)
        assert what in str(err.value) and path in str(err.value)


def _patched(data, old, new, nth=0):
    """data with the nth occurrence of old replaced by new (same
    length)."""
    pos = -1
    for _ in range(nth + 1):
        pos = data.index(old, pos + 1)
    return data[:pos] + new + data[pos + len(old):]


@pytest.mark.parametrize("case", ["grid", "irot", "imir", "clap",
                                  "sequence"])
def test_left_out_boxes_raise_naming_them(case):
    """A derived (grid) primary item, a rotation, mirror or clean
    aperture property, an image sequence's brand: each raises naming it
    (the files are cv2's with one box type rewritten)."""
    data = _cv2_avif(_picture(np.random.default_rng(22), 16, 24))
    if case == "grid":
        data, what = _patched(data, b"av01", b"grid"), "grid"
    elif case == "sequence":
        data, what = _patched(data, b"avif", b"avis"), "image sequence"
    else:
        data = _patched(data, b"pixi", case.encode())
        what = {"irot": "irot", "imir": "imir", "clap": "clap"}[case]
    with pytest.raises(ValueError, match=what):
        decode_image_bytes(data)


def test_cut_and_damaged_files_raise():
    """A file cut anywhere, and an iloc extent past the file, raise
    ValueError (never crash)."""
    data = _cv2_avif(_picture(np.random.default_rng(23), 40, 56))
    for n in (12, 40, len(data) // 2, len(data) - 30, len(data) - 1):
        with pytest.raises(ValueError):
            decode_image_bytes(data[:n])
    (size,) = struct.unpack_from(">I", data, data.index(b"mdat") - 4)
    damaged = data.replace(struct.pack(">I", size - 8),
                           struct.pack(">I", 10 ** 7), 1)
    assert damaged != data
    with pytest.raises(ValueError, match="past the file"):
        decode_image_bytes(damaged)


def _with_iloc(data, payload):
    """data with its iloc box's payload replaced (the meta box resized;
    item offsets are left as they were)."""
    out = b""
    for kind, s, e in avif._boxes(data, 0, len(data)):
        body = data[s:e]
        if kind == b"meta":
            body = data[s:s + 4]
            for k2, s2, e2 in avif._boxes(data, s + 4, e):
                p2 = payload if k2 == b"iloc" else data[s2:e2]
                body += struct.pack(">I4s", len(p2) + 8, k2) + p2
        out += struct.pack(">I4s", len(body) + 8, kind) + body
    return out


@pytest.mark.parametrize("case", ["empty extents", "extents past the file",
                                  "rest of the file past it", "field size"])
def test_iloc_that_names_the_file_many_times_raises(case):
    """An iloc whose extents cost no bytes (offset, length and index
    fields of 0 bytes, each extent then the whole file), whose extents add
    up past the file (also after a rest-of-file extent that starts past
    it), or whose fields are not 0, 4 or 8 bytes wide raises
    ValueError at once: a small upload never builds the file many times
    over."""
    data = _cv2_avif(_picture(np.random.default_rng(26), 24, 32))
    item = avif._meta(data, *next((s, e) for k, s, e in
                                  avif._boxes(data, 0, len(data))
                                  if k == b"meta"))["pitm"]
    if case == "empty extents":
        # version 1, every field 0 bytes, one item of 65535 extents
        payload = (bytes([1, 0, 0, 0, 0x00, 0x00]) + struct.pack(
            ">HHHHH", 1, item, 0, 0, 65535))
        what = "declares 65535 extents"
    elif case == "extents past the file":
        n = len(data) - 64
        payload = (bytes([0, 0, 0, 0, 0x44, 0x00]) + struct.pack(
            ">HHHH", 1, item, 0, 3) + struct.pack(">II", 0, n) * 3)
        what = "past the file"
    elif case == "rest of the file past it":
        # an extent of length 0 (the rest of the file) that starts past
        # the file, then three that each fit
        n = len(data) - 64
        payload = (bytes([0, 0, 0, 0, 0x44, 0x00]) + struct.pack(
            ">HHHH", 1, item, 0, 4) + struct.pack(">II", 2 ** 32 - 1, 0)
            + struct.pack(">II", 0, n) * 3)
        what = "past the file"
    else:
        payload = (bytes([0, 0, 0, 0, 0x24, 0x00]) + struct.pack(
            ">HHHH", 1, item, 0, 1) + struct.pack(">HI", 0, 100))
        what = "0, 4 or 8 bytes"
    with pytest.raises(ValueError, match=what):
        decode_image_bytes(_with_iloc(data, payload))


def test_dispatch_and_jax_load_image(tmp_path):
    """AVIF is found by its ftyp brand whatever the extension, listed
    last in FORMATS; the JAX package's load_image (cv2) gives the same
    arrays."""
    assert preproc.FORMATS[-1][0] == "AVIF"
    assert preproc.READ_FORMATS.endswith("AVIF")
    data = _cv2_avif(_picture(np.random.default_rng(24), 30, 42))
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    old = jpipe.get_decoder()
    jpipe.set_decoder("cv2")
    try:
        for c in (3, 1):
            np.testing.assert_array_equal(decode_image(path, c),
                                          jpipe.load_image(path, c))
    finally:
        jpipe.set_decoder(old)


def test_detect_images_lists_no_avif(tmp_path):
    """The port's detect --images lists .jpg, .jpeg, .png and .bmp only,
    as the JAX package's does (the same extension tuple in its source),
    so a folder of an .avif holds no images."""
    import inspect

    from yolo_tpu.cli import detect_cmds as jdc
    from yolo_tpu_torch.cli import detect_cmds as tdc

    exts = 'exts = (".jpg", ".jpeg", ".png", ".bmp")'
    assert exts in inspect.getsource(jdc) and exts in inspect.getsource(tdc)
    with open(tmp_path / "a.avif", "wb") as f:
        f.write(_cv2_avif(_picture(np.random.default_rng(25), 8, 8)))
    with pytest.raises(SystemExit, match="no images found"):
        tdc._image_paths(SimpleNamespace(images=str(tmp_path),
                                         recursive=False))
