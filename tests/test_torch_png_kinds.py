"""The PNG kinds the port's decoder (yolo_tpu_torch/data/png.py,
native/png.c) reads beyond plain files, byte for byte as cv2.imdecode
and the JAX package's load_image (cv2.imread) give them, at 1 and 3
channels: interlaced (Adam7) files of every colour type and bit depth;
colour files with a gAMA or sRGB chunk, whose gray libpng computes in
linear light (cHRM and unrecognised iCCP profiles change nothing); and
the eXIf chunk's orientation, which cv2 5 applies.
"""

import itertools
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tests.png_writer import write_png
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu_torch.data.png import _chunk
from yolo_tpu_torch.native.preproc import decode_image, decode_image_bytes

torch.set_num_threads(1)

SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.fixture
def jax_cv2_decoder():
    old = jpipe.get_decoder()
    jpipe.set_decoder("cv2")
    yield jpipe.load_image
    jpipe.set_decoder(old)


def same_as_cv2(data, tmp_path, load, channels=(1, 3)):
    path = str(tmp_path / "kind.png")
    with open(path, "wb") as f:
        f.write(data)
    for c in channels:
        want = cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR if c == 3
                            else cv2.IMREAD_GRAYSCALE)
        assert want is not None
        want = want[..., ::-1] if c == 3 else want[..., None]
        got = decode_image_bytes(data, c)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(decode_image(path, c), got)
        np.testing.assert_array_equal(load(path, c).reshape(got.shape), got)


def _samples(rng, h, w, color, depth):
    pix = rng.integers(0, 1 << depth, (h, w, SPP[color]))
    if color in (2, 6) and h > 2:      # some gray pixels among the colour
        pix[:2, :, 1] = pix[:2, :, 0]
        pix[:2, :, 2] = pix[:2, :, 0]
    palette = None
    if color == 3:   # fewer entries than indices: the rest read black
        palette = rng.integers(0, 256, (min(1 << depth, 200), 3),
                               dtype=np.uint8)
    return pix, palette


@pytest.mark.parametrize("color,depth", TYPES)
def test_adam7_pngs_match_cv2(tmp_path, jax_cv2_decoder, color, depth):
    """Every colour type and bit depth, interlaced, at sizes whose
    passes are empty (1x1, 3x5) or partial, all five filters mixed."""
    rng = np.random.default_rng(color * 100 + depth)
    for h, w in [(1, 1), (3, 5), (9, 13), (17, 23)]:
        pix, palette = _samples(rng, h, w, color, depth)
        same_as_cv2(write_png(pix, depth, color, (0, 1, 2, 3, 4), palette,
                              interlace=True), tmp_path, jax_cv2_decoder)


GAMMAS = [16, 30000, 45455, 60000, 95000, 96000, 100000, 104000, 105500,
          200000]


@pytest.mark.parametrize("color,depth", [(2, 8), (2, 16), (3, 4), (3, 8),
                                         (6, 8), (6, 16), (0, 8), (4, 16)])
def test_gamma_pngs_match_cv2(tmp_path, jax_cv2_decoder, color, depth):
    """gAMA values on both sides of libpng's 5% significance threshold
    and past it, an sRGB chunk (which wins over gAMA), cHRM beside
    gAMA, and an iCCP profile libpng does not recognise; interlaced and
    not. Gray files and colour at 3 channels take no gamma."""
    rng = np.random.default_rng(color * 10 + depth)
    chrm = struct.pack(">8I", 31270, 32900, 70000, 30000, 20000, 70000,
                       10000, 5000)
    iccp = b"some profile\0\0" + zlib.compress(b"\0" * 128 + b"acsp" * 8)
    cases = [[(b"gAMA", struct.pack(">I", g))] for g in GAMMAS] + [
        [(b"sRGB", b"\0")],
        [(b"gAMA", struct.pack(">I", 60000)), (b"sRGB", b"\1")],
        [(b"gAMA", struct.pack(">I", 45455)), (b"cHRM", chrm)],
        [(b"iCCP", iccp)],
        [(b"iCCP", iccp), (b"gAMA", struct.pack(">I", 70000))]]
    for chunks, interlace in itertools.product(cases, (False, True)):
        pix, palette = _samples(rng, 11, 17, color, depth)
        same_as_cv2(write_png(pix, depth, color, (0, 4), palette, chunks,
                              interlace), tmp_path, jax_cv2_decoder)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_matches_cv2(tmp_path, jax_cv2_decoder,
                                          orientation):
    """cv2 5 turns a PNG as its eXIf chunk (a TIFF block, before or after
    the image data) says; the first of two counts, and a block that does
    not start II or MM is ignored."""
    rng = np.random.default_rng(orientation)
    pix, _ = _samples(rng, 9, 14, 2, 8)
    exif = Image.Exif()
    exif[0x0112] = orientation
    tiff = exif.tobytes()[6:]
    other = Image.Exif()
    other[0x0112] = 9 - orientation
    for chunks in ([(b"eXIf", tiff)],
                   [(b"eXIf", tiff), (b"eXIf", other.tobytes()[6:])],
                   [(b"eXIf", b"Exif\0\0" + tiff)]):
        same_as_cv2(write_png(pix, 8, 2, (0,), None, chunks), tmp_path,
                    jax_cv2_decoder)
    plain = write_png(pix, 8, 2)
    end = plain.index(b"IEND") - 4
    late = plain[:end] + _chunk(b"eXIf", tiff) + plain[end:]
    same_as_cv2(late, tmp_path, jax_cv2_decoder)
    want_hw = (14, 9) if orientation >= 5 else (9, 14)
    assert decode_image_bytes(late).shape[:2] == want_hw
