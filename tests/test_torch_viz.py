"""The port's image annotation and writers (yolo_tpu_torch/utils/viz.py,
native/jpeg_enc.c) against cv2, which the JAX package draws and writes
with (yolo_tpu/utils/viz.py):

  * draw_detections: every pixel outside the label texts' boxes equals
    the JAX draw_detections' (cv2.rectangle outlines and label
    backgrounds); the text is the port's own stroke font;
  * the advance table: text_size equals cv2.getTextSize(FONT_HERSHEY_
    SIMPLEX, 0.5, 1) for every printable ASCII character, random strings
    and every built-in class name's label;
  * PNG: cv2.imread reads the written file back bit for bit;
  * JPEG (q95, 4:2:0, cv2.imwrite's defaults): the file decodes, by cv2,
    within 1 grey level of cv2.imwrite's own file of the same array, and
    the two files are the same bytes;
  * BMP and binary PGM / PPM / PNM: cv2.imwrite's bytes;
  * TIFF, PAM, Sun raster, PFM and HDR: cv2.imwrite's bytes (a Sun
    raster's last pad byte aside: cv2 copies it from past its image);
  * WebP: lossless, read back exactly by cv2 and the port, at most 1.5x
    the size of cv2.imwrite's file on an annotated 480x640 frame;
  * .apng: the port's .png file (cv2's .apng is its .png file); .pic:
    cv2.imwrite's bytes, the port's .hdr file (JPEG 2000:
    tests/test_torch_jp2_write.py)."""

import os

import cv2
import numpy as np
import pytest

from yolo_tpu.utils import viz as jviz
from yolo_tpu_torch.configs import VARIANTS
from yolo_tpu_torch.utils import viz

FONT = cv2.FONT_HERSHEY_SIMPLEX


def _glyph_mask(shape, boxes, scores, classes, names, valid=None):
    """The label texts' boxes: the bounding box of cv2.putText's pixels
    and the box getTextSize gives (org.x .. org.x + width, org.y -
    height .. org.y + baseline), the port's strokes lie in the latter."""
    mask = np.zeros(shape[:2], bool)
    for i, b in enumerate(boxes):
        if valid is not None and not valid[i]:
            continue
        x1, y1 = (int(round(float(v))) for v in b[:2])
        label = f"{names[int(classes[i])]} {float(scores[i]):.2f}"
        t = np.zeros(shape[:2], np.uint8)
        cv2.putText(t, label, (x1 + 1, y1 - 4), FONT, 0.5, 255, 1,
                    cv2.LINE_AA)
        ys, xs = np.nonzero(t)
        if len(ys):
            mask[ys.min():ys.max() + 1, xs.min():xs.max() + 1] = True
        (tw, th), base = cv2.getTextSize(label, FONT, 0.5, 1)
        mask[max(y1 - 4 - th, 0):max(y1 - 3 + base, 0),
             max(x1 + 1, 0):max(x1 + 2 + tw, 0)] = True
    return mask


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("channels", [3, 1])
def test_draw_detections_matches_cv2_outside_glyphs(seed, channels):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(60, 200)), int(rng.integers(60, 240))
    img = rng.integers(0, 256, (h, w, channels), np.uint8)
    n = 6
    x1 = rng.uniform(-20, w, n)
    y1 = rng.uniform(-20, h, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, w / 2, n),
                      y1 + rng.uniform(0, h / 2, n)], -1)
    boxes[0] = [0, 0, w, h]          # clipped to the frame
    boxes[1, 2:] = boxes[1, :2]      # a zero-size box
    scores = rng.uniform(0, 1, n)
    names = VARIANTS["coco"].class_names
    classes = rng.integers(0, len(names), n)
    valid = rng.uniform(0, 1, n) < 0.8
    want = jviz.draw_detections(img, boxes, scores, classes, names, valid)
    got = viz.draw_detections(img, boxes, scores, classes, names, valid)
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.uint8
    outside = ~_glyph_mask(img.shape, boxes, scores, classes, names, valid)
    assert outside.mean() > 0.5
    np.testing.assert_array_equal(got[outside], want[outside])
    # the port's text is drawn: black strokes inside the glyph boxes
    assert (got[~outside] == 0).all(-1).any()


def test_advance_table_equals_cv2_text_size():
    rng = np.random.default_rng(0)
    printable = [chr(c) for c in range(32, 127)]
    texts = printable + ["".join(rng.choice(printable, int(k)))
                         for k in rng.integers(1, 30, 300)]
    names = {n for cfg in VARIANTS.values() for n in cfg.class_names}
    texts += [f"{n} {s:.2f}" for n in sorted(names)
              for s in (0.0, 0.05, 0.5, 0.99, 1.0)]
    for t in texts:
        (tw, th), _ = cv2.getTextSize(t, FONT, 0.5, 1)
        assert viz.text_size(t) == (tw, th), t


@pytest.mark.parametrize("shape", [(37, 53, 3), (64, 80, 1), (1, 1, 3)])
def test_png_round_trips_through_cv2(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "a.png")
    viz.save_image(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    back = back[..., ::-1] if shape[2] == 3 else back[..., None]
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("shape, smooth", [
    ((120, 160, 3), False), ((37, 53, 3), False), ((1, 1, 3), False),
    ((17, 9, 3), False), ((16, 16, 3), False), ((33, 47, 1), False),
    ((480, 640, 3), True), ((96, 128, 1), True)])
def test_jpeg_matches_cv2_imwrite(tmp_path, shape, smooth):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, shape, np.uint8)
    if smooth:   # a natural-image spectrum as well as noise
        img = cv2.GaussianBlur(img, (9, 9), 3).reshape(shape)
    want_path, got_path = str(tmp_path / "cv2.jpg"), str(tmp_path / "p.jpg")
    assert cv2.imwrite(want_path, img[..., ::-1] if shape[2] == 3
                       else img[..., 0])
    viz.save_image(got_path, img)
    want = cv2.imread(want_path, cv2.IMREAD_UNCHANGED).astype(np.int64)
    got = cv2.imread(got_path, cv2.IMREAD_UNCHANGED).astype(np.int64)
    assert int(np.abs(got - want).max()) <= 1
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        assert a.read() == b.read()


def test_save_image_refuses_what_it_cannot_write(tmp_path):
    """AVIF, which cv2 writes through a lossy encoder, is refused saying
    so; so are .j2k (cv2 5 has no encoder for it either) and a missing
    directory. JPEG 2000 (.jp2) and GIF are written since their encoders
    were ported (tests/test_torch_jp2_write.py,
    tests/test_torch_gif_write.py)."""
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(OSError, match=r"\.avif.*lossy encoder"):
        viz.save_image(str(tmp_path / "a.avif"), img)
    assert not os.path.exists(tmp_path / "a.avif")
    with pytest.raises(OSError, match="the port writes"):
        viz.save_image(str(tmp_path / "a.j2k"), img)
    assert not os.path.exists(tmp_path / "a.j2k")
    with pytest.raises(OSError):
        viz.save_image(str(tmp_path / "missing" / "a.png"), img)


@pytest.mark.parametrize("shape", [(7, 5, 3), (48, 64, 3), (480, 640, 3),
                                   (9, 11, 1)])
def test_apng_is_the_png_file(tmp_path, shape):
    """cv2.imwrite writes one image as .apng with its PNG encoder (the
    .apng and .png files are the same bytes); save_image's .apng is its
    own .png file, which cv2 reads back bit for bit (the port's PNG
    writer gives cv2's pixels, not libpng's deflate bytes)."""
    img = np.random.default_rng(11).integers(0, 256, shape, np.uint8)
    bgr = img[..., ::-1] if shape[2] == 3 else img[..., 0]
    assert cv2.imwrite(str(tmp_path / "cv2.apng"), bgr)
    assert cv2.imwrite(str(tmp_path / "cv2.png"), bgr)
    assert (tmp_path / "cv2.apng").read_bytes() == \
        (tmp_path / "cv2.png").read_bytes()
    viz.save_image(str(tmp_path / "p.apng"), img)
    viz.save_image(str(tmp_path / "p.png"), img)
    assert (tmp_path / "p.apng").read_bytes() == \
        (tmp_path / "p.png").read_bytes()
    back = cv2.imread(str(tmp_path / "p.apng"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, bgr)


@pytest.mark.parametrize("shape", [(7, 5, 3), (48, 64, 3), (480, 640, 3),
                                   (9, 11, 1)])
def test_pic_is_cv2s_hdr_file(tmp_path, shape):
    """cv2.imwrite writes .pic with its Radiance encoder: save_image gives
    cv2's bytes, which are the port's own .hdr file."""
    img = np.random.default_rng(12).integers(0, 256, shape, np.uint8)
    assert cv2.imwrite(str(tmp_path / "cv2.pic"), img[..., ::-1]
                       if shape[2] == 3 else img[..., 0])
    viz.save_image(str(tmp_path / "p.pic"), img)
    viz.save_image(str(tmp_path / "p.hdr"), img)
    data = (tmp_path / "p.pic").read_bytes()
    assert data == (tmp_path / "cv2.pic").read_bytes()
    assert data == (tmp_path / "p.hdr").read_bytes()


@pytest.mark.parametrize("ext", [".bmp", ".ppm", ".pgm", ".pnm"])
@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (16, 16, 3),
                                   (5, 9, 1), (6, 8)])
def test_bmp_and_pnm_match_cv2_imwrite(tmp_path, ext, shape):
    """save_image's BMP (24-bit bottom-up, or 8-bit with cv2's gray
    palette) and binary PGM / PPM are cv2.imwrite's bytes; a colour .pgm
    or a gray .ppm is refused as cv2 refuses it."""
    img = np.random.default_rng(5).integers(0, 256, shape, np.uint8)
    colour = len(shape) == 3 and shape[2] == 3
    want_path, got_path = str(tmp_path / f"cv2{ext}"), str(tmp_path /
                                                           f"p{ext}")
    try:
        wrote = cv2.imwrite(want_path, img[..., ::-1] if colour
                            else img.reshape(shape[:2]))
    except cv2.error:
        wrote = False
    if not wrote:
        with pytest.raises(OSError, match="cv2.imwrite refuses"):
            viz.save_image(got_path, img)
        return
    viz.save_image(got_path, img)
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        assert a.read() == b.read()


WRITER_SHAPES = [(1, 1, 3), (7, 13, 3), (16, 16, 3), (5, 9, 1), (6, 8),
                 (480, 640, 3)]


def _cv2_writes(path, img):
    colour = img.ndim == 3 and img.shape[2] == 3
    return cv2.imwrite(path, img[..., ::-1] if colour
                       else img.reshape(img.shape[:2]))


@pytest.mark.parametrize("ext", [".tif", ".tiff", ".pam", ".ras", ".sr",
                                 ".pfm", ".hdr"])
@pytest.mark.parametrize("shape", WRITER_SHAPES)
def test_tiff_pam_sunras_pfm_hdr_match_cv2_imwrite(tmp_path, ext, shape):
    """save_image's TIFF (libtiff's LZW and layout), PAM, Sun raster, PFM
    and HDR (rgbe.c's run-length scanlines) are cv2.imwrite's bytes. cv2
    pads an odd-length Sun raster row with the byte after it in memory:
    the next row's first, and for the last row a byte past the image,
    which the port writes as 0 and the comparison leaves out."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, shape, np.uint8)
    if shape[0] > 100:   # a frame's smooth regions as well as noise
        img = cv2.GaussianBlur(img, (9, 9), 3)
    want_path, got_path = str(tmp_path / f"cv2{ext}"), str(tmp_path /
                                                           f"p{ext}")
    assert _cv2_writes(want_path, img)
    viz.save_image(got_path, img)
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        got, want = a.read(), b.read()
    if ext in (".ras", ".sr") and (shape[1] * (shape[2] if len(shape) == 3
                                               else 1)) % 2:
        assert len(got) == len(want) and got[-1] == 0
        got, want = got[:-1], want[:-1]
    assert got == want


@pytest.mark.parametrize("kind", ["noise", "flat, then four levels"])
def test_tiff_strips_past_lzw_checkpoint_match_cv2(tmp_path, kind):
    """Rows of more than 8 KiB make strips of one row: noise fills
    libtiff's LZW table (a clear code each time), and a flat run then
    four levels drops the compression ratio at a checkpoint (every 10000
    input bytes), so that libtiff clears there too."""
    rng = np.random.default_rng(9)
    if kind == "noise":
        img = rng.integers(0, 256, (3, 4000, 3), np.uint8)
    else:
        img = np.full((1, 30000), 7, np.uint8)
        img[0, 11000:] = rng.integers(0, 4, 19000)
    want_path, got_path = str(tmp_path / "cv2.tif"), str(tmp_path / "p.tif")
    assert _cv2_writes(want_path, img)
    viz.save_image(got_path, img)
    with open(got_path, "rb") as a, open(want_path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", range(14))
def test_webp_every_predictor_mode_reads_back(mode):
    """Each of VP8L's 14 predictor modes, forced on every tile of a
    smooth picture, reads back exactly in cv2 and in the port."""
    from yolo_tpu_torch.data.webp import decode_webp, encode_webp

    img = cv2.GaussianBlur(np.random.default_rng(mode).integers(
        0, 256, (37, 53, 3), np.uint8), (5, 5), 2)
    data = encode_webp(img, predictor=mode)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        [..., ::-1], img)
    np.testing.assert_array_equal(decode_webp(data), img)


@pytest.mark.parametrize("shape", WRITER_SHAPES[:-1] + ["smooth",
                                                         "annotated"])
def test_webp_is_lossless_and_near_cv2s_size(tmp_path, shape):
    """save_image's .webp is a lossless VP8L file that cv2.imread and the
    port read back to the written pixels; on the annotated 480x640 frame
    it is at most 1.5x cv2.imwrite's file (PERF.md records the ratio)."""
    from yolo_tpu_torch.native.preproc import decode_image

    if shape == "annotated":   # the frame tools/writer_sizes.py measures
        from tools.writer_sizes import annotated_frame

        img = annotated_frame()
    elif shape == "smooth":   # every predictor mode, the colour cache
        img = cv2.GaussianBlur(np.random.default_rng(8).integers(
            0, 256, (120, 160, 3), np.uint8), (9, 9), 3)
        img[40:80:2, 30:90] = img[:20, :60]
    else:
        img = np.random.default_rng(8).integers(0, 256, shape, np.uint8)
    path, ref = str(tmp_path / "p.webp"), str(tmp_path / "cv2.webp")
    viz.save_image(path, img)
    with open(path, "rb") as f:
        assert f.read()[12:16] == b"VP8L"
    rgb = img if img.ndim == 3 and img.shape[2] == 3 else np.repeat(
        img.reshape(img.shape[0], img.shape[1], 1), 3, 2)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], rgb)
    np.testing.assert_array_equal(decode_image(path), rgb)
    if shape == "annotated":
        assert _cv2_writes(ref, img)
        assert os.path.getsize(path) <= 1.5 * os.path.getsize(ref)
