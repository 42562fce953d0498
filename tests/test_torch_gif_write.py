"""save_image's GIF writer (data/gif.py::encode_gif around
native/gif_enc.c) against cv2.imwrite, which writes .gif with OpenCV 5's
own encoder (the fixed 3-3-2 palette, Floyd-Steinberg diffusion, LZW):

  * the same bytes as cv2.imencode('.gif', img[..., ::-1]) at its
    defaults: one pixel, one row, one column, odd sizes, 480x640; noise,
    ramps (the diffusion's carries along and across rows), flat areas at
    and beside the palette's rounding thresholds, saturated extremes and
    an annotated fixture frame;
  * the port's decode_image reads each file as cv2.imdecode reads it;
  * the JAX package's save_image (cv2) writes the same bytes;
  * gray images and sides past 65535 raise OSError and leave no file,
    as cv2.imwrite refuses them;
  * the gradient frame pinned in tests/data/torch_jpeg/written_hashes.json,
    which chip_smoke.py holds the card host's build to."""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from yolo_tpu.utils import viz as jviz
from yolo_tpu_torch.configs import COCO_NAMES
from yolo_tpu_torch.data.gif import PALETTE, encode_gif
from yolo_tpu_torch.data.synthetic import gradient_frame
from yolo_tpu_torch.native.preproc import decode_image, decode_image_bytes
from yolo_tpu_torch.utils import viz

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_jpeg")
HASHES = os.path.join(DATA, "written_hashes.json")


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _flat(h, w, rgb):
    return np.full((h, w, 3), rgb, np.uint8)


def _ramp(h, w, seed, amp):
    """Ramps of seeded slopes with noise of +-amp."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * int(rng.integers(1, 5)),
                     yy * int(rng.integers(1, 5)), xx + yy], -1) % 256
    return np.clip(base + rng.integers(-amp, amp + 1, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _annotated_fixture():
    """A 333x517 fixture frame with seeded boxes drawn on it."""
    frame = decode_image(os.path.join(DATA, "420_q95_333x517.jpg"))
    rng = np.random.default_rng(7)
    n = 8
    xy = rng.uniform(0, 400, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(16, 120, (n, 2))], 1)
    return viz.draw_detections(frame, boxes.astype(np.float32),
                               rng.uniform(0.1, 1.0, n),
                               rng.integers(0, 80, n), COCO_NAMES)


CASES = {
    "noise_1x1": lambda: _noise((1, 1, 3), 1),
    "noise_1x67": lambda: _noise((1, 67, 3), 2),
    "noise_59x1": lambda: _noise((59, 1, 3), 3),
    "noise_37x53": lambda: _noise((37, 53, 3), 4),
    "noise_480x640": lambda: _noise((480, 640, 3), 5),
    "ramp_64x80": lambda: _ramp(64, 80, 6, 0),
    "ramp_noise4_97x131": lambda: _ramp(97, 131, 7, 4),
    # a lone pixel rounds up at 18 + 36 k (R, G) and 43, 128, 213 (B)
    "flat_at_ties_20x30": lambda: _flat(20, 30, (18, 234, 43)),
    "flat_below_ties_20x30": lambda: _flat(20, 30, (17, 233, 127)),
    "flat_above_ties_20x30": lambda: _flat(20, 30, (19, 91, 214)),
    "extremes_41x29": lambda: (_noise((41, 29, 3), 8) // 128 * 255
                               ).astype(np.uint8),
    "gradient_480x640": lambda: gradient_frame(480, 640, 0, 20),
    "annotated_fixture_333x517": _annotated_fixture,
}
READ_BACK = ("noise_1x1", "noise_1x67", "noise_37x53", "ramp_noise4_97x131",
             "flat_at_ties_20x30", "annotated_fixture_333x517")


def _cv2_bytes(img) -> bytes:
    ok, data = cv2.imencode(".gif", np.ascontiguousarray(img[..., ::-1]))
    assert ok
    return data.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gif_is_cv2_imwrites_bytes(tmp_path, case):
    img = CASES[case]()
    path = str(tmp_path / "port.gif")
    viz.save_image(path, img)
    with open(path, "rb") as f:
        assert f.read() == _cv2_bytes(img)


@pytest.mark.parametrize("case", READ_BACK)
def test_gif_reads_back_as_cv2_reads_it(tmp_path, case):
    """The written file through the port's decoder and cv2.imdecode, at 3
    channels and at 1: palette colours, on these frames within two
    levels' steps of the source's."""
    img = CASES[case]()
    data = encode_gif(img)
    buf = np.frombuffer(data, np.uint8)
    got = decode_image_bytes(data)
    np.testing.assert_array_equal(
        got, cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(
        decode_image_bytes(data, channels=1)[..., 0],
        cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
    assert np.isin(got.reshape(-1, 3).view("V3"), PALETTE.view("V3")).all()
    assert (np.abs(got.astype(int) - img) <= [72, 72, 170]).all()


@pytest.mark.parametrize("case", ["noise_37x53", "annotated_fixture_333x517"])
def test_gif_is_the_jax_save_images_bytes(tmp_path, case):
    img = CASES[case]()
    want, got = str(tmp_path / "jax.gif"), str(tmp_path / "port.gif")
    jviz.save_image(want, img)
    viz.save_image(got, img)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("shape", [(6, 7), (6, 7, 1), (1, 65536, 3)])
def test_gif_refuses_what_cv2_refuses(tmp_path, shape):
    """cv2 refuses gray (an assertion in its ditheringKernel) and a side
    past GIF's 16 bits: the port raises OSError and writes nothing."""
    img = np.zeros(shape, np.uint8)
    try:
        ok, _ = cv2.imencode(".gif", img)
    except cv2.error:
        ok = False
    assert not ok
    path = str(tmp_path / "port.gif")
    with pytest.raises(OSError, match="gray" if len(shape) < 3 or
                       shape[2] == 1 else "65535"):
        viz.save_image(path, img)
    assert not os.path.exists(path)


def test_gif_gradient_frame_is_pinned():
    """The pinned frame: cv2's bytes here and the port's have the
    recorded hash."""
    with open(HASHES) as f:
        pin = json.load(f)["gif"]
    img = gradient_frame(*pin["shape"], pin["noise"], pin["seed"])
    want = _cv2_bytes(img)
    assert hashlib.sha256(want).hexdigest() == pin["sha256"]
    assert len(want) == pin["bytes"]
    assert hashlib.sha256(encode_gif(img)).hexdigest() == pin["sha256"]
