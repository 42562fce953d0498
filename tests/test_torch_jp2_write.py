"""save_image's JPEG 2000 writer (data/jp2.py::encode_jp2 around
native/j2k_enc.c) against cv2.imwrite, which writes .jp2 through
OpenJPEG 2.5.3 (5/3, one layer at a compression ratio of 4):

  * the same bytes as cv2.imwrite(path, img[..., ::-1]) (gray:
    img[..., 0]) for frames that fit whole (lossless) and frames that
    OpenJPEG's rate allocation cuts, colour and gray, 32x32 to 480x640,
    odd sizes, and an annotated fixture frame;
  * the port's decode_image reads each file as cv2.imread reads it;
  * the JAX package's save_image (cv2) writes the same bytes;
  * images under 32 pixels a side raise OSError and leave no file, as
    cv2.imwrite refuses them;
  * the cut frame pinned in tests/data/torch_jpeg/written_hashes.json,
    which chip_smoke.py holds the card host's build to."""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from yolo_tpu.utils import viz as jviz
from yolo_tpu_torch.configs import COCO_NAMES
from yolo_tpu_torch.data.jp2 import encode_jp2
from yolo_tpu_torch.data.synthetic import gradient_frame
from yolo_tpu_torch.native.preproc import decode_image
from yolo_tpu_torch.utils import viz

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_jpeg")
HASHES = os.path.join(DATA, "written_hashes.json")


def _pinned():
    with open(HASHES) as f:
        return json.load(f)["jp2"]


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


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
    # three ramps: fits whole at rate 4, decodes exactly
    "gradient_480x640": lambda: gradient_frame(480, 640, 0, 20),
    # the same with noise of +-8: cut by the rate allocation
    "gradient_noise8_480x640": lambda: gradient_frame(480, 640, 8, 20),
    "noise_64x80": lambda: _noise((64, 80, 3), 1),
    "noise_32x32": lambda: _noise((32, 32, 3), 2),
    "noise_33x40": lambda: _noise((33, 40, 3), 3),
    "noise_37x53": lambda: _noise((37, 53, 3), 4),
    "gray_noise_40x56": lambda: _noise((40, 56, 1), 5),
    "gray_blur_96x128": lambda: cv2.GaussianBlur(
        _noise((96, 128), 6), (9, 9), 3)[..., None],
    "annotated_fixture_333x517": _annotated_fixture,
}


def _cv2_write(path, img):
    return cv2.imwrite(path, img[..., ::-1] if img.shape[2] == 3
                       else img[..., 0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_jp2_is_cv2_imwrites_bytes(tmp_path, case):
    img = CASES[case]()
    want, got = str(tmp_path / "cv2.jp2"), str(tmp_path / "port.jp2")
    assert _cv2_write(want, img)
    viz.save_image(got, img)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_jp2_reads_back_as_cv2_reads_it(tmp_path, case):
    """The written file through the port's decoder and cv2.imread, at 3
    channels and at 1; lossless where it fits whole."""
    img = CASES[case]()
    path = str(tmp_path / "port.jp2")
    viz.save_image(path, img)
    np.testing.assert_array_equal(decode_image(path),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(
        decode_image(path, channels=1)[..., 0],
        cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    if case == "gradient_480x640":
        np.testing.assert_array_equal(decode_image(path), img)


@pytest.mark.parametrize("case", ["gradient_noise8_480x640", "noise_37x53"])
def test_jp2_is_the_jax_save_images_bytes(tmp_path, case):
    img = CASES[case]()
    want, got = str(tmp_path / "jax.jp2"), str(tmp_path / "port.jp2")
    jviz.save_image(want, img)
    viz.save_image(got, img)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("shape", [(31, 40, 3), (17, 64, 3), (32, 17, 3),
                                   (20, 20, 1)])
def test_jp2_refuses_what_cv2_refuses(tmp_path, shape):
    """Under 32 pixels a side OpenJPEG cannot make 5 resolutions: cv2
    writes nothing, the port raises OSError and writes nothing."""
    img = _noise(shape, 8)
    want = str(tmp_path / "cv2.jp2")
    try:
        wrote = _cv2_write(want, img)
    except cv2.error:
        wrote = False
    assert not wrote
    path = str(tmp_path / "port.jp2")
    with pytest.raises(OSError, match="32 pixels"):
        viz.save_image(path, img)
    assert not os.path.exists(path)


def test_jp2_cut_frame_is_pinned():
    """The pinned cut frame: cv2's bytes here and the port's have the
    recorded hash, and the frame is cut (the file does not decode to
    it)."""
    pin = _pinned()
    img = gradient_frame(*pin["shape"], pin["noise"], pin["seed"])
    ok, cv2_bytes = cv2.imencode(".jp2", img[..., ::-1])
    assert ok
    cv2_bytes = cv2_bytes.tobytes()
    assert hashlib.sha256(cv2_bytes).hexdigest() == pin["sha256"]
    assert len(cv2_bytes) == pin["bytes"]
    port = encode_jp2(img)
    assert hashlib.sha256(port).hexdigest() == pin["sha256"]
    assert not np.array_equal(cv2.imdecode(np.frombuffer(port, np.uint8),
                                           cv2.IMREAD_COLOR)[..., ::-1], img)
