"""The port's host letterbox (native/letterbox.c through
native/preproc.py::letterbox_batch) against the JAX package's native
letterbox_batch, byte for byte, on the shapes of tests/test_native.py and
tests/test_rect.py, the half-to-even geometry case and a gray image; its
threads against one; and within 5e-6 of the port's device letterbox
(ops/letterbox.py, two fp32 interpolation matmuls). The loaders that
letterbox on the host (data/pipeline.py::_host_resize,
decode_letterbox_batch) give the same bytes."""

import numpy as np
import pytest
import torch

from yolo_tpu.native import preproc as jpreproc
from yolo_tpu_torch.data.pipeline import _host_resize
from yolo_tpu_torch.native import preproc
from yolo_tpu_torch.ops.letterbox import letterbox


@pytest.fixture(scope="module")
def jax_native():
    if not jpreproc.available():
        pytest.skip("the JAX package's native library does not build here")
    return jpreproc


CASES = [((480, 640), 416, 3), ((640, 480), 416, 3), ((416, 416), 416, 3),
         ((100, 300), 416, 3), ((77, 53), 416, 3), ((77, 131), (128, 192), 3),
         ((417, 832), 416, 3), ((97, 133), 224, 1)]


@pytest.mark.parametrize("shape, net, c", CASES,
                         ids=[f"{s[0]}x{s[1]}-{n}-c{c}" for s, n, c in CASES])
def test_letterbox_batch_byte_equal_to_jax(jax_native, shape, net, c):
    rng = np.random.default_rng(sum(shape) + c)
    imgs = rng.integers(0, 256, (3, *shape, c), dtype=np.uint8)
    want = jax_native.letterbox_batch(imgs, net)
    got = preproc.letterbox_batch(imgs, net)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # one image on the loaders' path: the same bytes
    np.testing.assert_array_equal(_host_resize(imgs[1], net, "letterbox"),
                                  want[1])


def test_threads_equal_one_thread():
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (16, 97, 133, 3), dtype=np.uint8)
    a = preproc.letterbox_batch(imgs, 224, n_threads=1)
    b = preproc.letterbox_batch(imgs, 224, n_threads=8)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("shape, net", [((200, 320), 416),
                                        ((77, 131), (128, 192))])
def test_within_device_letterbox(shape, net):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    got = preproc.letterbox_batch(imgs, net)
    want = letterbox(torch.from_numpy(imgs), net, dtype=torch.float32)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=5e-6)


def test_refuses_other_channel_counts():
    assert preproc.available()
    with pytest.raises(ValueError, match="2 channels"):
        preproc.letterbox_batch(np.zeros((1, 8, 8, 2), np.uint8), 32)
    with pytest.raises(ValueError, match="B, H, W, C"):
        preproc.letterbox_batch(np.zeros((8, 8, 3), np.uint8), 32)


def test_decode_letterbox_batch_equals_jax(jax_native, tmp_path):
    """The file loader: decode (JPEG and PNG) + the C letterbox, against
    the JAX package's decode + letterbox in C++ (both decoders give
    cv2.imread's bytes), with a file that does not decode."""
    from yolo_tpu_torch.native.preproc import encode_jpeg

    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate(((120, 200), (90, 61))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(encode_jpeg(img))
    paths.append(str(tmp_path / "missing.jpg"))
    want = jax_native.decode_letterbox_batch(paths, (96, 128), n_threads=2)
    got = preproc.decode_letterbox_batch(paths, (96, 128), n_threads=2)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1][:2], want[1][:2])
    np.testing.assert_array_equal(got[0][:2].view(np.uint32),
                                  want[0][:2].view(np.uint32))
