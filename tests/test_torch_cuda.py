"""CUDA kernels of yolo_tpu_torch against their plain PyTorch versions,
on the card. Marked ``cuda``; every test skips without a CUDA device.
Run on a GPU machine (no JAX needed there):

    YOLO_TPU_TEST_BACKEND=cuda python -m pytest tests/test_torch_cuda.py -m cuda

Keep masks must be identical: the kernel computes the IoU in the plain
version's operation order, with IEEE division and no FMA contraction."""

import numpy as np
import pytest
import torch

from yolo_tpu_torch.ops.cuda import nms_kernel
from yolo_tpu_torch.ops.nms import _geom, _suppress, _suppress_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(seed, g, k, n_classes, device):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k))], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (g, k)), axis=1).astype(np.float32)
    classes = rng.integers(0, n_classes, (g, k)).astype(np.float32)
    return (_geom(torch.from_numpy(boxes).to(device)).contiguous(),
            torch.from_numpy(scores).to(device),
            torch.from_numpy(classes).to(device))


@pytest.mark.parametrize("g,k,n_classes", [
    (1, 128, 5), (1, 256, 5), (32, 128, 5), (32, 256, 80), (2560, 128, 1),
    (7, 100, 3), (3, 1, 1), (5, 33, 2)])
def test_suppress_kernel_matches_plain(cuda, g, k, n_classes):
    geom, scores, classes = _rows(g * 1000 + k, g, k, n_classes, cuda)
    before = nms_kernel.launches
    got = nms_kernel.suppress(geom, scores, classes, conf_threshold=0.3,
                              iou_threshold=0.45)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    want = _suppress_torch(geom, scores, classes, 0.3, 0.45)
    assert got.dtype == torch.float32 and got.device == geom.device
    assert torch.equal(got, want)


def test_router_takes_the_kernel_on_cuda(cuda):
    geom, scores, classes = _rows(1, 4, 128, 3, cuda)
    before = nms_kernel.launches
    got = _suppress(geom, scores, classes.to(torch.int32), 0.3, 0.45,
                    use_kernel=True)
    assert nms_kernel.launches == before + 1
    assert torch.equal(got, _suppress_torch(geom, scores, classes, 0.3, 0.45))


@pytest.mark.parametrize("bad", ["k", "dtype", "contiguous", "device"])
def test_suppress_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    geom, scores, classes = _rows(2, 2, 300 if bad == "k" else 64, 2, cuda)
    if bad == "dtype":
        scores = scores.double()
    elif bad == "contiguous":
        geom = geom.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "device":
        classes = classes.cpu()
    with pytest.raises(ValueError):
        nms_kernel.suppress(geom, scores, classes, conf_threshold=0.3,
                            iou_threshold=0.45)
