"""yolo_tpu_torch NMS (suppression, nms_batch, fused head) against the
JAX package on the CPU.

The suppression pass is compared with the JAX Pallas kernel run in
interpret mode (greedy) and with JAX _suppress_xla (DIoU, which the
kernel does not take). Both get the same geometry, so keep masks must be
identical. nms_batch gets the same boxes and scores in both packages, so
its outputs must be identical too (boxes to 1e-6: the xywh -> xyxy
arithmetic is the same, the gather differs). detect_head starts from
logits: sigmoid, exp and softmax may differ in the last ulp between XLA
and PyTorch, so scores and boxes agree to 1e-5 and the kept set exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from yolo_tpu.ops import head as jhead
from yolo_tpu.ops import nms as jnms
from yolo_tpu.ops.pallas import nms_kernel as jkernel
from yolo_tpu_torch.ops import head as thead
from yolo_tpu_torch.ops import nms as tnms
from yolo_tpu_torch.ops.cuda import nms_kernel as tkernel

torch.set_num_threads(1)


def _candidates(seed, g, k, n_classes):
    """(G, K) candidate rows in a crowded scene: many overlapping boxes,
    few classes, scores sorted desc (as the heads hand them over)."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0.2, 0.8, (g, k)),
                      rng.uniform(0.2, 0.8, (g, k)),
                      rng.uniform(0.05, 0.4, (g, k)),
                      rng.uniform(0.05, 0.4, (g, k))], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (g, k)), axis=1).astype(np.float32)
    classes = rng.integers(0, n_classes, (g, k)).astype(np.int32)
    return boxes, scores, classes


def _scene(seed, b=2, n=60, c=5):
    """tests/test_nms_impls.py::_scene (sparse scores)."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([
        rng.uniform(0.1, 0.9, (b, n)), rng.uniform(0.1, 0.9, (b, n)),
        rng.uniform(0.05, 0.3, (b, n)), rng.uniform(0.05, 0.3, (b, n)),
    ], -1).astype(np.float32)
    scores = (rng.uniform(0, 1, (b, n, c)) ** 3).astype(np.float32)
    return boxes, scores


def _assert_dets_equal(want, got, atol=0.0):
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(v, got["valid"].numpy())
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=atol)
    np.testing.assert_array_equal(got["classes"].numpy()[v],
                                  np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["boxes"].numpy()[v],
                               np.asarray(want["boxes"])[v], rtol=0,
                               atol=max(atol, 1e-6))


def test_geom_matches_jax():
    boxes, _, _ = _candidates(0, 3, 40, 2)
    np.testing.assert_array_equal(tnms._geom(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(jnms._geom(jnp.asarray(boxes))))


@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("n_classes", [1, 3])
def test_suppress_matches_pallas_kernel(k, n_classes):
    boxes, scores, classes = _candidates(k + n_classes, 3, k, n_classes)
    geom = np.array(jnms._geom(jnp.asarray(boxes)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkernel.suppress(
            jnp.asarray(geom), jnp.asarray(scores),
            jnp.asarray(classes, jnp.float32), conf_threshold=0.3,
            iou_threshold=0.45))
    got = tnms._suppress_torch(torch.from_numpy(geom),
                               torch.from_numpy(scores),
                               torch.from_numpy(classes.astype(np.float32)),
                               0.3, 0.45)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # some boxes are suppressed and some kept: the case is not trivial
    assert 0 < want.sum() < (scores >= 0.3).sum()
    # on a CPU tensor the kernel's wrapper takes the plain version
    before = tkernel.launches
    via_wrapper = tkernel.suppress(
        torch.from_numpy(geom), torch.from_numpy(scores),
        torch.from_numpy(classes.astype(np.float32)), conf_threshold=0.3,
        iou_threshold=0.45)
    np.testing.assert_array_equal(via_wrapper.numpy(), want)
    assert tkernel.launches == before


@pytest.mark.parametrize("k", [128, 256])
def test_suppress_diou_matches_xla(k):
    boxes, scores, classes = _candidates(7 + k, 4, k, 2)
    geom = np.array(jnms._geom(jnp.asarray(boxes)))
    want = np.asarray(jnms._suppress_xla(
        jnp.asarray(geom), jnp.asarray(scores), jnp.asarray(classes), 0.25,
        0.45, kind="diou", beta=0.6))
    got = tnms._suppress_torch(torch.from_numpy(geom),
                               torch.from_numpy(scores),
                               torch.from_numpy(classes), 0.25, 0.45,
                               kind="diou", beta=0.6)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = tnms._suppress_torch(torch.from_numpy(geom),
                                  torch.from_numpy(scores),
                                  torch.from_numpy(classes), 0.25, 0.45)
    assert not torch.equal(got, greedy)  # DIoU is a different metric


def test_suppress_router_sends_diou_and_large_k_to_plain_path():
    boxes, scores, classes = _candidates(3, 2, 300, 2)
    geom = tnms._geom(torch.from_numpy(boxes))
    s, c = torch.from_numpy(scores), torch.from_numpy(classes)
    for kind, kk in (("greedy", 300), ("diou", 64)):
        want = tnms._suppress_torch(geom[..., :kk], s[:, :kk], c[:, :kk],
                                    0.3, 0.45, kind=kind)
        got = tnms._suppress(geom[..., :kk], s[:, :kk], c[:, :kk], 0.3, 0.45,
                             use_kernel=True, kind=kind)
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["greedy", "diou"])
@pytest.mark.parametrize("impl,jax_impl", [
    ("torch", "xla"), ("cuda", "pallas"), ("fused_torch", "fused_xla"),
    ("fused", "fused")])
def test_nms_batch_matches_jax(impl, jax_impl, kind):
    boxes, scores = _scene(0)
    kw = dict(conf_threshold=0.3, iou_threshold=0.45, top_k=scores.shape[1],
              max_detections=64, kind=kind)
    with pltpu.force_tpu_interpret_mode():
        want = jnms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores),
                              impl=jax_impl, **kw)
    got = tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                         impl=impl, **kw)
    assert got["classes"].dtype == torch.int32
    assert int(got["valid"].sum()) > 5
    _assert_dets_equal(want, got)


def test_nms_batch_auto_is_exact_per_class_on_cpu():
    boxes, scores = _scene(1, b=3, c=4)
    kw = dict(conf_threshold=0.2, iou_threshold=0.5, top_k=scores.shape[1],
              max_detections=32)
    want = tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                          impl="torch", **kw)
    got = tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                         impl="auto", **kw)
    for key in want:
        assert torch.equal(want[key], got[key])
    with pytest.raises(ValueError, match="unknown NMS impl"):
        tnms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                       impl="pallas", **kw)


def test_top_k_orders_ties_by_index():
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    values, idx = tnms._top_k(x, 5)
    assert idx.tolist() == [[1, 3, 0, 2, 5]]
    assert values[0].tolist() == pytest.approx([0.9, 0.9, 0.5, 0.5, 0.5])


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("pre_top_k,conf", [(128, 0.3), (256, 0.15)])
def test_detect_head_matches_jax(use_kernel, pre_top_k, conf):
    """COCO's head width (5 anchors x 85) on a 13x13 grid."""
    rng = np.random.default_rng(pre_top_k)
    logits = rng.normal(0, 2, (2, 13, 13, 5 * 85)).astype(np.float32)
    anchors = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
               (7.88282, 3.52778), (9.77052, 9.16828))
    kw = dict(conf_threshold=conf, iou_threshold=0.45, pre_top_k=pre_top_k,
              max_detections=100)
    with pltpu.force_tpu_interpret_mode():
        want = jhead.detect_head(jnp.asarray(logits), anchors, 80,
                                 use_pallas=True, **kw)
    got = thead.detect_head(torch.from_numpy(logits), anchors, 80,
                            use_kernel=use_kernel, **kw)
    assert int(got["valid"].sum()) > 10
    _assert_dets_equal(want, got, atol=1e-5)
