"""The port's darknet `detector recall` (yolo_tpu_torch/eval/recall.py)
against the JAX package's, on the CPU: every test of tests/test_recall.py
runs again with the port's module (and the port's CLI) in the JAX one's
place; the objectness decode of each head family equals JAX's on the
same logits (fp32: boxes and objectness within 1e-6); recall_detector
gives the same counts, rates within 1e-6, and the same per-image lines."""

import io

import numpy as np
import pytest
import torch

import tests.test_recall as jrecall
import yolo_tpu
import yolo_tpu.cli  # noqa: F401  (the attribute the tests swap)
from tests.torch_port import (PortCli, he_weights, jax_test_names,
                              rerun_jax_test, to_jax_config, to_port_config)
from yolo_tpu.eval import recall as jr
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.eval import recall as tr


class _PortRecall:
    """yolo_tpu_torch.eval.recall behind the JAX module's names: configs
    and numpy logits in, numpy out."""
    nms_objectness = staticmethod(tr.nms_objectness)
    recall_image = staticmethod(tr.recall_image)
    _gt_net_norm = staticmethod(tr._gt_net_norm)
    DEFAULT_THRESH = tr.DEFAULT_THRESH

    @staticmethod
    def decode_boxes_objectness(cfg, logits):
        if isinstance(logits, (list, tuple)):
            t = [torch.from_numpy(np.asarray(l)) for l in logits]
        else:
            t = torch.from_numpy(np.asarray(logits))
        boxes, obj = tr.decode_boxes_objectness(to_port_config(cfg), t)
        return boxes.numpy(), obj.numpy()


@pytest.mark.parametrize("name", jax_test_names(jrecall))
def test_port_passes_jax_recall_test(name, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(jrecall, "rc", _PortRecall)
    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(jrecall, name, {"tmp_path": tmp_path, "capsys": capsys,
                                   "monkeypatch": monkeypatch})


def _logits(cfg, rng):
    h, w = cfg.grid_hw
    if cfg.head_kind == "region":
        return rng.normal(0, 2, (2, h, w, len(cfg.anchors)
                                 * (5 + cfg.num_classes))).astype(np.float32)
    out = []   # any grid per head: the decode takes the logits' own
    for s, hd in zip((32, 16, 8), cfg.yolo_heads):
        ch = len(hd.mask) * ((9 if hd.gaussian else 5) + cfg.num_classes)
        gh, gw = h * 32 // s, w * 32 // s
        lo = rng.uniform(0, 1, (2, gh, gw, ch)) if hd.new_coords else \
            rng.normal(0, 2, (2, gh, gw, ch))
        out.append(lo.astype(np.float32))
    return out


@pytest.mark.parametrize("variant, heads", [
    ("tiny-voc", None), ("coco", None), ("yolov3-tiny", None),
    ("yolov3", "gaussian"), ("yolov4", "new_coords")])
def test_decode_boxes_objectness_matches_jax(variant, heads):
    import dataclasses

    cfg = get_variant(variant, input_size=128)
    if heads:
        layers = tuple(dataclasses.replace(l, **{heads: True})
                       if type(l).__name__ == "YoloHead" else l
                       for l in cfg.layers)
        cfg = dataclasses.replace(cfg, layers=layers)
    if cfg.head_kind == "yolo":
        assert len(cfg.yolo_heads) <= 3
    logits = _logits(cfg, np.random.default_rng(0))
    jb, jo = jr.decode_boxes_objectness(to_jax_config(cfg), logits)
    tl = ([torch.from_numpy(l) for l in logits] if isinstance(logits, list)
          else torch.from_numpy(logits))
    tb, to = tr.decode_boxes_objectness(cfg, tl)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("resize", ["letterbox", "stretch"])
def test_recall_detector_matches_jax(tmp_path, resize):
    import jax.numpy as jnp

    from yolo_tpu.models import graph as jgraph
    from yolo_tpu_torch.data.synthetic import write_voc_scenes
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.models.graph import fold_params

    cfg = get_variant("tiny-voc", input_size=96)
    path = str(tmp_path / "w.weights")
    he_weights(cfg, path, box_scale=0.1, objectness_shift=-2.0)
    params, _ = dw.load(path, cfg.layers)
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    samples = write_voc_scenes(str(tmp_path), [(90, 120), (120, 90)] * 3,
                               np.random.default_rng(4), difficult=0.2)
    jout, tout = io.StringIO(), io.StringIO()
    want = jr.recall_detector(to_jax_config(cfg),
                              jgraph.params_to_jax(folded), samples,
                              batch=4, compute_dtype=jnp.float32,
                              resize=resize, out=jout)
    got = tr.recall_detector(cfg, folded, samples, batch=4, resize=resize,
                             out=tout, device="cpu")
    assert want["total"] > 0 and want["proposals"] > 0
    for k in ("correct", "total", "proposals", "images"):
        assert got[k] == want[k]
    for k in ("recall", "avg_iou", "proposals_per_img"):
        assert abs(got[k] - want[k]) <= 1e-6
    assert tout.getvalue() == jout.getvalue()
