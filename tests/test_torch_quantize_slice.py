"""The whole int8 forward of the port against the JAX package's, on the
CPU: the JAX package's int8 params (yolo_tpu.models.quantize.prepare_int8,
chained and not) carried across by Darknet / params_from_numpy, on
tiny-voc, yolov3-tiny, YOLOv2-COCO, tiny-coco and yolov4-tiny at 128, in
fp32 and in bf16 (the input rounded to bf16, as the CLI's letterbox
hands it over). The port's forward takes the fused route (conv 0 and the
maxpool after it in one s8 call, Darknet.fused_pools) wherever the net
has one; yolov4-tiny's conv 0 (3x3/2) has no pool to fuse.

Tolerances: the logits equal (the int8 sums are exact, and the port's
plain block repeats the JAX block's fp32 arithmetic operation by
operation on these leaky and linear nets); detections at conf 0.3 with
equal valid flags and classes, scores within 1e-6 and boxes within 1e-5
(the two decodes' sigmoid and exp differ in the last bit; the decode's
own parity bounds). The module-level parity tests are in
tests/test_torch_quantize.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.configs import get_variant as jget_variant
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.models import predict as jpredict
from yolo_tpu.models import quantize as jq
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.models.graph import Darknet
from yolo_tpu_torch.models.predict import detect, forward

torch.set_num_threads(1)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", ["tiny-voc", "yolov3-tiny", "coco",
                                  "tiny-coco", "yolov4-tiny"])
def test_int8_forward_matches_jax(name):
    """The JAX package's int8 params (prepare_int8, chained and not) run
    through both packages' whole int8 forward, in fp32 and in bf16 (input
    rounded to bf16 as the letterbox hands it over): equal logits; and
    the detections at conf 0.3 alike (valid flags and classes equal,
    scores within 1e-6, boxes within 1e-5)."""
    jcfg = jget_variant(name, input_size=128)
    cfg = get_variant(name, input_size=128)
    rng = np.random.default_rng(16)
    raw = jdw.random_params(jcfg.layers, rng, scale=0.03)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    for chain in (False, True):
        q = jq.prepare_int8(jcfg, raw, jnp.asarray(x), chain=chain)
        q_np = [{k: np.asarray(v) for k, v in p.items()} for p in q]
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            xin = jnp.asarray(x, jdt)
            want = _tuple(jpredict.forward(jcfg, q, xin, compute_dtype=jdt))
            net = Darknet(cfg.layers, q_np, device="cpu", dtype=tdt)
            assert net.fused_pools == ({} if name == "yolov4-tiny"
                                       else {0: (2, 2)})
            got = _tuple(forward(cfg, net, torch.from_numpy(
                np.asarray(xin.astype(jnp.float32)))))
            for a, b in zip(want, got):
                np.testing.assert_array_equal(
                    b.numpy(), np.asarray(a), err_msg=f"{chain} {tdt}")
            jd = jpredict.detect(jcfg, q, xin, compute_dtype=jdt,
                                 conf_threshold=0.3, head="reference",
                                 nms_impl="xla")
            td = detect(cfg, net, torch.from_numpy(
                np.asarray(xin.astype(jnp.float32))), conf_threshold=0.3,
                head="reference", nms_impl="torch")
            for k in ("valid", "classes"):
                np.testing.assert_array_equal(td[k].numpy(),
                                              np.asarray(jd[k]), err_msg=k)
            # equal logits; the decodes' sigmoid and exp may differ in
            # the last bit (the decode's own parity bounds)
            np.testing.assert_allclose(td["scores"].numpy(),
                                       np.asarray(jd["scores"]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(td["boxes"].numpy(),
                                       np.asarray(jd["boxes"]), rtol=0,
                                       atol=1e-5)
