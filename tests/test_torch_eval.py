"""The port's evaluation (yolo_tpu_torch.eval, make_detector_preprocessed)
against the JAX package on the CPU.

Both packages score the same folded weights (tiny-yolov2-voc at 96x96,
seeded He weights shaped like a trained detector's) on the same seeded
PNG scenes. fp32 in both, so the kept sets (valid flags, classes) are
exact; scores agree to 1e-5, pixel boxes to 1e-3 and mAP to 1e-4. The
port preprocesses with its fp32 letterbox and un-letterboxes in fp32 on
the device; JAX letterboxes with cv2 semantics and un-letterboxes in
float64 on the host. voc_map is a numpy copy: equal results.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port import to_jax_config
from yolo_tpu.eval import runner as jrunner
from yolo_tpu.eval import voc_map as jvoc_map
from yolo_tpu.models import graph as jgraph
from yolo_tpu.models import predict as jpredict
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.data.synthetic import write_voc_scenes
from yolo_tpu_torch.eval import runner as trunner
from yolo_tpu_torch.eval import voc_map as tvoc_map
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.models import predict as tpredict

torch.set_num_threads(1)

SIZES = [(75, 100), (100, 67), (96, 128), (120, 90), (64, 64)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = get_variant("tiny-voc", input_size=96)
    samples = write_voc_scenes(str(tmp_path_factory.mktemp("voc")), SIZES,
                               np.random.default_rng(11),
                               filters=(0, 1, 2, 3, 4), difficult=0.3)
    params = dw.synthetic_detector_params(cfg, 0)
    return cfg, samples, params


def _random_eval_inputs(seed, n_images=6, n_classes=4):
    rng = np.random.default_rng(seed)
    gt, dets = {}, {}
    for i in range(n_images):
        g = int(rng.integers(0, 5))
        xy = rng.uniform(0, 300, (g, 2))
        wh = rng.uniform(5, 120, (g, 2))
        gt[i] = {"boxes": np.concatenate([xy, xy + wh], -1),
                 "classes": rng.integers(0, n_classes, g),
                 "difficult": (rng.uniform(size=g) < 0.2).astype(np.int32)}
        d = []
        for b, c in zip(gt[i]["boxes"], gt[i]["classes"]):
            for _ in range(int(rng.integers(0, 3))):
                jit = rng.normal(0, 8, 4)
                d.append((int(c), float(rng.uniform()), *(b + jit)))
        for _ in range(int(rng.integers(0, 4))):
            xy = rng.uniform(0, 300, 2)
            d.append((int(rng.integers(0, n_classes)), float(rng.uniform()),
                      *xy, *(xy + rng.uniform(5, 80, 2))))
        dets[i] = d
    return dets, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_07", [True, False])
def test_voc_map_matches_jax(seed, use_07):
    dets, gt = _random_eval_inputs(seed)
    got = tvoc_map.evaluate(dets, gt, 4, use_07_metric=use_07,
                            return_curves=True)
    want = jvoc_map.evaluate(dets, gt, 4, use_07_metric=use_07,
                             return_curves=True)
    assert got["map"] == want["map"]
    np.testing.assert_array_equal(list(got["ap"].values()),
                                  list(want["ap"].values()))
    assert got["curves"] == want["curves"]
    for conf in (0.25, 0.5):
        assert tvoc_map.detection_stats(dets, gt, 4, conf_thresh=conf) == \
            jvoc_map.detection_stats(dets, gt, 4, conf_thresh=conf)


def test_build_ground_truth_matches_jax(setup):
    cfg, samples, _ = setup
    got, got_ids = trunner.build_ground_truth(samples, cfg.class_names)
    want, want_ids = jrunner.build_ground_truth(samples, cfg.class_names)
    assert got_ids == want_ids and set(got) == set(want)
    for i in got:
        assert set(got[i]) == set(want[i])
        for k in got[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k])


def test_make_detector_preprocessed_matches_jax(setup):
    cfg, _, params = setup
    jcfg = to_jax_config(cfg)
    folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    x = np.random.default_rng(2).uniform(0, 1, (2, 96, 96, 3)) \
        .astype(np.float32)
    want = jpredict.make_detector_preprocessed(
        jcfg, conf_threshold=0.005, head="reference", nms_impl="xla")(
        jgraph.params_to_jax(folded), jnp.asarray(x))
    net = tgraph.Darknet(cfg.layers, folded, device="cpu")
    got = tpredict.make_detector_preprocessed(
        cfg, conf_threshold=0.005, head="reference", nms_impl="torch")(
        net, torch.from_numpy(x))
    v = np.asarray(want["valid"])
    assert v.sum() >= 20
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["classes"].numpy()[v],
                                  np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(
        want["scores"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(
        want["boxes"])[v], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("resize", ["letterbox", "stretch"])
def test_collect_detections_matches_jax(setup, resize):
    cfg, samples, params = setup
    jcfg = to_jax_config(cfg)
    folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    # a duplicated path must receive its image's detections too
    samples = samples + [samples[0]]
    want = jrunner.collect_detections(
        jcfg, jgraph.params_to_jax(folded), samples, batch=4,
        resize=resize)
    got = trunner.collect_detections(cfg, folded, samples, batch=4,
                                     resize=resize, device="cpu")
    assert set(got) == set(want) == set(range(len(samples)))
    n = 0
    for i in got:
        assert len(got[i]) == len(want[i])
        n += len(got[i])
        for g, w in zip(got[i], want[i]):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-5)
            np.testing.assert_allclose(g[2:], w[2:], rtol=0, atol=1e-3)
    assert n >= 100
    assert got[len(samples) - 1] == got[0]


def test_quick_map_matches_jax(setup):
    """mAP of unfolded train params (folded inside), both metrics."""
    cfg, samples, params = setup
    jcfg = to_jax_config(cfg)
    for use_07 in (True, False):
        want = jrunner.quick_map(jcfg, jgraph.params_to_jax(params),
                                 samples, batch=4, use_07_metric=use_07)
        got = trunner.quick_map(cfg, params, samples, batch=4, device="cpu",
                                use_07_metric=use_07)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-4


def test_eval_entry_points_default_to_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")
    cfg, samples, params = setup
    folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.collect_detections(cfg, folded, samples)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.quick_map(cfg, params, samples)
