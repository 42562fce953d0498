"""Helpers shared by tests/test_torch_*.py, which hold the PyTorch port
(yolo_tpu_torch) against the JAX package."""

import dataclasses
import jax.numpy as jnp
import numpy as np
import torch

from yolo_tpu.configs import specs as jspecs
from yolo_tpu.io import darknet_weights as jdw
from yolo_tpu.models import graph as jgraph
from yolo_tpu.models import predict as jpredict
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.models import predict as tpredict


def _fields(obj, tree_cls) -> dict:
    """A dataclass's fields by name, a YOLO9000 tree among them
    rebuilt as ``tree_cls`` (the other package's SoftmaxTree)."""
    out = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if out.get("tree") is not None:
        out["tree"] = tree_cls(**_fields(out["tree"], None))
    return out


def to_jax_config(cfg):
    """The JAX package's ModelConfig for a port ModelConfig: every spec,
    field and YOLO9000 tree carried over by name; fields the port lacks
    keep the JAX defaults, which are the yolov2 family's."""
    from yolo_tpu.configs.tree import SoftmaxTree

    fields = _fields(cfg, SoftmaxTree)
    fields["layers"] = tuple(
        getattr(jspecs, type(l).__name__)(**_fields(l, SoftmaxTree))
        for l in cfg.layers)
    return jspecs.ModelConfig(**fields)


def to_port_config(jcfg):
    """The port's ModelConfig for a JAX package ModelConfig, every spec,
    port field and YOLO9000 tree carried over by name; None when it
    holds a layer the port lacks."""
    from yolo_tpu_torch.configs import specs as tspecs
    from yolo_tpu_torch.configs.tree import SoftmaxTree

    layers = []
    for l in jcfg.layers:
        cls = getattr(tspecs, type(l).__name__, None)
        if cls is None or not dataclasses.is_dataclass(cls):
            return None
        layers.append(cls(**_fields(l, SoftmaxTree)))
    fields = {k: v for k, v in _fields(jcfg, SoftmaxTree).items()
              if k in {f.name for f in dataclasses.fields(tspecs.ModelConfig)}}
    fields["layers"] = tuple(layers)
    return tspecs.ModelConfig(**fields)


def he_weights(cfg, path, seed=0, box_scale=1.0, objectness_shift=0.0):
    """Seeded He-scaled weights (io.darknet_weights.synthetic_detector_params,
    plain He by default) written as a darknet .weights file."""
    dw.save(path, cfg.layers, dw.synthetic_detector_params(
        cfg, seed, box_scale=box_scale, objectness_shift=objectness_shift))


def matched(a, b, conf):
    """(matched, total) over a's detections scoring >= conf + 0.05: a
    same-class box of b at IoU >= 0.5 matches. a and b are detection
    dicts of numpy arrays."""
    def iou(p, q):
        iw = max(0.0, min(p[2], q[2]) - max(p[0], q[0]))
        ih = max(0.0, min(p[3], q[3]) - max(p[1], q[1]))
        union = ((p[2] - p[0]) * (p[3] - p[1]) + (q[2] - q[0]) * (q[3] - q[1])
                 - iw * ih)
        return iw * ih / union if union > 0 else 0.0

    hit = total = 0
    for bi in range(len(a["valid"])):
        kept = [(int(c), box) for c, box, v in zip(
            b["classes"][bi], b["boxes"][bi].astype(np.float64),
            b["valid"][bi]) if v]
        for c, s, box, v in zip(a["classes"][bi], a["scores"][bi],
                                a["boxes"][bi].astype(np.float64),
                                a["valid"][bi]):
            if v and s >= conf + 0.05:
                total += 1
                hit += any(c == c2 and iou(box, box2) >= 0.5
                           for c2, box2 in kept)
    return hit, total


def check_fused_entry_route(tmp_path, variant, size, dtype, conf):
    """detect_raw(entry="fused") in both packages on the same .weights
    bytes and images, batch 2 at 120x160 (called eagerly on the JAX side,
    so the Pallas kernel's interpret-mode compile is cached across calls
    of one shape). fp32: exact on valid and classes, scores atol 1e-4,
    pixel boxes atol 1e-2 (tests/test_torch_predict.py's fp32 bounds).
    bf16, on weights shaped like a trained detector's: at box level,
    every detection at conf + 0.05 matched both ways."""
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    cfg = dataclasses.replace(get_variant(variant, input_size=size),
                              conf_threshold=conf)
    jcfg = to_jax_config(cfg)
    path = str(tmp_path / "w.weights")
    if dtype == "fp32":
        he_weights(cfg, path)
    else:
        he_weights(cfg, path, box_scale=0.1, objectness_shift=-2.0)
    imgs = np.random.default_rng(1).integers(0, 256, (2, 120, 160, 3),
                                             dtype=np.uint8)
    jparams, _ = jdw.load(path, jcfg.layers)
    jparams = jgraph.params_to_jax(jgraph.fold_params(jcfg.layers, jparams,
                                                      jcfg.bn_eps))
    want = jpredict.detect_raw(jcfg, jparams,
                               jnp.asarray(imgs), compute_dtype=jdt,
                               entry="fused", head="fused")
    want = {k: np.asarray(v) for k, v in want.items()}
    params, _ = dw.load(path, cfg.layers)
    net = tgraph.Darknet(cfg.layers,
                         tgraph.fold_params(cfg.layers, params, cfg.bn_eps),
                         device="cpu", dtype=tdt)
    got = tpredict.make_detector(cfg, entry="fused", head="fused")(
        net, torch.from_numpy(imgs))
    got = {k: v.numpy() for k, v in got.items()}
    if dtype == "fp32":
        v = want["valid"]
        assert v.sum() >= 4
        np.testing.assert_array_equal(got["valid"], v)
        np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["boxes"][v], want["boxes"][v],
                                   rtol=0, atol=1e-2)
    else:
        for a, b in ((want, got), (got, want)):
            hit, total = matched(a, b, cfg.conf_threshold)
            assert total >= 5 and hit == total


class PortCli:
    """yolo_tpu_torch.cli in the place of yolo_tpu.cli for the JAX
    package's CLI tests: the same argv, plus ``--device cpu`` on the
    commands that compute."""
    COMPUTING = ("predict", "classify", "detect", "train", "eval", "test",
                 "recall", "serve")

    @classmethod
    def main(cls, argv):
        from yolo_tpu_torch.cli import main

        argv = list(argv)
        main(argv + (["--device", "cpu"] if argv[0] in cls.COMPUTING
                     else []))


def rerun_jax_test(module, name: str, fixtures: dict):
    """Call the test ``name`` of a JAX test module (a function, or
    "Class.method") with the fixtures its signature names."""
    import inspect

    owner, _, meth = name.partition(".")
    fn = getattr(module, owner)
    if meth:
        fn = getattr(fn(), meth)
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})


def jax_test_names(module) -> list:
    """The test functions and test-class methods of a test module."""
    import inspect

    names = []
    for name, obj in vars(module).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            names.append(name)
        elif name.startswith("Test") and inspect.isclass(obj):
            names += [f"{name}.{m}" for m in vars(obj) if m.startswith("test_")]
    return names


def jax_native_library(seconds: float = 300.0) -> None:
    """Loads the JAX package's native library, waiting out a concurrent
    build. yolo_tpu/native/preproc.py runs `make` on first use when
    native/libyolopreproc.so is missing (a fresh checkout), and the
    Makefile links the library in place: a pytest worker that loads it
    while another worker's link is still writing it fails, and the
    module keeps that failure for the life of the process (its loaders
    then fall back to numpy; ROADMAP C12). So clear the kept failure and
    load again until the file is whole."""
    import time

    from yolo_tpu.native import preproc as jpreproc

    deadline = time.monotonic() + seconds
    while jpreproc._load() is None:
        assert time.monotonic() < deadline, (
            "the JAX package's native library did not load")
        time.sleep(0.5)
        with jpreproc._lock:
            jpreproc._tried = False


def cv2_hsv_is_avx2() -> bool:
    """Whether this host's cv2 converts HSV -> RGB in its AVX2 build (AVX2
    and FMA3 present), the one data/augment.py reproduces byte for byte;
    OpenCV dispatches that module to no wider instruction set."""
    import cv2

    return bool(cv2.checkHardwareSupport(11) and cv2.checkHardwareSupport(12))


def cv2_idct_saturates() -> bool:
    """Whether this host's cv2 runs libjpeg-turbo's SIMD islow IDCT (its
    16-bit lanes saturate where coefficients overflow), the one
    native/jpeg.c reproduces: a gray block whose DC alone overflows pass
    1 reads 255 there, where the C IDCT's range-limit table wraps it."""
    import cv2
    import numpy as np

    from tests.jpeg_writer import Frame, write_jpeg

    fr = Frame(8, 8, qt=[np.full(64, 255)], qt_of=[0])
    blk = np.zeros((1, 1, 64), np.int64)
    blk[0, 0, 0], blk[0, 0, 8] = 100, 1
    img = cv2.imdecode(np.frombuffer(write_jpeg(fr, [blk]), np.uint8),
                       cv2.IMREAD_GRAYSCALE)
    return bool(img is not None and img[0, 0] == 255)
