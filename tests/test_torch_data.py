"""The port's data path (yolo_tpu_torch.data) against the JAX package on
the CPU: VOC parsing, GT encoding, augmentation, PNG decoding, the train
and inference batch streams and the prefetcher.

Tolerances:
  * parse_annotation, encode_batch, boxes and classes after augment,
    targets of train_batches: exact.
  * augment images: the port converts RGB -> HSV with cv2's fixed-point
    tables, byte for byte; HSV -> RGB as OpenCV 5's AVX2 build does
    (float32 sector formula with its fused multiply-adds, truncated in
    the 32-pixel blocks of the vectorized body, rounded in each row's
    tail), byte for byte where this host's cv2 runs that build
    (tests/torch_port.py::cv2_hsv_is_avx2), else within one level.
  * the PNG decoder: identical bytes to cv2.imread.
  * train_batches / inference_batches images: byte for byte. The
    letterbox is native/letterbox.c against the JAX package's native
    one (loaded through tests/torch_port.py::jax_native_library, so
    that its numpy fallback cannot stand in); the stretch is the C
    stretch beside it against numpy_ref.stretch_resize (cv2.resize on
    OpenCV's IPP path).
"""

import cv2
import numpy as np
import pytest
import torch

from yolo_tpu.data import augment as jaug
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu.data import targets as jtgt
from yolo_tpu.data import voc as jvoc
from yolo_tpu_torch.configs import VOC_NAMES
from yolo_tpu_torch.data import augment as taug
from yolo_tpu_torch.data import pipeline as tpipe
from yolo_tpu_torch.data import targets as ttgt
from yolo_tpu_torch.data import voc as tvoc
from yolo_tpu_torch.data.png import decode_png, encode_png
from yolo_tpu_torch.data.synthetic import voc_xml, write_voc_scenes

torch.set_num_threads(1)

ANCHORS = ((1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
           (9.47112, 4.84053), (11.2364, 10.0071))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Six seeded VOC-style scenes of three source sizes: PNG + XML."""
    return write_voc_scenes(str(tmp_path_factory.mktemp("voc")),
                            [(75, 100), (100, 67), (96, 128)] * 2,
                            np.random.default_rng(7),
                            filters=(0, 1, 2, 3, 4), difficult=0.3)


# --- VOC parsing and GT encoding -------------------------------------------

@pytest.mark.parametrize("keep_difficult", [False, True])
def test_parse_annotation_matches_jax(tmp_path, keep_difficult):
    path = str(tmp_path / "a.xml")
    with open(path, "w") as f:
        f.write(voc_xml("a.png", 500, 375, [
            ("dog", 48, 240, 195, 371, 0), ("person", 8, 12, 352, 498, None),
            ("unicorn", 1, 1, 10, 10, 0), ("cat", 100, 100, 200, 300, 1)]))
    got = tvoc.parse_annotation(path, VOC_NAMES, keep_difficult)
    want = jvoc.parse_annotation(path, VOC_NAMES, keep_difficult)
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    assert got["n_unknown"] == 1


@pytest.mark.parametrize("grid", [13, (10, 13), 4])
def test_encode_batch_matches_jax(grid):
    rng = np.random.default_rng(3)
    boxes, classes = [], []
    for n in (0, 1, 3, 40):   # empty, one, a few, over MAX_GT
        b = np.stack([rng.uniform(-0.1, 1.1, n), rng.uniform(-0.1, 1.1, n),
                      rng.uniform(-0.05, 0.6, n), rng.uniform(0.0, 0.6, n)],
                     -1).astype(np.float32)
        boxes.append(b)
        classes.append(rng.integers(0, 20, n))
    got = ttgt.encode_batch(boxes, classes, grid=grid, anchors=ANCHORS,
                            num_classes=20)
    want = jtgt.encode_batch(boxes, classes, grid=grid, anchors=ANCHORS,
                             num_classes=20)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# --- augmentation --------------------------------------------------------------

def test_rgb2hsv_is_cv2s_byte_for_byte():
    cube = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                np.arange(0, 256, 5), indexing="ij"),
                    -1).reshape(256, -1, 3).astype(np.uint8)
    np.testing.assert_array_equal(taug.rgb2hsv_u8(cube),
                                  cv2.cvtColor(cube, cv2.COLOR_RGB2HSV))


def _image_share(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    return float((d.max(axis=-1) > 0).mean())


def test_hsv2rgb_within_one_level_of_cv2():
    """Byte for byte where cv2 runs its AVX2 build (every hue byte,
    0-255, and row widths that end in the vector body and in the scalar
    tail); within one level of another build's."""
    from tests.torch_port import cv2_hsv_is_avx2

    hsv = np.stack(np.meshgrid(np.arange(256), np.arange(0, 256, 3),
                               np.arange(0, 256, 3), indexing="ij"),
                   -1).reshape(256, -1, 3).astype(np.uint8)
    flat = hsv.reshape(-1, 3)
    for width in (hsv.shape[1], 1, 31, 33, 517):
        img = flat[:flat.shape[0] // width * width].reshape(-1, width, 3)
        got = taug.hsv2rgb_u8(img)
        want = cv2.cvtColor(img, cv2.COLOR_HSV2RGB)
        if cv2_hsv_is_avx2():
            np.testing.assert_array_equal(got, want)
        else:
            assert _image_share(got, want) <= 1e-3


@pytest.mark.parametrize("seed,shape,kw", [
    (0, (375, 500, 3), {}), (1, (333, 500, 3), {}),
    (2, (480, 640, 3), dict(jitter=0.2, hue=0.0, saturation=1.0,
                            exposure=1.0)),
    (3, (100, 75, 1), {}),
    (4, (64, 96, 3), dict(saturation=0.7, exposure=0.8, flip=False)),
    (5, (64, 96, 3), dict(gaussian_noise=20.0))])
def test_augment_matches_jax(seed, shape, kw):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    boxes = np.array([[0.5, 0.5, 0.4, 0.3], [0.1, 0.9, 0.2, 0.2],
                      [0.8, 0.2, 0.05, 0.05]], np.float32)
    classes = np.array([3, 7, 11], np.int64)
    got = taug.augment(img, boxes, classes, np.random.default_rng(seed + 10),
                       taug.AugmentConfig(**kw))
    want = jaug.augment(img, boxes, classes, np.random.default_rng(seed + 10),
                        jaug.AugmentConfig(**kw))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == want[0].shape and got[0].dtype == np.uint8
    assert _image_share(got[0], want[0]) <= 1e-3


def test_jitter_pads_by_edge_replication():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)
    cfg = taug.AugmentConfig(jitter=0.5)
    for seed in range(8):
        got = taug.jitter_crop(img, np.zeros((0, 4), np.float32),
                               np.zeros(0, np.int64),
                               np.random.default_rng(seed), cfg)
        want = jaug.jitter_crop(img, np.zeros((0, 4), np.float32),
                                np.zeros(0, np.int64),
                                np.random.default_rng(seed),
                                jaug.AugmentConfig(jitter=0.5))
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("kw", [dict(blur=3), dict(mosaic=True),
                                dict(mixup=True), dict(angle=7.0)])
def test_augment_modes_without_a_port_raise(kw):
    """Blur (formerly refused, ported since with native/resample.c) and
    the modes augment() does not act on (mosaic, mixup: pipeline-level;
    the classifier geometry keys), in the JAX package as in the port:
    the sample equals JAX's under the same generator, boxes and classes
    exactly, the image within one level on at most 0.1% of its pixels
    (the HSV distortion; blur itself is exact,
    tests/test_torch_augment_resample.py)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    boxes = np.asarray([[0.5, 0.5, 0.4, 0.3]], np.float32)
    classes = np.asarray([2])
    got = taug.augment(img, boxes, classes, np.random.default_rng(0),
                       taug.AugmentConfig(**kw))
    want = jaug.augment(img, boxes, classes, np.random.default_rng(0),
                        jaug.AugmentConfig(**kw))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].shape == want[0].shape and got[0].dtype == np.uint8
    assert _image_share(got[0], want[0]) <= 1e-3


def test_config_from_net_params_matches_jax():
    import dataclasses

    for hp, force in (({}, False), ({"flip": 0, "hue": ".05"}, False),
                      ({}, True), ({"jitter": ".2", "exposure": "1.2"},
                                   False)):
        assert dataclasses.asdict(taug.config_from_net_params(
            hp, force_defaults=force)) == dataclasses.asdict(
                jaug.config_from_net_params(hp, force_defaults=force))


# --- PNG decoding --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 51, 3), (20, 33), (64, 97, 3),
                                   (1, 1, 3), (5, 1)])
def test_png_decoder_matches_cv2(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img = np.cumsum(img, axis=0, dtype=np.uint8) // 2   # varied filters
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    with open(path, "rb") as f:
        got = decode_png(f.read())
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = want[..., ::-1] if want.ndim == 3 else want[..., None]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_decoder_every_row_filter(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(encode_png(img, filters=(0, 1, 2, 3, 4)))
    with open(path, "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()), img)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = want[..., ::-1] if want.ndim == 3 else want[..., None]
    np.testing.assert_array_equal(img, want)


def test_load_image_without_cv2(tmp_path, monkeypatch):
    """Without OpenCV the default (native) decoder reads PNG and JPEG at
    both channel counts as cv2 does; asking for the cv2 decoder raises."""
    rng = np.random.default_rng(0)
    rgb, gray = (str(tmp_path / "rgb.png"), str(tmp_path / "gray.png"))
    cv2.imwrite(rgb, rng.integers(0, 256, (9, 13, 3), dtype=np.uint8))
    cv2.imwrite(gray, rng.integers(0, 256, (9, 13), dtype=np.uint8))
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, rng.integers(0, 256, (9, 13, 3), dtype=np.uint8))
    cases = [(p, c) for p in (rgb, gray, jpg) for c in (1, 3)]
    tpipe.set_decoder("cv2")
    try:
        with_cv2 = {(p, c): tpipe.load_image(p, c) for p, c in cases}
    finally:
        tpipe.set_decoder("native")
    np.testing.assert_array_equal(with_cv2[(rgb, 3)],
                                  jpipe.load_image(rgb, 3))

    def no_cv2():
        raise ImportError("No module named 'cv2'")

    monkeypatch.setattr(tpipe, "_cv2", no_cv2)
    for (p, c), want in with_cv2.items():
        np.testing.assert_array_equal(tpipe.load_image(p, c), want)
    with pytest.raises(ImportError, match="cv2"):
        tpipe.set_decoder("cv2")
    assert tpipe.get_decoder() == "native"


# --- batch streams -------------------------------------------------------------

@pytest.mark.parametrize("resize,aug", [
    ("letterbox", None),
    ("letterbox", dict(jitter=0.3, hue=0.0, saturation=1.0, exposure=1.0)),
    ("stretch", dict(jitter=0.2, hue=0.0, saturation=1.0, exposure=1.0))])
def test_train_batches_match_jax(dataset, resize, aug):
    from tests.torch_port import jax_native_library

    jax_native_library()
    kw = dict(class_names=VOC_NAMES, anchors=ANCHORS, num_classes=20,
              net_size=96, batch_size=3, workers=2, resize=resize)
    got = list(tpipe.train_batches(
        dataset, rng=np.random.default_rng(1),
        augment_cfg=None if aug is None else taug.AugmentConfig(**aug), **kw))
    want = list(jpipe.train_batches(
        dataset, rng=np.random.default_rng(1),
        augment_cfg=None if aug is None else jaug.AugmentConfig(**aug), **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "images":
                assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])
        assert g["obj_mask"].sum() > 0


def test_train_batches_rejects_what_is_not_ported(dataset):
    """A dataset smaller than one batch raises as JAX's does; mosaic,
    once refused here, now yields net-size composites (its parity with
    JAX: tests/test_torch_augment_resample.py)."""
    kw = dict(class_names=VOC_NAMES, anchors=ANCHORS, num_classes=20,
              net_size=64, batch_size=2, rng=np.random.default_rng(0))
    batch = next(tpipe.train_batches(
        dataset, augment_cfg=taug.AugmentConfig(mosaic=True), **kw))
    assert batch["images"].shape == (2, 64, 64, 3)
    assert batch["images"].dtype == np.float32
    with pytest.raises(ValueError, match="full batch"):
        next(tpipe.train_batches(dataset[:1], **kw))


@pytest.mark.parametrize("resize", ["letterbox", "stretch"])
def test_inference_batches_match_jax(dataset, resize):
    from tests.torch_port import jax_native_library

    jax_native_library()
    paths = [p for p, _ in dataset] + [dataset[0][0]]
    got = list(tpipe.inference_batches(paths, 3, net_size=(64, 96),
                                       workers=2, resize=resize))
    want = list(jpipe.inference_batches(paths, 3, net_size=(64, 96),
                                        workers=2, resize=resize))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["paths"] == w["paths"]
        assert [tuple(s) for s in g["shapes"]] == \
            [tuple(s) for s in w["shapes"]]
        assert g.get("pad", 0) == w.get("pad", 0)
        np.testing.assert_array_equal(g["images"], w["images"])
    assert got[-1]["pad"] == 2


def test_prefetcher_keeps_order_and_metadata():
    batches = [{"x": np.full((2, 3), i, np.float32), "paths": [f"{i}"]}
               for i in range(7)]
    with tpipe.DevicePrefetcher(iter(batches), depth=2, device="cpu") as pf:
        out = list(pf)
    assert [int(b["x"][0, 0]) for b in out] == list(range(7))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
    assert [b["paths"] for b in out] == [[f"{i}"] for i in range(7)]


def test_prefetcher_surfaces_errors_and_closes_early():
    def broken():
        yield {"x": np.zeros(1)}
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tpipe.DevicePrefetcher(broken(), device="cpu"))

    def endless():
        i = 0
        while True:
            yield {"x": np.full(1, i)}
            i += 1

    pf = tpipe.DevicePrefetcher(endless(), depth=2, device="cpu")
    first = next(iter(pf))
    assert int(first["x"][0]) == 0
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.DevicePrefetcher(iter([]))
