"""The port's cv2-free resamplers (native/resample.c behind
native/preproc.py) and the augmentations built on them (blur, the
classifier rotate/scale crop, the yolov4 mosaic, mixup) against the JAX
package and cv2 on the CPU.

Tolerances: every comparison is exact. gaussian_blur_u8 and
warp_affine_u8 equal cv2.GaussianBlur and cv2.warpAffine byte for byte,
so apply_blur, rotate_scale_crop, random_augment_classifier and mosaic4
equal the JAX functions byte for byte, at 1 and 3 channels; train_batches
with mosaic, mixup or blur equals JAX's images and targets exactly,
letterboxed (the JAX package's native letterbox loaded through
tests/torch_port.py::jax_native_library) or stretched. The train_batches
cases turn HSV off; tests/test_torch_data.py holds the port's 8-bit
HSV -> RGB to cv2's.
"""

import numpy as np
import pytest
import torch

import tests.test_augment as jta
import yolo_tpu
from tests.torch_port import PortCli, rerun_jax_test
from yolo_tpu.data import augment as jaug
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu_torch.data import augment as taug
from yolo_tpu_torch.data import pipeline as tpipe
from yolo_tpu_torch.native.preproc import gaussian_blur_u8, warp_affine_u8

torch.set_num_threads(1)


def _cv2_warp(img, m, size):
    import cv2

    return cv2.warpAffine(img, m, size,
                          flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                          borderMode=cv2.BORDER_REPLICATE)


def _image(rng, h, w, c):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


@pytest.mark.parametrize("c", [1, 3])
def test_gaussian_blur_u8_matches_cv2(c):
    """Every odd ksize from 1 to 61 (the fixed tables up to 9, the
    error-diffused taps above), on images wider and narrower than the
    kernel (BORDER_REFLECT_101 reflects again past a narrow edge)."""
    import cv2

    rng = np.random.default_rng(c)
    for k in range(1, 62, 2):
        for h, w in ((23, 31), (1, 9), (5, 1), (3, 40), (16, 2)):
            img = _image(rng, h, w, c)
            want = cv2.GaussianBlur(img, (k, k), 0).reshape(h, w, c)
            np.testing.assert_array_equal(gaussian_blur_u8(img, k), want,
                                          err_msg=f"k={k} {h}x{w}")


def test_gaussian_blur_u8_rejects_even_ksize():
    with pytest.raises(ValueError, match="odd"):
        gaussian_blur_u8(np.zeros((4, 4, 3), np.uint8), 4)


def test_warp_affine_u8_float32_arithmetic():
    """cv2 5's warp is float32, not the 1/32-pixel fixed point of older
    builds: a 0->255 edge shifted by 1/128 px gives 2 and by 1/64 px 4;
    a 0.1 px shift gives 25 (the fraction is float32 3.1 - 3)."""
    img = np.zeros((4, 8, 3), np.uint8)
    img[:, 4:] = 255
    for shift, want in ((1 / 128, 2), (1 / 64, 4), (0.1, 25)):
        m = np.array([[1, 0, shift], [0, 1, 0]], np.float32)
        got = warp_affine_u8(img, m, (8, 4))
        assert got[0, 3, 0] == want == _cv2_warp(img, m, (8, 4))[0, 3, 0]


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warp_affine_u8_matches_cv2(c, dtype):
    """Rotated, scaled and shifted maps at output widths on both sides
    of cv2's 16-pixel vector blocks (the body and the scalar tail fuse
    differently), sources from 1 px wide, maps reaching far past the
    edges (BORDER_REPLICATE)."""
    rng = np.random.default_rng(11 + c)
    for t in range(60):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        img = _image(rng, h, w, c)
        rad = rng.uniform(-0.6, 0.6)
        s, a = rng.uniform(0.2, 3.0), rng.uniform(0.5, 2.0)
        size = (int(rng.integers(1, 100)), int(rng.integers(1, 60)))
        cosr, sinr = np.cos(rad), np.sin(rad)
        ox = rng.uniform(-20, 20) - size[0] / 2
        oy = rng.uniform(-20, 20) - size[1] / 2
        m = np.array([[cosr * a / s, -sinr / s,
                       w / 2 + cosr * a / s * ox - sinr / s * oy],
                      [sinr * a / s, cosr / s,
                       h / 2 + sinr * a / s * ox + cosr / s * oy]], dtype)
        src = img[..., 0] if c == 1 and t % 2 else img
        want = _cv2_warp(src, m, size)
        got = warp_affine_u8(src, m, size)
        if src.ndim == 3 and c == 1:
            want = want[..., None]
        np.testing.assert_array_equal(got, want, err_msg=f"case {t}")


@pytest.mark.parametrize("c", [1, 3])
def test_apply_blur_matches_jax(c):
    """Both modes (background with the truth boxes copied back sharp,
    full with ksize (blur // 2) * 2 + 1) and the draw, on images down to
    one pixel wide; the generators stay in step."""
    rng = np.random.default_rng(c)
    boxes = np.array([[0.5, 0.5, 0.4, 0.4], [0.1, 0.9, 0.3, 0.5]])
    for h, w in ((48, 64), (12, 9), (1, 30), (20, 1), (3, 3)):
        img = _image(rng, h, w, c)
        for blur in (1, 2, 5, 10, 33):
            for seed in range(4):
                rt, rj = (np.random.default_rng(seed) for _ in range(2))
                got = taug.apply_blur(img, boxes, rt,
                                      taug.AugmentConfig(blur=blur))
                want = jaug.apply_blur(img, boxes, rj,
                                       jaug.AugmentConfig(blur=blur))
                assert got.shape == want.shape
                np.testing.assert_array_equal(got, want)
                assert rt.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize("c", [1, 3])
def test_rotate_scale_crop_matches_jax(c):
    rng = np.random.default_rng(20 + c)
    for _ in range(30):
        h, w = (int(v) for v in rng.integers(8, 90, 2))
        img = _image(rng, h, w, c)
        kw = dict(rad=float(rng.uniform(-0.5, 0.5)),
                  scale=float(rng.uniform(0.3, 2.5)),
                  aspect=float(rng.uniform(0.6, 1.5)),
                  dx=float(rng.uniform(-10, 10)),
                  dy=float(rng.uniform(-10, 10)))
        size = int(rng.integers(8, 70))
        got = taug.rotate_scale_crop(img, size, **kw)
        want = jaug.rotate_scale_crop(img, size, **kw)
        assert got.shape == want.shape == (size, size, c)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [1, 3])
def test_random_augment_classifier_matches_jax(c):
    rng = np.random.default_rng(30 + c)
    cfgs = [dict(angle=7.0, aspect=0.75, min_crop=32, max_crop=64),
            dict(angle=15.0), dict(aspect=1.3), dict(min_crop=20,
                                                     max_crop=20)]
    for kw in cfgs:
        for seed in range(6):
            img = _image(rng, int(rng.integers(20, 80)),
                         int(rng.integers(20, 80)), c)
            rt, rj = (np.random.default_rng(seed) for _ in range(2))
            got = taug.random_augment_classifier(
                img, rt, taug.AugmentConfig(**kw), 32)
            want = jaug.random_augment_classifier(
                img, rj, jaug.AugmentConfig(**kw), 32)
            np.testing.assert_array_equal(got, want, err_msg=str(kw))
            assert rt.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("net", [64, (48, 80)])
def test_mosaic4_matches_jax(c, net):
    """Canvas, boxes and classes, with a rectangular net too; sources of
    sizes that do not divide the net."""
    rng = np.random.default_rng(40 + c)
    for seed in range(6):
        samples = []
        for k in range(4):
            h, w = (int(v) for v in rng.integers(20, 90, 2))
            n = int(rng.integers(0, 4))
            xy = rng.uniform(0.1, 0.9, (n, 2))
            wh = rng.uniform(0.05, 0.6, (n, 2))
            samples.append((_image(rng, h, w, c),
                            np.concatenate([xy, wh], 1).astype(np.float32),
                            rng.integers(0, 20, n)))
        got = taug.mosaic4(samples, net, np.random.default_rng(seed),
                           taug.AugmentConfig())
        want = jaug.mosaic4(samples, net, np.random.default_rng(seed),
                            jaug.AugmentConfig())
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _voc(tmp_path, n=6):
    from tests.test_data_eval import make_voc_root
    from yolo_tpu.data.voc import list_split

    return list_split(make_voc_root(tmp_path, n_images=n, size=(60, 80)),
                      "train")


@pytest.mark.parametrize("mode", ["mosaic", "mixup", "blur"])
@pytest.mark.parametrize("resize", ["letterbox", "stretch"])
def test_train_batches_match_jax(mode, resize, tmp_path):
    """train_batches with mosaic, mixup or blur on, HSV off: the same
    targets and images as JAX's on the same seed, byte for byte."""
    from tests.torch_port import jax_native_library

    jax_native_library()
    pairs = _voc(tmp_path)
    kw = dict(flip=True, jitter=0.2, hue=0.0, saturation=1.0,
              exposure=1.0)
    kw.update({"mosaic": dict(mosaic=True), "mixup": dict(mixup=True),
               "blur": dict(blur=5)}[mode])
    args = dict(class_names=("cat", "dog"), anchors=((1, 1), (3, 3)),
                num_classes=2, net_size=64, batch_size=2, workers=2,
                resize=resize)
    got = list(tpipe.train_batches(pairs, rng=np.random.default_rng(4),
                                   augment_cfg=taug.AugmentConfig(**kw),
                                   **args))
    want = list(jpipe.train_batches(pairs, rng=np.random.default_rng(4),
                                    augment_cfg=jaug.AugmentConfig(**kw),
                                    **args))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "images":
                assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


JAX_AUGMENT_TESTS = [
    "TestMosaic.test_quadrants_come_from_sources",
    "TestMosaic.test_quadrant_sampling_matches_full_stretch",
    "TestMosaic.test_boxes_clipped_to_quadrants",
    "TestMosaic.test_low_visibility_boxes_dropped",
    "TestMosaic.test_train_batches_mosaic",
    "TestMixup.test_train_batches_mixup_blends_and_unions",
    "TestMixup.test_exact_blend_of_two_known_images",
    "TestMixup.test_mixup_cfg_key_flows",
    "TestClassifierGeometry.test_identity",
    "TestClassifierGeometry.test_pure_scale_matches_formula",
    "TestClassifierGeometry.test_rotation_90deg_matches_formula",
    "TestClassifierGeometry.test_random_augment_deterministic",
    "TestClassifierGeometry.test_degenerate_range_is_whole_image_resize",
    "TestClassifierGeometry.test_config_from_net_params_keys",
    "TestBlurNoise.test_off_by_default_and_at_zero",
    "TestBlurNoise.test_blur_full_mode_matches_cv2_formula",
    "TestBlurNoise.test_blur_background_mode_keeps_truth_sharp",
    "TestBlurNoise.test_seeded_determinism_in_full_augment",
]


def _port_augment(monkeypatch):
    """The JAX augment module's and test module's names, and JAX's
    train_batches, bound to the port's."""
    for name in ("AugmentConfig", "augment", "apply_blur",
                 "apply_gaussian_noise", "mosaic4", "rotate_scale_crop",
                 "random_augment_classifier", "config_from_net_params"):
        monkeypatch.setattr(jaug, name, getattr(taug, name))
        if hasattr(jta, name):
            monkeypatch.setattr(jta, name, getattr(taug, name))
    monkeypatch.setattr(jpipe, "train_batches", tpipe.train_batches)


@pytest.mark.parametrize("name", JAX_AUGMENT_TESTS)
def test_jax_augment_tests_hold_for_the_port(name, tmp_path, monkeypatch):
    """tests/test_augment.py's mosaic, mixup, classifier geometry and
    blur tests with the port's functions and train_batches."""
    _port_augment(monkeypatch)
    rerun_jax_test(jta, name, {"tmp_path": tmp_path})


@pytest.mark.parametrize("module, name", [
    ("tests.test_grayscale", "test_gray_mosaic4_canvas_is_single_channel"),
    ("tests.test_native_decode",
     "test_classifier_crop_range_darknet_defaults"),
])
def test_jax_resampler_tests_hold_for_the_port(module, name, tmp_path,
                                               monkeypatch):
    import importlib

    _port_augment(monkeypatch)
    rerun_jax_test(importlib.import_module(module), name,
                   {"tmp_path": tmp_path})


def test_cli_blur_only_cfg_enables_augmentation(tmp_path, capsys,
                                                monkeypatch):
    """tests/test_augment.py's blur-only cfg command on the port's CLI
    (--device cpu): blur=/gaussian_noise= alone turn augmentation on."""
    import yolo_tpu.cli  # noqa: F401  (bound, then replaced)

    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(jta, "test_cli_blur_only_cfg_enables_augmentation",
                   {"tmp_path": tmp_path, "capsys": capsys})
