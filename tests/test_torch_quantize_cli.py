"""--precision int8 through the port's command line against the JAX
package's, on the CPU: the same argv (plus ``--device cpu``) on the same
seeded .weights and files.

Both commands calibrate on the same images (predict: the image; detect
--images: the first 8; eval and recall: the first 8 samples; classify:
the image or the imagefolder's first chunk; serve:
--calibration-image), preprocessed with the same geometry: the JAX CLI
letterboxes with native.preproc.letterbox_batch, the port with its host
resize (data/pipeline.py::_host_resize), whose letterbox is the C one of
native/letterbox.c. Tolerances:
  * the letterboxed and the stretched calibration batches equal byte
    for byte (the port's C stretch computes numpy_ref.stretch_resize's
    cv2.resize as OpenCV's IPP path does); the calibration scales of the
    two commands within rtol 1e-4 (the fp32 calibration forwards sum in
    other orders): test_calibration_inputs_and_scales_match_jax.
  * predict / detect: the same detections in the same order and class,
    each score within 2e-3 and each box corner within 1 px. The lines
    read equal at their printed rounding here; the bound leaves room for
    a few int8 codes to flip by one step where a scale lies a few ulps
    apart, or where the JAX command's jitted epilogue is contracted into
    an FMA (XLA:CPU may fuse acc * scale + bias; the port rounds the
    product, as the JAX package's eager block does).
  * eval: mAP and every class AP within 5e-3; recall: the same counts
    of ground truth, proposals within 1% and the rates within 5e-3.
  * classify: the same top labels in the same order, probabilities
    within 2e-3; imagefolder accuracy equal.
  * serve: without --calibration-image, and for a yolov1 topology, the
    JAX command's messages; an int8 server's HTTP answer equals a
    direct call of the same int8 detector.
"""

import argparse
import json

import numpy as np
import pytest
import torch

import yolo_tpu.cli as jcli
from tests.test_torch_cli import _lines, _voc, files  # noqa: F401
from yolo_tpu_torch import cli as tcli
from yolo_tpu_torch.configs import get_variant

CPU = ["--device", "cpu"]
SCORE_TOL = 2e-3
BOX_TOL = 1.0
MAP_TOL = 5e-3


def _both(argv, capsys):
    jcli.main(list(argv))
    want = capsys.readouterr().out
    tcli.main(list(argv) + CPU)
    got = capsys.readouterr().out
    return want, got


def _near_dets(want: list, got: list) -> None:
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g["class"] == w["class"]
        assert abs(g["score"] - w["score"]) <= SCORE_TOL
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], rtol=0,
                                   atol=BOX_TOL)


def _int8(argv):
    out = list(argv)
    out[out.index("fp32")] = "int8"
    return out


def test_calibration_inputs_and_scales_match_jax(files):
    """The two commands' calibration batches (the JAX CLI's
    letterbox_batch and numpy_ref.stretch_resize against the port's
    _host_resize, byte for byte) and the int8 params
    their _maybe_quantize makes from them (kernels equal, scales within
    rtol 1e-4)."""
    from tests.torch_port import to_jax_config
    from yolo_tpu.cli._common import _maybe_quantize as jmaybe
    from yolo_tpu.native.preproc import letterbox_batch
    from yolo_tpu.ops.numpy_ref import stretch_resize
    from yolo_tpu_torch.cli._common import _maybe_quantize as tmaybe
    from yolo_tpu_torch.data.pipeline import _host_resize, load_image
    from yolo_tpu_torch.io import darknet_weights as dw
    from yolo_tpu_torch.models.graph import fold_params

    cfg = get_variant("tiny-voc", input_size=96)
    params, _ = dw.load(files["tiny-voc"], cfg.layers)
    folded = fold_params(cfg.layers, params, cfg.bn_eps)
    img = load_image(files["image"], 3)
    for resize in ("letterbox", "stretch"):
        want = (letterbox_batch(img[None], cfg.input_hw)[0]
                if resize == "letterbox"
                else stretch_resize(img, cfg.input_w, cfg.input_h))
        got = _host_resize(img, cfg.input_hw, resize)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        args = argparse.Namespace(precision="int8", resize=resize,
                                  device="cpu")
        want = jmaybe(args, to_jax_config(cfg), folded, [img])
        got = tmaybe(args, cfg, folded, [img])
        for w, g in zip(want, got):
            assert set(g) == set(w)
            for k in ("kernel_q", "w_scale", "bias"):
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
            for k in set(w) & {"x_scale", "out_scale"}:
                np.testing.assert_allclose(g[k], np.asarray(w[k]),
                                           rtol=1e-4)


@pytest.mark.parametrize("resize", ["letterbox", "stretch"])
def test_predict_int8_matches_jax(files, capsys, resize):
    argv = _int8(["predict", *_voc(files, "--image", files["image"],
                                   "--conf", "0.1", "--resize", resize)])
    want, got = _both(argv, capsys)
    assert len(_lines(want)) >= 3
    _near_dets(_lines(want), _lines(got))


@pytest.mark.parametrize("mode", ["letterbox", "host"])
def test_detect_images_int8_matches_jax(files, capsys, mode):
    argv = _int8(["detect", *_voc(files, "--images", files["images"],
                                  "--batch", "2", "--conf", "0.1",
                                  "--recursive")])
    if mode == "host":
        argv.append("--host-preprocess")
    want, got = _both(argv, capsys)
    want, got = _lines(want), _lines(got)
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        assert g["image"] == w["image"]
        _near_dets(w["detections"], g["detections"])


def test_eval_and_recall_int8_match_jax(files, capsys):
    want, got = _both(_int8(["eval", *_voc(files, "--voc-root",
                                           files["voc"], "--split", "train",
                                           "--batch", "4")]), capsys)
    want, got = json.loads(want), json.loads(got)
    assert abs(got["map"] - want["map"]) <= MAP_TOL
    assert set(got["ap"]) == set(want["ap"])
    for c in want["ap"]:
        assert abs(got["ap"][c] - want["ap"][c]) <= MAP_TOL, c
    want, got = _both(_int8(["recall", *_voc(files, "--voc-root",
                                             files["voc"], "--split",
                                             "train", "--batch", "4")]),
                      capsys)
    want, got = json.loads(want), json.loads(got)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert abs(got[k] - w) <= MAP_TOL, k
        elif k == "proposals":
            assert abs(got[k] - w) <= 0.01 * w, k
        else:
            assert got[k] == w, k


def test_classify_int8_matches_jax(tmp_path, capsys):
    """`classify --image` and `classify --images` (calibrated on the
    first chunk) at --precision int8."""
    import cv2

    from tests.test_torch_classifier import _color_model

    cfg_path, names, wpath = _color_model(tmp_path)
    img = str(tmp_path / "g.png")
    x = np.zeros((40, 50, 3), np.uint8)
    x[..., 1] = 210
    cv2.imwrite(img, x[..., ::-1])
    root = tmp_path / "val"
    for ci, name in enumerate(("red", "green", "blue")):
        (root / name).mkdir(parents=True)
        for j in range(2):
            y = np.zeros((30, 40, 3), np.uint8)
            y[..., ci] = 150 + 40 * j
            cv2.imwrite(str(root / name / f"{j}.png"), y[..., ::-1])
    base = ["classify", "--cfg", cfg_path, "--names", names, "--weights",
            wpath, "--precision", "int8"]
    want, got = _both(base + ["--image", img, "--top", "3"], capsys)
    want, got = _lines(want), _lines(got)
    assert [g["class"] for g in got] == [w["class"] for w in want]
    for w, g in zip(want, got):
        assert abs(g["prob"] - w["prob"]) <= SCORE_TOL
    want, got = _both(base + ["--images", str(root), "--batch", "4",
                              "--top", "2"], capsys)
    assert json.loads(got) == json.loads(want)


def test_int8_refusals_match_jax(files, capsys, tmp_path):
    """serve --precision int8 without --calibration-image, and int8 on a
    yolov1 topology: the JAX commands' messages; detect --video on a
    webcam index stays refused under the native decoder (ROADMAP
    A12a: it reads AVI files; int8 video: tests/test_torch_video.py)."""
    from tests.test_yolov1 import _write_v1
    from yolo_tpu_torch.configs.darknet_cfg import config_from_cfg
    from yolo_tpu_torch.io import darknet_weights as dw

    argv = ["serve", "--model", "tiny-voc", "--weights", files["tiny-voc"],
            "--precision", "int8", "--port", "0"]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + CPU)
    assert str(got.value) == str(want.value) == \
        "--precision int8 needs --calibration-image"
    cfg_path = _write_v1(tmp_path)
    wpath = str(tmp_path / "v1.weights")
    cfg = config_from_cfg(cfg_path)
    dw.save(wpath, cfg.layers, dw.random_params(cfg.layers,
                                                np.random.default_rng(0)))
    argv = ["predict", "--cfg", cfg_path, "--weights", wpath, "--image",
            files["image"], "--precision", "int8"]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + CPU)
    assert str(got.value) == str(want.value)
    assert "yolov1" in str(got.value)
    with pytest.raises(SystemExit, match="A12"):
        tcli.main(["detect", "--weights", files["tiny-voc"], "--video", "0",
                   "--precision", "int8"] + CPU)


def test_int8_server_answers_as_a_direct_call(files):
    """The net `serve --precision int8 --calibration-image` builds,
    behind DetectionServer: the HTTP answer to a PNG body equals a direct
    call of the same int8 detector on the decoded frame."""
    import urllib.request

    from yolo_tpu_torch.cli.tools_cmds import _serve_net
    from yolo_tpu_torch.data.pipeline import load_image
    from yolo_tpu_torch.models.predict import make_detector
    from yolo_tpu_torch.serve import DetectionServer, detections_to_json

    cfg = get_variant("tiny-voc", input_size=96)
    args = argparse.Namespace(
        precision="int8", calibration_image=files["image"], device="cpu",
        weights=files["tiny-voc"], resize="letterbox")
    net = _serve_net(args, cfg, classifier=False)
    assert net.compute_dtype == torch.bfloat16 and all(net.quantized)
    with open(files["image"], "rb") as f:
        body = f.read()
    img = load_image(files["image"], 3)
    direct = detections_to_json(make_detector(cfg, conf_threshold=0.1)(
        net, torch.from_numpy(img[None])), cfg.class_names)[0]
    assert direct
    server = DetectionServer(cfg, net, port=0, conf_threshold=0.1)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/detect", data=body,
            headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
    finally:
        server.stop()
    assert answer["detections"] == direct


def test_load_refuses_int8_with_the_jax_message():
    """int8 is a CLI and models.quantize surface in both packages:
    load(precision="int8") raises the JAX API's ValueError, word for
    word."""
    import yolo_tpu_torch
    from yolo_tpu.api import _api_compute_dtype

    with pytest.raises(ValueError) as want:
        _api_compute_dtype("int8")
    with pytest.raises(ValueError) as got:
        yolo_tpu_torch.load("w.weights", device="cpu", precision="int8")
    assert str(got.value) == str(want.value)
