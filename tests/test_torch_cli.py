"""The port's command line (yolo_tpu_torch.cli) against the JAX package's
(yolo_tpu.cli), on the CPU: the same argv (plus ``--device cpu``) on the
same seeded .weights and files, ``--precision fp32``.

Tolerances:
  * predict / detect: the same detections in the same order and class;
    score within 1e-4 and each box corner within 0.1 px (the printed
    rounding: 4 and 1 decimals).
  * eval: every printed number within 1e-6 (VOC and COCO); the
    --save-detections JSON equal at its rounding (boxes 0.01 px, scores
    1e-5).
  * recall: the same counts, the rates within 1e-6.
  * anchors, zoo list: identical output; partial: identical bytes.
  * train, 2 SGD steps: the exported .weights within 2e-5 of each
    tensor's largest magnitude (tests/test_torch_train.py's bound for
    fp32 SGD steps); a run stopped after step 1 and resumed ends at the
    JAX command's step (the threads loader restarts at the first epoch)
    with its params and EMA track within that bound, the momentum
    within 1e-3 of each tensor's scale.
"""

import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_port import he_weights
from yolo_tpu import cli as jcli
from yolo_tpu_torch import cli as tcli
from yolo_tpu_torch.configs import get_variant
from yolo_tpu_torch.data.png import encode_png
from yolo_tpu_torch.data.synthetic import write_coco_scenes, write_voc_scenes
from yolo_tpu_torch.io import checkpoint as ckpt
from yolo_tpu_torch.io import darknet_weights as dw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
# the bound of tests/test_torch_train.py for fp32 SGD steps
STEP_TOL = 2e-5


def _run(main, argv, capsys):
    main(argv)
    cap = capsys.readouterr()
    return cap.out, cap.err


def _both(argv, capsys, port_extra=()):
    """(JAX stdout, port stdout) of one argv."""
    want, _ = _run(jcli.main, list(argv), capsys)
    got, _ = _run(tcli.main, list(argv) + CPU + list(port_extra), capsys)
    return want, got


def _same_dets(want: list, got: list) -> None:
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g["class"] == w["class"]
        assert abs(g["score"] - w["score"]) <= 1e-4 + 1e-9
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], rtol=0,
                                   atol=0.1 + 1e-6)


def _lines(text: str) -> list:
    return [json.loads(l) for l in text.strip().splitlines() if l]


def _close(a, b, tol=1e-6):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert abs(a - b) <= tol, (a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded tiny-voc and tiny-coco .weights (trained-detector-shaped:
    box channels x0.1, objectness -2), images, a VOC root and a COCO
    set."""
    d = tmp_path_factory.mktemp("cli")
    out = {"dir": d}
    for v in ("tiny-voc", "tiny-coco"):
        out[v] = str(d / f"{v}.weights")
        he_weights(get_variant(v), out[v], box_scale=0.1,
                   objectness_shift=-2.0)
    rng = np.random.default_rng(1)
    out["image"] = str(d / "in.png")
    with open(out["image"], "wb") as f:
        f.write(encode_png(rng.integers(0, 255, (96, 128, 3), np.uint8)))
    imgs = d / "imgs" / "images"
    (imgs / "sub").mkdir(parents=True)
    for i, (h, w) in enumerate([(64, 96), (96, 64), (80, 80), (64, 96)]):
        sub = imgs / "sub" if i == 3 else imgs
        with open(sub / f"m{i}.png", "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (h, w, 3), np.uint8)))
    out["images"] = str(imgs)
    # a VOC root of synthetic scenes: JPEGImages/, Annotations/, a split
    root = d / "VOC"
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (root / sub).mkdir(parents=True)
    pairs = write_voc_scenes(str(root / "JPEGImages"), [(90, 120)] * 12
                             + [(120, 90)] * 4, np.random.default_rng(3),
                             jpeg_quality=90)
    for _, xml in pairs:
        shutil.move(xml, root / "Annotations" / os.path.basename(xml))
    ids = [os.path.splitext(os.path.basename(p))[0] for p, _ in pairs]
    (root / "ImageSets/Main/train.txt").write_text("\n".join(ids) + "\n")
    out["voc"] = str(root)
    # the training tests' model: tiny-yolov2's head on a narrow trunk, as
    # a darknet .cfg/.names pair (its checkpoints are small)
    import dataclasses

    from yolo_tpu_torch.configs.darknet_cfg import cfg_to_string
    from yolo_tpu_torch.configs.specs import Conv, MaxPool

    narrow = dataclasses.replace(
        get_variant("tiny-voc", input_size=64), name="narrow-voc",
        layers=(Conv(8), MaxPool(), Conv(16), MaxPool(), Conv(16),
                MaxPool(), Conv(32), MaxPool(), Conv(32), MaxPool(),
                Conv(32), Conv(5 * 25, size=1, bn=False, act="linear")))
    out["narrow"] = narrow
    out["narrow_cfg"] = str(d / "narrow.cfg")
    out["narrow_names"] = str(d / "narrow.names")
    (d / "narrow.cfg").write_text(cfg_to_string(narrow))
    (d / "narrow.names").write_text("\n".join(narrow.class_names) + "\n")
    out["narrow_weights"] = str(d / "narrow.weights")
    he_weights(narrow, out["narrow_weights"], box_scale=0.1,
               objectness_shift=-2.0)
    coco = d / "coco"
    coco.mkdir()
    out["coco"] = write_coco_scenes(str(coco), [(96, 128)] * 4 + [(80, 64)],
                                    5)
    return out


def _voc(files, *extra):
    return ["--model", "tiny-voc", "--input-size", "96", "--weights",
            files["tiny-voc"], "--precision", "fp32", *extra]


@pytest.mark.parametrize("resize", ["letterbox", "stretch"])
def test_predict_matches_jax(files, capsys, tmp_path, resize):
    argv = ["predict", *_voc(files, "--image", files["image"], "--conf",
                             "0.1", "--resize", resize)]
    want, got = _both(argv, capsys,
                      ["--output", str(tmp_path / "out.png")])
    assert len(_lines(want)) >= 3
    _same_dets(_lines(want), _lines(got))
    # the annotated PNG is the source's size
    from yolo_tpu_torch.native.preproc import decode_image

    assert decode_image(str(tmp_path / "out.png")).shape == (96, 128, 3)


def test_predict_save_labels_and_profile(files, capsys, tmp_path):
    img = tmp_path / "solo.png"
    shutil.copy(files["image"], img)
    trace = tmp_path / "trace"
    argv = ["predict", *_voc(files, "--image", str(img), "--conf", "0.1",
                             "--save-labels")]
    _run(jcli.main, argv, capsys)
    want = (tmp_path / "solo.txt").read_text()
    os.remove(tmp_path / "solo.txt")
    out, err = _run(tcli.main, argv + CPU + ["--profile-dir", str(trace)],
                    capsys)
    got = (tmp_path / "solo.txt").read_text()
    assert f"wrote {tmp_path / 'solo.txt'}" in err
    assert len(got.splitlines()) == len(_lines(out)) >= 3
    for a, b in zip(want.splitlines(), got.splitlines()):
        assert a.split()[0] == b.split()[0]
        np.testing.assert_allclose([float(v) for v in b.split()[1:]],
                                   [float(v) for v in a.split()[1:]],
                                   rtol=0, atol=2e-4)
    assert json.load(open(trace / "trace.json"))["traceEvents"]


@pytest.mark.parametrize("mode", ["device", "host", "host-stretch"])
def test_detect_matches_jax(files, capsys, tmp_path, mode):
    extra = {"device": [], "host": ["--host-preprocess"],
             "host-stretch": ["--host-preprocess", "--resize", "stretch"]}
    argv = ["detect", *_voc(files, "--images", files["images"], "--batch",
                            "2", "--conf", "0.1", "--recursive",
                            "--save-labels", *extra[mode])]
    want, _ = _run(jcli.main, argv, capsys)
    labels = str(tmp_path / "labels")
    want_labels = sorted(glob.glob(os.path.join(
        os.path.dirname(files["images"]), "labels", "**", "*.txt"),
        recursive=True))
    shutil.move(os.path.join(os.path.dirname(files["images"]), "labels"),
                labels)
    got, _ = _run(tcli.main, argv + CPU + ["--output-dir",
                                           str(tmp_path / "ann")], capsys)
    want, got = _lines(want), _lines(got)
    assert [r["image"] for r in got] == [r["image"] for r in want]
    assert len(want) == 4 and sum(len(r["detections"]) for r in want) > 4
    for w, g in zip(want, got):
        _same_dets(w["detections"], g["detections"])
    got_labels = sorted(glob.glob(os.path.join(
        os.path.dirname(files["images"]), "labels", "**", "*.txt"),
        recursive=True))
    assert got_labels == want_labels and len(got_labels) == 4
    root = os.path.join(os.path.dirname(files["images"]), "labels")
    for path in got_labels:
        want_txt = open(os.path.join(labels, os.path.relpath(path, root))
                        ).read().split()
        got_txt = open(path).read().split()
        assert len(got_txt) == len(want_txt)
        np.testing.assert_allclose(np.float64(got_txt), np.float64(want_txt),
                                   rtol=0, atol=2e-4)
    shutil.rmtree(os.path.join(os.path.dirname(files["images"]), "labels"))
    # annotated copies mirror the source tree at the source sizes
    from yolo_tpu_torch.native.preproc import decode_image

    assert decode_image(str(tmp_path / "ann" / "sub" / "m3.png")).shape \
        == (64, 96, 3)
    assert len(glob.glob(str(tmp_path / "ann" / "**" / "*.png"),
                         recursive=True)) == 4


@pytest.mark.parametrize("metric", ["voc07", "voc10"])
def test_eval_voc_matches_jax(files, capsys, tmp_path, metric):
    argv = ["eval", *_voc(files, "--voc-root", files["voc"], "--split",
                          "train", "--batch", "4", "--metric", metric,
                          "--stats")]
    want, got = _both(argv, capsys)
    want, got = _lines(want)[-1], _lines(got)[-1]
    assert want["ap"]
    _close(want, got)


def test_eval_coco_save_and_score_detections(files, capsys, tmp_path):
    base = ["eval", "--model", "tiny-coco", "--input-size", "96",
            "--weights", files["tiny-coco"], "--precision", "fp32",
            "--coco-json", files["coco"], "--batch", "4", "--metric",
            "coco"]
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want, _ = _run(jcli.main, base + ["--save-detections", jpath], capsys)
    got, _ = _run(tcli.main, base + CPU + ["--save-detections", tpath],
                  capsys)
    _close(_lines(want)[-1], _lines(got)[-1])
    jd, td = json.load(open(jpath)), json.load(open(tpath))
    assert len(td) == len(jd) > 20
    for a, b in zip(jd, td):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-5 + 1e-9
        np.testing.assert_allclose(b["bbox"], a["bbox"], rtol=0,
                                   atol=0.01 + 1e-6)
    # --from-detections scores the saved file with no model run; and
    # writes the comp4 files
    want, _ = _run(jcli.main, base + ["--from-detections", jpath], capsys)
    got, _ = _run(tcli.main, base + ["--from-detections", jpath], capsys)
    assert _lines(got)[-1] == _lines(want)[-1]
    voc = ["eval", "--model", "tiny-voc", "--voc-root", files["voc"],
           "--split", "train", "--from-detections", jpath,
           "--save-voc-dir"]
    _run(jcli.main, voc + [str(tmp_path / "jv")], capsys)
    _run(tcli.main, voc + [str(tmp_path / "tv")], capsys)
    for f in sorted(os.listdir(tmp_path / "jv")):
        assert (tmp_path / "tv" / f).read_text() == \
            (tmp_path / "jv" / f).read_text()


def test_eval_accepts_a_port_checkpoint(files, capsys, tmp_path):
    """eval --weights <checkpoint dir> scores the checkpoint's params as
    the .weights file they came from."""
    cfg = get_variant("tiny-voc")
    params, _ = dw.load(files["tiny-voc"], cfg.layers)
    tree = {"params": [{k: torch.from_numpy(v) for k, v in p.items()}
                       for p in params], "step": 0, "seen": 0}
    ckpt.save(str(tmp_path / "ck"), tree)
    argv = ["eval", *_voc(files, "--voc-root", files["voc"], "--split",
                          "train", "--batch", "4")] + CPU
    want, _ = _run(tcli.main, argv, capsys)
    i = argv.index("--weights")
    got, _ = _run(tcli.main, argv[:i + 1] + [str(tmp_path / "ck")]
                  + argv[i + 2:], capsys)
    assert got == want


def test_recall_matches_jax(files, capsys):
    argv = ["recall", *_voc(files, "--voc-root", files["voc"], "--split",
                            "train", "--batch", "4")]
    want, got = _both(argv, capsys)
    want, got = _lines(want)[-1], _lines(got)[-1]
    assert want["total"] > 0 and want["proposals"] > 0
    _close(want, got)


def test_anchors_partial_and_zoo_match_jax(files, capsys, tmp_path):
    argv = ["anchors", "--model", "tiny-voc", "--voc-root", files["voc"],
            "--split", "train", "--num-anchors", "3", "--seed", "2"]
    want, _ = _run(jcli.main, argv, capsys)
    got, _ = _run(tcli.main, argv, capsys)
    assert got == want and json.loads(got)["num_boxes"] > 3
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        _run(main, ["partial", "--model", "tiny-voc", "--weights",
                    files["tiny-voc"], "--output",
                    str(tmp_path / f"{tag}.conv.6"), "--layers", "6"],
             capsys)
    assert (tmp_path / "t.conv.6").read_bytes() == \
        (tmp_path / "j.conv.6").read_bytes()
    want, _ = _run(jcli.main, ["zoo", "list"], capsys)
    got, _ = _run(tcli.main, ["zoo", "list"], capsys)
    assert got == want


def _narrow(files):
    return ["--cfg", files["narrow_cfg"], "--names", files["narrow_names"]]


def _train_argv(files, ckdir, *extra):
    return ["train", *_narrow(files), "--weights", files["narrow_weights"],
            "--voc-root", files["voc"],
            "--split", "train", "--batch", "8", "--lr", "1e-3",
            "--precision", "fp32", "--no-augment", "--seed", "3",
            "--checkpoint-dir", ckdir, "--checkpoint-every", "1", *extra]


def _weights_close(a_path, b_path, cfg):
    a, ha = dw.load(a_path, cfg.layers)
    b, hb = dw.load(b_path, cfg.layers)
    assert ha["seen"] == hb["seen"]
    for pa, pb in zip(a, b):
        for k in pa:
            scale = float(np.abs(pa[k]).max()) or 1.0
            np.testing.assert_allclose(pb[k], pa[k], rtol=0,
                                       atol=STEP_TOL * scale)


def test_train_two_steps_matches_jax(files, capsys, tmp_path):
    """2 SGD steps through both CLIs; each exports its final checkpoint
    and the .weights agree within STEP_TOL."""
    cfg = files["narrow"]
    _run(jcli.main, _train_argv(files, str(tmp_path / "jck")), capsys)
    _run(tcli.main, _train_argv(files, str(tmp_path / "tck")) + CPU,
         capsys)
    assert sorted(os.listdir(tmp_path / "tck")) == ["final", "step_1",
                                                    "step_2"]
    exp = ["export", *_narrow(files), "--output"]
    _run(jcli.main, exp + [str(tmp_path / "j.weights"), "--checkpoint",
                           str(tmp_path / "jck" / "final")], capsys)
    _run(tcli.main, exp + [str(tmp_path / "t.weights"), "--checkpoint",
                           str(tmp_path / "tck" / "final"), "--save-cfg",
                           str(tmp_path / "t.cfg")], capsys)
    _weights_close(str(tmp_path / "j.weights"), str(tmp_path / "t.weights"),
                   cfg)
    assert (tmp_path / "t.names").read_text().splitlines() == \
        list(cfg.class_names)
    # the exported file serves through load()
    import yolo_tpu_torch

    model = yolo_tpu_torch.load(str(tmp_path / "t.weights"), device="cpu",
                                cfg=str(tmp_path / "t.cfg"),
                                names=str(tmp_path / "t.names"))
    assert model.cfg.layers == cfg.layers


def _tree_close(a, b, tol, where="") -> None:
    """Tensors within tol of each one's largest magnitude, the rest
    equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _tree_close(a[k], b[k], tol, f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_close(x, y, tol, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        scale = float(a.abs().max()) or 1.0
        torch.testing.assert_close(b, a, rtol=0, atol=tol * scale,
                                   msg=lambda m: f"{where}: {m}")
    else:
        assert a == b, where


@pytest.mark.parametrize("ema", [False, True])
def test_train_resume_equals_uninterrupted(files, capsys, tmp_path, ema):
    """Stopped after step 1 (--fail-after-step) and --resume'd with the
    same argv, the port's run ends where the JAX command's does: its
    threads loader trains the epochs again from the first, so both end
    at step 3 (1 + an epoch of 2), with the same seen count; the params
    and the EMA track agree within STEP_TOL, the momentum within 1e-3
    of each tensor's scale."""
    import jax

    from yolo_tpu.io import checkpoint as jckpt

    extra = ["--ema-alpha", "0.5"] if ema else []
    finals = []
    for main, dev in ((jcli.main, []), (tcli.main, CPU)):
        ck = str(tmp_path / ("t" if dev else "j"))
        with pytest.raises(SystemExit, match="fail-after-step"):
            _run(main, _train_argv(files, ck, *extra) + dev
                 + ["--fail-after-step", "1"], capsys)
        assert "step_1" in os.listdir(ck)
        _run(main, _train_argv(files, ck, *extra) + dev
             + ["--resume", os.path.join(ck, "step_1")], capsys)
        finals.append(os.path.join(ck, "final"))
    want = ckpt.from_numpy_state(jax.device_get(jckpt.restore(finals[0])))
    got = ckpt.restore(finals[1])
    assert got["step"] == want["step"] == 3
    assert got["seen"] == want["seen"]
    assert ("ema_params" in got) == ("ema_params" in want) == ema
    assert got["opt_state"]["momentum_buffer"]
    for key in ("params", "ema_params"):
        if key in want:
            _tree_close(want[key], got[key], STEP_TOL, key)
    # the momentum is a sum of raw gradients: conv 0's fp32 weight
    # gradient differs between the packages by up to ~1e-4 of its scale
    _tree_close(want["opt_state"], got["opt_state"], 1e-3, "opt_state")


def test_jax_checkpoint_carries_across(files, capsys, tmp_path):
    """A JAX orbax checkpoint, converted by from_numpy_state, exports the
    same .weights bytes through both CLIs' export; the port resumes from
    it (params and momentum carried across), to the JAX command's step
    on the same --epochs."""
    import jax

    from yolo_tpu.io import checkpoint as jckpt

    jck = str(tmp_path / "jck")
    _run(jcli.main, _train_argv(files, jck, "--ema-alpha", "0.5"), capsys)
    state = jax.device_get(jckpt.restore(os.path.join(jck, "final")))
    tree = ckpt.from_numpy_state(state)
    assert tree["step"] == 2 and tree["opt_state"]["optimizer"] == "sgd"
    ckpt.save(str(tmp_path / "tck"), tree, model="narrow-voc")
    for live in ([], ["--live-weights"]):
        exp = ["export", *_narrow(files), *live, "--output"]
        _run(jcli.main, exp + [str(tmp_path / "j.weights"), "--checkpoint",
                               os.path.join(jck, "final")], capsys)
        _run(tcli.main, exp + [str(tmp_path / "t.weights"), "--checkpoint",
                               str(tmp_path / "tck")], capsys)
        assert (tmp_path / "t.weights").read_bytes() == \
            (tmp_path / "j.weights").read_bytes()
    # a third step from the carried state, in both packages
    _run(jcli.main, _train_argv(files, jck, "--ema-alpha", "0.5",
                                "--resume", os.path.join(jck, "final"),
                                "--epochs", "1"), capsys)
    out = str(tmp_path / "out")
    args = _train_argv(files, out, "--ema-alpha", "0.5", "--resume",
                       str(tmp_path / "tck"), "--epochs", "1") + CPU
    _run(tcli.main, args, capsys)
    want = jax.device_get(jckpt.restore(os.path.join(jck, "final")))
    assert ckpt.restore(os.path.join(out, "final"))["step"] == \
        int(want["step"]) == 4


def _sizes(log_path):
    return [r["size"] for r in map(json.loads, open(log_path))
            if "size" in r]


def test_multi_scale_sequence_matches_jax(files, capsys, tmp_path):
    """--multi-scale draws the JAX command's size for each step from the
    same seed; a cfg with random=1 turns it on."""
    argv = ["train", *_narrow(files), "--weights", files["narrow_weights"],
            "--voc-root", files["voc"],
            "--split", "train", "--batch", "8", "--precision", "fp32",
            "--no-augment", "--seed", "5", "--epochs", "4",
            "--multi-scale", "--multi-scale-sizes", "32,64,96",
            "--multi-scale-every", "1", "--log-file"]
    _run(jcli.main, argv + [str(tmp_path / "j.jsonl")], capsys)
    _run(tcli.main, argv + [str(tmp_path / "t.jsonl")] + CPU, capsys)
    want = _sizes(tmp_path / "j.jsonl")
    assert len(want) == 8 and len(set(want)) > 1
    assert _sizes(tmp_path / "t.jsonl") == want

    from yolo_tpu_torch.configs.darknet_cfg import cfg_to_string

    cfg = files["narrow"]
    (tmp_path / "m.cfg").write_text(cfg_to_string(cfg).replace(
        "[region]\n", "[region]\nrandom=1.5\n", 1))
    argv = ["train", "--cfg", str(tmp_path / "m.cfg"), "--names",
            files["narrow_names"], "--weights", files["narrow_weights"],
            "--voc-root", files["voc"], "--split", "train", "--batch", "8",
            "--grad-accum", "1", "--precision", "fp32", "--no-augment",
            "--seed", "1", "--epochs", "3", "--multi-scale-every", "1",
            "--log-file"]
    _run(jcli.main, argv + [str(tmp_path / "jr.jsonl")], capsys)
    _, err = _run(tcli.main, argv + [str(tmp_path / "tr.jsonl")] + CPU,
                  capsys)
    assert "cfg random=1.5: multi-scale range 32..96" in err
    want = _sizes(tmp_path / "jr.jsonl")
    assert len(want) == 6 and len(set(want)) > 1
    assert _sizes(tmp_path / "tr.jsonl") == want


@pytest.mark.parametrize("argv, item", [
    # the A10 cases are ported (YOLO9000 trees, the classifiers): each
    # now refuses a detector / classifier mix-up as the JAX CLI words it
    pytest.param(["classify", "--weights", "w"], "is not a classifier",
                 id="argv0-A10"),
    pytest.param(["predict", "--weights", "w", "--image", "x",
                  "--use-tree-map"], "apply only to YOLO9000 tree models",
                 id="argv1-A10"),
    # A11 and A12a are ported (int8 PTQ, detect --video): what stays
    # refused is a webcam index under the native decoder, which reads
    # AVI files (--decoder cv2 reads cameras), int8 or not
    pytest.param(["detect", "--weights", "w", "--video", "0",
                  "--precision", "int8"], "A12", id="argv2-A11"),
    (["detect", "--weights", "w", "--video", "0"], "A12"),
    # A12b and A9g are ported (serve --dp, --loader grain): with those
    # flags the JAX CLI's refusals stand
    pytest.param(["serve", "--weights", "w", "--dp", "--use-tree-map"],
                 "apply only to YOLO9000 tree models", id="argv4-A12"),
    (["bench"], "A13"),
    pytest.param(["train", "--weights", "w", "--voc-root", "r", "--loader",
                  "grain", "--multi-scale-every", "5"], "have no effect",
                 id="argv6-A9g"),
    pytest.param(["train", "--weights", "w", "--voc-root", "r",
                  "--imagefolder", "d"], "classifier training data",
                 id="argv7-A10"),
    pytest.param(["predict", "--model", "darknet53", "--weights", "w",
                  "--image", "x"], "is a classifier", id="argv8-A10"),
])
def test_unported_parts_raise_naming_their_item(argv, item):
    with pytest.raises(SystemExit, match=item):
        tcli.main(argv + (CPU if argv[0] != "bench" else []))


def test_train_mosaic_raises_naming_a9f(files, tmp_path, capsys):
    """--mosaic (ROADMAP A9f, once refused) trains and checkpoints;
    what still raises is mosaic with mixup, in the JAX CLI's words,
    before anything is written."""
    argv = _train_argv(files, str(tmp_path / "ck"), "--mosaic") + CPU
    argv.remove("--no-augment")
    with pytest.raises(SystemExit, match="pick one"):
        tcli.main(argv + ["--mixup"])
    assert not os.path.exists(tmp_path / "ck")
    tcli.main(argv)
    assert os.path.exists(tmp_path / "ck")


def test_device_cuda_without_a_card_raises(files, capsys, monkeypatch):
    """--device cuda (the default) raises without a card; nothing falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        tcli.main(["predict", *_voc(files, "--image", files["image"])])


def test_doctor_reports(capsys):
    rep = json.loads(_run(tcli.main, ["doctor"], capsys)[0])
    assert rep["torch"] == torch.__version__
    assert isinstance(rep["native_library"], dict)
    assert isinstance(rep["zoo_present"], list)
    if not torch.cuda.is_available():
        assert str(rep["cuda_kernels"]).startswith("failed")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_never_loads_jax(files, tmp_path):
    """Every command that runs here, in one fresh process of
    ``python -m yolo_tpu_torch``: no module of jax, yolo_tpu or cv2 is
    loaded after each."""
    code = f"""
import sys
from yolo_tpu_torch.cli import main
def check(argv):
    try:
        main(argv)
    except SystemExit as e:
        assert e.code in (None, 0), (argv, e.code)
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('jax', 'yolo_tpu', 'cv2'))
    assert not bad, (argv, bad)
w = {files['tiny-voc']!r}
common = ['--model', 'tiny-voc', '--input-size', '64', '--weights', w,
          '--precision', 'fp32', '--device', 'cpu']
voc = ['--voc-root', {files['voc']!r}, '--split', 'train']
check(['predict', *common, '--image', {files['image']!r},
       '--output', {str(tmp_path / 'o.jpg')!r}])
check(['detect', *common, '--images', {files['images']!r}, '--batch', '2'])
check(['eval', *common, *voc, '--batch', '4'])
check(['recall', *common, *voc, '--batch', '4'])
check(['anchors', '--model', 'tiny-voc', *voc])
check(['partial', '--model', 'tiny-voc', '--weights', w, '--output',
       {str(tmp_path / 'p')!r}, '--layers', '4'])
narrow = ['--cfg', {files['narrow_cfg']!r}, '--names',
          {files['narrow_names']!r}]
check(['train', *narrow, '--weights', {files['narrow_weights']!r}, *voc,
       '--batch', '4', '--no-augment', '--precision', 'fp32', '--device',
       'cpu', '--checkpoint-dir', {str(tmp_path / 'ck')!r}])
check(['export', *narrow, '--checkpoint',
       {str(tmp_path / 'ck' / 'final')!r}, '--output',
       {str(tmp_path / 'e.weights')!r}])
check(['zoo', 'list'])
check(['doctor'])
print('clean')
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), cwd=str(tmp_path),
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")


@pytest.mark.parametrize("module", ["yolo_tpu_torch", "yolo_tpu_torch.cli"])
def test_python_dash_m_entry_points(module, tmp_path):
    proc = subprocess.run([sys.executable, "-m", module, "zoo", "list"],
                          capture_output=True, text=True, env=_env(),
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "yolov2" in json.loads(proc.stdout)


def test_metrics_logger_and_profiling_utils(tmp_path, capsys):
    """MetricsLogger writes the JAX logger's records (tensors fetched
    in one copy, the --log-every sampling, force); timeit and
    PhaseTimer time on the host clock after a synchronization."""
    from yolo_tpu.utils.metrics import MetricsLogger as JaxLogger
    from yolo_tpu_torch.utils.metrics import MetricsLogger
    from yolo_tpu_torch.utils.profiling import PhaseTimer, timeit

    recs = {}
    for tag, cls, val in (("j", JaxLogger, np.float32(0.123456789)),
                          ("t", MetricsLogger, torch.tensor(0.123456789))):
        with cls(path=str(tmp_path / f"{tag}.jsonl"), every=2) as log:
            for step in (1, 2, 3):
                log.log(step, {"loss": val, "coord": 2.0}, size=416)
            log.log(3, {"val_map": 0.5}, force=True)
        recs[tag] = [json.loads(l) for l in open(tmp_path / f"{tag}.jsonl")]
        capsys.readouterr()
    for r in recs["j"] + recs["t"]:
        r.pop("time")
    assert recs["t"] == recs["j"] and [r["step"] for r in recs["t"]] == [2, 3]
    assert timeit(lambda: sum(range(1000)), n=3) > 0
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            sum(range(1000))
    assert set(timer.times) == {"a"} and timer.times["a"] > 0
