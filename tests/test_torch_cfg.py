"""The port's darknet .cfg parser, weights zoo and load(cfg=...) against
the JAX package on the CPU (yolo_tpu_torch/configs/darknet_cfg.py,
yolo_tpu_torch/io/zoo.py, yolo_tpu_torch/api.py).

Parser parity is exact: on the same file both packages give configs
equal field for field (through tests/torch_port.py::to_jax_config), the
same cfg_to_string bytes, the same net_training_params, the same stderr
warnings, or the same exception type and message; the yolov1, classifier
and YOLO9000 [region] tree=/map= sections are compared as the rest. The
cfg texts are every text the JAX package's parser tests write (their tests are run here with the parser
swapped for one that runs both packages and compares them), the cfg
texts of the scaled-yolov4, rectangular, weighted-shortcut, dilation
and Gaussian tests, the cfg_to_string of every built-in variant and a
seeded fuzz of detection topologies.
"""

import contextlib
import dataclasses
import inspect
import io
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import yolo_tpu.configs.darknet_cfg as jdc
from tests import test_darknet_cfg as t_cfg
from tests import test_dilation as t_dil
from tests import test_gaussian_yolo as t_gauss
from tests import test_rect as t_rect
from tests import test_scaled_yolov4 as t_scaled
from tests import test_weighted_shortcut as t_wsc
from tests import test_zoo as t_zoo
from tests.torch_port import he_weights, to_jax_config, to_port_config
from yolo_tpu.io import zoo as jzoo
import yolo_tpu_torch
import yolo_tpu_torch.configs.darknet_cfg as tdc
from yolo_tpu_torch.configs import (VARIANTS, AvgPool, Conv, MaxPool,
                                    ModelConfig, Route, Sam, ScaleChannels,
                                    Shortcut, Upsample, YoloHead,
                                    get_variant, layer_strides)
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.io import zoo
from yolo_tpu_torch.models.predict import detect_raw
from yolo_tpu_torch.train.loop import TrainConfig, train_config_from_cfg
from yolo_tpu_torch.train.loss import yolo_loss_config

torch.set_num_threads(1)

J_CONFIG, J_C2S = jdc.config_from_cfg, jdc.cfg_to_string
J_TRAIN, J_PARSE, J_NAMES = (jdc.net_training_params, jdc.parse_cfg,
                             jdc.load_names)

def _run(fn, *args, **kw):
    """(result, exception, stderr) of one call."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        try:
            return fn(*args, **kw), None, buf.getvalue()
        except Exception as e:  # noqa: BLE001 — compared below
            return None, e, buf.getvalue()


def _same_error(got, want, where):
    assert type(got) is type(want) and str(got) == str(want), (
        f"{where}: port raised {got!r}, the JAX package {want!r}")


class Dual:
    """The JAX package's parser entry points, each also run through the
    port's and held to it; counts the comparisons made."""

    def __init__(self):
        self.configs = self.texts = self.params = self.sections = 0

    def config_from_cfg(self, cfg_path, names_path=None, name=None):
        want, jerr, jlog = _run(J_CONFIG, cfg_path, names_path=names_path,
                                name=name)
        got, perr, plog = _run(tdc.config_from_cfg, cfg_path,
                               names_path=names_path, name=name)
        sys.stderr.write(jlog)
        if jerr is not None:
            _same_error(perr, jerr, cfg_path)
        else:
            assert perr is None, f"{cfg_path}: port raised {perr!r}"
            assert to_jax_config(got) == want, cfg_path
            assert plog == jlog, cfg_path
            self.configs += 1
        if jerr is not None:
            raise jerr
        return want

    def cfg_to_string(self, cfg):
        text = J_C2S(cfg)
        port = to_port_config(cfg)
        if port is not None:
            assert tdc.cfg_to_string(port) == text
            self.texts += 1
        return text

    def net_training_params(self, cfg_path):
        want, jerr, _ = _run(J_TRAIN, cfg_path)
        got, perr, _ = _run(tdc.net_training_params, cfg_path)
        if jerr is not None:
            _same_error(perr, jerr, cfg_path)
            raise jerr
        assert got == want, cfg_path
        self.params += 1
        return want

    def parse_cfg(self, path):
        want, jerr, _ = _run(J_PARSE, path)
        got, perr, _ = _run(tdc.parse_cfg, path)
        if jerr is not None:
            _same_error(perr, jerr, path)
            raise jerr
        assert got == want, path
        self.sections += 1
        return want

    def load_names(self, path):
        assert tdc.load_names(path) == J_NAMES(path)
        return J_NAMES(path)


# the JAX package's parser tests: (module, test) of every test that
# parses cfg texts and runs nothing past the parser
JAX_PARSER_TESTS = [
    (t_cfg, "TestParse.test_tiny_voc_cfg_reproduces_variant"),
    (t_cfg, "TestParse.test_full_coco_cfg_reproduces_variant"),
    (t_cfg, "TestParse.test_names_file"),
    (t_cfg, "TestParse.test_comments_and_sections"),
    (t_cfg, "TestParse.test_errors"),
    (t_cfg, "test_fuzz_random_topologies_round_trip"),
    (t_cfg, "test_region_thresh_parsed_and_round_trips"),
    (t_cfg, "test_parser_never_crashes_on_mangled_cfgs"),
    (t_cfg, "test_cfg_roundtrip_all_variants"),
    (t_cfg, "test_downsample_validation"),
    (t_cfg, "test_pad_zero_3x3_rejected"),
    (t_cfg, "test_nms_kind_parsed_and_round_trips"),
    (t_cfg, "test_net_training_params_random_and_jitter"),
    (t_cfg, "test_yolo_training_keys_parse"),
    (t_cfg, "test_random_jitter_from_last_head"),
    (t_cfg, "test_greedy_heads_with_differing_beta_accepted"),
    (t_cfg, "test_fuzz_v1_and_classifier_topologies_round_trip"),
    (t_cfg, "test_upsample_scale_and_maxpool_padding_guard"),
    (t_cfg, "test_region_loss_keys_flow"),
    (t_cfg, "test_cfg_key_audit"),
    (t_cfg, "test_cfg_parser_fuzz_never_crashes"),
    (t_cfg, "test_darknet_parse_defaults"),
    (t_scaled, "TestScaledCfg.test_parse"),
    (t_scaled, "TestScaledCfg.test_round_trip"),
    (t_scaled, "TestScaledCfg.test_objectness_smooth_parses_and_round_trips"),
    (t_scaled, "TestScaledCfg.test_new_coords_requires_logistic_conv"),
    (t_scaled, "TestScaledCfg.test_logistic_conv_requires_new_coords"),
    (t_rect, "test_parse_rect_cfg_and_round_trip"),
    (t_rect, "test_rect_resize_contract"),
    (t_rect, "test_rect_region_cfg_parses"),
    (t_wsc, "test_parse_and_round_trip"),
    (t_wsc, "test_per_layer_alias_and_rejections"),
    (t_dil, "TestCfgParse.test_dilation_parsed_and_1x1_forced"),
    (t_dil, "TestCfgParse.test_dilation_no_longer_warns_unimplemented"),
    (t_dil, "TestCfgParse.test_bad_dilation_rejects"),
    (t_dil, "TestCfgParse.test_round_trip_through_cfg_text"),
    (t_gauss, "TestGaussianCfg.test_parse"),
    (t_gauss, "TestGaussianCfg.test_round_trip"),
    (t_gauss, "TestGaussianCfg.test_head_conv_channels_validated"),
    (t_gauss, "TestGaussianCfg.test_new_coords_combination_rejected"),
]


def _call_jax_test(module, name, fixtures):
    """Run one of the JAX package's tests, its fixtures by name."""
    owner, _, fn_name = name.rpartition(".")
    fn = (getattr(getattr(module, owner)(), fn_name) if owner
          else getattr(module, fn_name))
    params = inspect.signature(fn).parameters
    fn(**{p: fixtures[p] for p in params})


@pytest.mark.parametrize("module,name", JAX_PARSER_TESTS,
                         ids=[f"{m.__name__.split('.')[-1]}::{n}"
                              for m, n in JAX_PARSER_TESTS])
def test_jax_parser_tests_hold_for_the_port(module, name, tmp_path, capsys,
                                            monkeypatch):
    """Each of the JAX package's parser tests, run with its parser
    entry points swapped for Dual's: it passes as it does alone, and on
    every cfg it writes the port agrees with the JAX package (configs,
    cfg_to_string bytes, net_training_params, stderr, exceptions),
    mangled cfgs (test_parser_never_crashes_on_mangled_cfgs,
    test_cfg_parser_fuzz_never_crashes) included."""
    dual = Dual()
    for mod in (jdc, module):
        for attr in ("config_from_cfg", "cfg_to_string",
                     "net_training_params", "parse_cfg", "load_names"):
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr, getattr(dual, attr))
    _call_jax_test(module, name, {"tmp_path": tmp_path, "capsys": capsys,
                                  "monkeypatch": monkeypatch})
    assert dual.configs + dual.sections + dual.params > 0


# --- the cfg texts of the JAX tests ------------------------------------------

def _texts():
    out = {"tiny_voc": t_cfg.TINY_VOC_CFG, "full_coco": t_cfg._full_coco_cfg(),
           "scaled": t_scaled.SCALED_CFG, "composite": t_scaled.COMPOSITE_CFG,
           "rect_yolo": t_rect.RECT_YOLO_CFG,
           "rect_region": t_rect.RECT_REGION_CFG,
           "dilated": t_dil.DILATED_CFG, "gauss": t_gauss.GAUSS_CFG}
    for wt in ("per_feature", "per_layer", "per_channel"):
        for wn in (None, "relu", "softmax"):
            out[f"weighted_{wt}_{wn}"] = t_wsc.WCFG.format(
                wt=wt, wn=f"weights_normalization={wn}\n" if wn else "")
    return out


TEXTS = _texts()


def _check_text(path, names=None):
    """Both parsers on one file: configs equal, cfg_to_string bytes
    equal, net_training_params equal, and the port's text parses back
    to the port's config in both packages. Returns the port's config."""
    got = tdc.config_from_cfg(str(path), names_path=names)
    want = J_CONFIG(str(path), names_path=names)
    assert to_jax_config(got) == want
    text = tdc.cfg_to_string(got)
    assert text == J_C2S(want)
    assert tdc.net_training_params(str(path)) == J_TRAIN(str(path))
    back = path.parent / (path.stem + "_back.cfg")
    back.write_text(text)
    again = tdc.config_from_cfg(str(back), name=got.name)
    assert again.layers == got.layers and again.input_hw == got.input_hw
    assert to_jax_config(again) == J_CONFIG(str(back), name=got.name)
    return got


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_jax_test_cfg_texts_parse_alike(name, tmp_path):
    p = tmp_path / f"{name}.cfg"
    p.write_text(TEXTS[name])
    cfg = _check_text(p)
    if name.startswith("rect"):
        assert cfg.input_h != cfg.input_w and cfg.input_width is not None
    if name.startswith("weighted"):
        assert any(isinstance(l, Shortcut) and l.weights_type != "none"
                   for l in cfg.layers)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_cfg_text_matches_jax(variant, tmp_path):
    """cfg_to_string of every built-in variant: the same bytes as the JAX
    package's; parsed with its names file, the variant's own config
    (up to iou_normalizer on the mse-loss variants: both packages'
    cfg_to_string omit iou_normalizer=1 and their parsers default it to
    0.75, which the mse loss never reads — ROADMAP C5)."""
    cfg = get_variant(variant)
    text = tdc.cfg_to_string(cfg)
    assert text == J_C2S(to_jax_config(cfg))
    p = tmp_path / f"{variant}.cfg"
    p.write_text(text)
    names = tmp_path / "v.names"
    names.write_text("\n".join(cfg.class_names) + "\n")
    got = _check_text(p, names=str(names))
    got = dataclasses.replace(got, name=cfg.name)
    if cfg.iou_loss == "mse":
        got = dataclasses.replace(got, iou_normalizer=cfg.iou_normalizer)
    assert got == cfg


def _fuzz_config(rng, trial):
    """A random detection topology over the port's layer vocabulary:
    grouped, depthwise and dilated convs of every activation, pools,
    weighted and plain shortcuts, sam, SE blocks (avgpool, logistic 1x1
    conv, scale_channels) and routes, ending in one or two heads of the
    classic, new_coords or Gaussian kind, on a square or rectangular
    net."""
    acts = ["leaky", "linear", "mish", "swish", "relu", "ramp"]
    layers = [Conv(16, stride=2, act=str(rng.choice(acts)))]
    ch = [16]
    for _ in range(int(rng.integers(3, 8))):
        kind = int(rng.integers(0, 7))
        if kind == 0:
            oc = int(rng.choice([8, 16]))
            g = int(rng.choice([1, 2, 8, ch[-1]])) \
                if oc % 8 == 0 and ch[-1] % 8 == 0 else 1
            g = g if oc % g == 0 and ch[-1] % g == 0 else 1
            size = int(rng.choice([1, 3]))
            layers.append(Conv(oc, size=size, groups=g,
                               dilation=int(rng.choice([1, 2]))
                               if size == 3 else 1,
                               bn=bool(rng.integers(0, 2)),
                               act=str(rng.choice(acts))))
            ch.append(oc)
        elif kind == 1:
            layers.append(MaxPool(int(rng.choice([2, 3, 5])), 1))
            ch.append(ch[-1])
        elif kind in (2, 3) and len(layers) >= 2 and ch[-1] == ch[-2]:
            wt = str(rng.choice(["none", "per_feature", "per_channel"]))
            wn = "none" if wt == "none" else str(
                rng.choice(["none", "relu", "softmax"]))
            layers.append(Shortcut(-2, act=str(rng.choice(["linear",
                                                           "leaky"])),
                                   weights_type=wt, weights_norm=wn)
                          if kind == 2 else Sam(-2))
            ch.append(ch[-1])
        elif kind == 4:
            layers.append(Route((-1,)))
            ch.append(ch[-1])
        elif kind == 5:
            src = ch[-1]
            layers += [AvgPool(), Conv(src, 1, act="logistic"),
                       ScaleChannels(-3)]
            ch += [src, src, src]
        elif kind == 6:
            layers.append(Conv(ch[-1], 1, act="logistic"))
            layers.append(ScaleChannels(-2, scale_wh=0))
            ch += [ch[-1], ch[-1]]
    c = 3
    kinds = rng.choice(["classic", "new_coords", "gaussian"],
                       size=int(rng.integers(1, 3)))
    if "gaussian" in kinds and "new_coords" in kinds:
        kinds = ["gaussian"]
    for h, k in enumerate(kinds):
        if h:
            layers += [Route((-3,)), Upsample(2)]
        per = (9 if k == "gaussian" else 5) + c
        layers.append(Conv(2 * per, 1, bn=False,
                           act="logistic" if k == "new_coords"
                           else "linear"))
        layers.append(YoloHead((2 * h, 2 * h + 1),
                               scale_xy=float(rng.choice([1.0, 1.05, 2.0])),
                               new_coords=k == "new_coords",
                               gaussian=k == "gaussian"))
    h, w = [(64, 64), (64, 96), (96, 64), (128, 192)][trial % 4]
    return ModelConfig(name=f"fuzz{trial}", layers=tuple(layers),
                       anchors=((10, 14), (23, 27), (37, 58), (81, 82)),
                       class_names=("a", "b", "c"), input_size=h,
                       input_width=None if w == h else w,
                       iou_loss=str(rng.choice(["mse", "ciou"])),
                       iou_normalizer=float(rng.choice([1.0, 0.07])),
                       ignore_thresh=float(rng.choice([0.5, 0.7])))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_detection_topologies_parse_alike(seed, tmp_path):
    """Seeded random detection topologies (darknet_cfg test :315's
    manner, over the whole vocabulary the port has): cfg_to_string gives
    the JAX package's bytes, and the text parses back to the same layers
    and net size in both packages."""
    rng = np.random.default_rng(seed)
    for trial in range(8):
        cfg = _fuzz_config(rng, trial)
        text = tdc.cfg_to_string(cfg)
        assert text == J_C2S(to_jax_config(cfg))
        p = tmp_path / f"f{trial}.cfg"
        p.write_text(text)
        got = _check_text(p)
        assert got.layers == cfg.layers, f"seed {seed} trial {trial}"
        assert got.input_hw == cfg.input_hw
        assert list(layer_strides(got.layers)) == \
            jdc.layer_strides(to_jax_config(got).layers)


A10_SECTIONS = {
    "connected": "[connected]\noutput=10\nactivation=linear\n",
    "dropout": "[dropout]\nprobability=.5\n",
    "softmax": "[softmax]\ngroups=1\n",
    "crop": "[crop]\ncrop_width=32\ncrop_height=32\n",
    "local": "[local]\nfilters=8\nsize=3\nstride=1\npad=1\n"
             "activation=leaky\n",
    "detection": "[detection]\nclasses=2\nside=2\nnum=1\n",
}


@pytest.mark.parametrize("section", sorted(A10_SECTIONS) + ["region_tree"])
def test_a10_sections_raise_not_implemented(section, tmp_path):
    """The sections of ROADMAP A10 are ported: the yolov1 sections
    ([crop], [local], [detection]), the classifier sections and the
    YOLO9000 [region] tree= key. The port parses each text as the JAX
    package does, to the same config or the same exception and message
    (here: no head section after a bare [connected]/[dropout], a [crop]
    after a conv, a [detection] after a [local]; an absent tree
    file)."""
    conv = "[convolutional]\nfilters=8\nsize=3\npad=1\nactivation=leaky\n"
    if section == "region_tree":
        text = (f"[net]\nwidth=64\nheight=64\n{conv}"
                "[region]\nanchors=1,1\nclasses=2\nnum=1\ntree=x.tree\n")
    else:
        text = f"[net]\nwidth=64\nheight=64\n{conv}{A10_SECTIONS[section]}"
    p = tmp_path / f"{section}.cfg"
    p.write_text(text)
    want, jerr, _ = _run(J_CONFIG, str(p))
    got, perr, _ = _run(tdc.config_from_cfg, str(p))
    if jerr is not None:
        _same_error(perr, jerr, str(p))
    else:
        assert perr is None and to_jax_config(got) == want


# --- load(cfg=...) --------------------------------------------------------------

@pytest.mark.parametrize("variant", ["tiny-voc", "yolov3-tiny"])
def test_load_cfg_equals_the_builtin_variant(variant, tmp_path):
    """load(weights, cfg=cfg_to_string(variant), names=...) on the same
    .weights gives the built-in variant's detections, bit for bit."""
    cfg = get_variant(variant, input_size=96)
    wpath = str(tmp_path / "w.weights")
    he_weights(cfg, wpath)
    p = tmp_path / "v.cfg"
    p.write_text(tdc.cfg_to_string(cfg))
    names = tmp_path / "v.names"
    names.write_text("\n".join(cfg.class_names) + "\n")
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 72, 100, 3), dtype=np.uint8))
    for precision in ("fp32", "bf16"):
        built = yolo_tpu_torch.load(wpath, variant, input_size=96,
                                    device="cpu", precision=precision)
        parsed = yolo_tpu_torch.load(wpath, cfg=str(p), names=str(names),
                                     device="cpu", precision=precision)
        assert parsed.cfg.layers == cfg.layers
        assert parsed.cfg.class_names == cfg.class_names
        want, got = built(images), parsed(images)
        for key in want:
            assert torch.equal(got[key], want[key]), (precision, key)
        for route in ("torch", "cuda"):
            a = detect_raw(cfg, built.params, images, conv_impl=route)
            b = detect_raw(parsed.cfg, parsed.params, images,
                           conv_impl=route)
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_load_rect_cfg_matches_jax_load(tmp_path):
    """The rectangular test cfg (192x128) loaded by both packages' load
    on the same .weights: fp32 detections alike (kept sets equal,
    scores 1e-4, pixel boxes 1e-2)."""
    import yolo_tpu

    p = tmp_path / "rect.cfg"
    p.write_text(t_rect.RECT_YOLO_CFG)
    cfg = tdc.config_from_cfg(str(p))
    wpath = str(tmp_path / "w.weights")
    he_weights(cfg, wpath)
    images = np.random.default_rng(3).integers(0, 256, (2, 90, 200, 3),
                                               dtype=np.uint8)
    got = yolo_tpu_torch.load(wpath, cfg=str(p), device="cpu",
                              precision="fp32",
                              conf_threshold=0.3)(images)
    want = yolo_tpu.load(wpath, cfg=str(p), precision="fp32",
                         conf_threshold=0.3)(images)
    v = np.asarray(want["valid"])
    assert v.sum() >= 2
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["classes"].numpy()[v],
                                  np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(
        want["scores"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(
        want["boxes"])[v], rtol=0, atol=1e-2)


def test_load_refusals(tmp_path, monkeypatch):
    """load raises as the JAX package's does: a partial-backbone zoo
    entry cannot drive a detector, an absent zoo file raises with its
    public URL; a directory that holds no checkpoint of the port raises
    naming the converter of JAX checkpoints (tests/test_torch_predict.py
    loads one that does); a rectangular cfg refuses a square
    input_size."""
    monkeypatch.setenv("YOLO_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="partial backbone"):
        yolo_tpu_torch.load("zoo://darknet19-448-conv23", device="cpu")
    with pytest.raises(FileNotFoundError, match="yolov3.weights"):
        yolo_tpu_torch.load("zoo://yolov3", device="cpu")
    with pytest.raises(KeyError, match="unknown zoo entry"):
        yolo_tpu_torch.load("zoo://nope", device="cpu")
    with pytest.raises(FileNotFoundError, match="ckpt_to_torch"):
        yolo_tpu_torch.load(str(tmp_path), "coco", device="cpu")
    p = tmp_path / "rect.cfg"
    p.write_text(t_rect.RECT_YOLO_CFG)
    with pytest.raises(ValueError, match="rectangular"):
        yolo_tpu_torch.load(str(tmp_path / "w.weights"), cfg=str(p),
                            input_size=128, device="cpu")


def test_load_zoo_entry_from_weights_dir(tmp_path, monkeypatch):
    """zoo://yolov3-tiny resolves to a seeded file of the official size
    under YOLO_TPU_WEIGHTS_DIR, verifies, and loads the variant the
    entry names; its sha256 pinned by record_sha then verifies."""
    monkeypatch.setenv("YOLO_TPU_WEIGHTS_DIR", str(tmp_path))
    cfg = get_variant("yolov3-tiny")
    path = tmp_path / "yolov3-tiny.weights"
    dw.save(str(path), cfg.layers,
            dw.random_params(cfg.layers, np.random.default_rng(0)))
    model = yolo_tpu_torch.load("zoo://yolov3-tiny", device="cpu",
                                input_size=64)
    assert model.cfg.layers == cfg.layers and model.cfg.input_size == 64
    mp = tmp_path / "manifest.json"
    mp.write_text(json.dumps(zoo.load_manifest()))
    sha = zoo.record_sha("yolov3-tiny", str(path), manifest_path=str(mp))
    assert sha == jzoo.sha256_file(str(path))
    assert zoo.resolve("zoo://yolov3-tiny", manifest_path=str(mp)) == \
        str(path)


# --- the zoo ---------------------------------------------------------------------

def test_zoo_manifest_is_the_jax_package_s():
    with open(jzoo._MANIFEST_PATH, "rb") as f:
        want = f.read()
    with open(zoo._MANIFEST_PATH, "rb") as f:
        assert f.read() == want
    assert zoo.load_manifest() == jzoo.load_manifest()


@pytest.mark.parametrize("name", [
    "TestResolveVerify.test_resolve_ok_and_errors",
    "TestResolveVerify.test_size_mismatch_fatal",
    "TestResolveVerify.test_16_byte_header_variant_accepted",
    "TestResolveVerify.test_sha_pin_and_verify"])
def test_jax_zoo_tests_hold_for_the_port(name, tmp_path, monkeypatch):
    """tests/test_zoo.py's resolve / verify / record_sha tests, run on
    the port's zoo module."""
    monkeypatch.setattr(t_zoo, "zoo", zoo)
    _call_jax_test(t_zoo, name, {"tmp_path": tmp_path,
                                 "monkeypatch": monkeypatch})


def test_zoo_sizes_and_infer_variant_match_jax(tmp_path):
    """expected_weights_bytes equals the JAX package's for every entry
    the port can build (every entry since the classifiers are ported),
    the manifest's sizes included, and infer_variant names the same
    variant on a file of each size: the entry's, or the first variant of
    its topology (darknet19-448's file is darknet19's size, and both
    packages name darknet19)."""
    for name, e in zoo.load_manifest().items():
        if e["variant"] not in VARIANTS:
            continue
        cfg = get_variant(e["variant"])
        layers = cfg.layers[:e.get("cutoff_layers", len(cfg.layers))]
        assert zoo.expected_weights_bytes(layers) == e["size_bytes"] == \
            jzoo.expected_weights_bytes(to_jax_config(cfg).layers[
                :len(layers)]), name
        if e.get("cutoff_layers"):
            continue
        p = tmp_path / f"{name}.weights"
        with open(p, "wb") as f:
            f.truncate(e["size_bytes"])
        inferred = zoo.infer_variant(str(p))
        assert inferred == jzoo.infer_variant(str(p)), name
        assert get_variant(inferred).layers == cfg.layers, name
    assert zoo.weights_dir() == jzoo.weights_dir()


# --- training hyperparameters from a cfg -----------------------------------------

NET_KEYS = {
    "steps": "batch=64\nsubdivisions=16\nlearning_rate=0.001\nburn_in=1000\n"
             "momentum=0.949\ndecay=0.0005\npolicy=steps\n"
             "steps=400000,450000\nscales=.1,.1\nmax_batches=500500\n",
    "poly": "learning_rate=0.01\npolicy=poly\npower=4\nmax_batches=100\n",
    "step": "policy=step\nstep=10\nscale=0.5\n",
    "exp": "policy=exp\ngamma=0.99\n",
    "sigmoid": "policy=sigmoid\ngamma=0.5\nstep=20\n",
    "sgdr": "policy=sgdr\nsgdr_cycle=50\nsgdr_mult=3\n"
            "learning_rate_min=0.0001\n",
    "adam": "adam=1\nB1=0.8\nB2=0.99\neps=0.0001\nema_alpha=0.9998\n"
            "max_batches=1000\n",
    "bare": "",
}


@pytest.mark.parametrize("case", sorted(NET_KEYS))
def test_train_config_from_cfg_matches_the_jax_train_command(case,
                                                            tmp_path):
    """train_config_from_cfg gives the TrainConfig fields the JAX
    package's train command builds from the same cfg with no flag set
    (cli/train_helpers.py's resolution)."""
    from yolo_tpu.cli.train_helpers import (_batch_accum_from,
                                            _lr_schedule_from,
                                            _optimizer_from)

    p = tmp_path / "t.cfg"
    p.write_text(t_scaled.SCALED_CFG.replace(
        "[net]\n", "[net]\n" + NET_KEYS[case], 1))
    model_cfg = tdc.config_from_cfg(str(p))
    got = train_config_from_cfg(str(p), model_cfg)
    hp = J_TRAIN(str(p))
    args = SimpleNamespace(optimizer=None, lr_steps=None, lr_scales=None,
                           batch=None, grad_accum=None)
    with contextlib.redirect_stderr(io.StringIO()):
        want = dict(_optimizer_from(args, hp), **_lr_schedule_from(args, hp))
        want["grad_accum"] = _batch_accum_from(args, hp)
    want.update(learning_rate=hp.get("learning_rate", 1e-4),
                burn_in_steps=hp.get("burn_in", 0),
                momentum=hp.get("momentum", 0.9),
                weight_decay=hp.get("decay", 5e-4),
                ema_alpha=hp.get("ema_alpha", 0.0),
                ema_start_step=hp.get("max_batches", 0) // 2)
    for key, value in want.items():
        assert getattr(got, key) == value, key
    assert got.yolo_loss == yolo_loss_config(model_cfg)
    assert isinstance(got, TrainConfig)
