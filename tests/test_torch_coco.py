"""The port's COCO path against the JAX package on the CPU: COCO JSON
loading (data/coco.py), the 12-cell COCO evaluation (eval/coco_map.py),
the areas that build_ground_truth carries, and COCO-format JPEG scenes
through collect_detections and evaluate_coco.

coco.py and coco_map.py are numpy copies: equal results (1e-12 on the
metric cells). The detections of the two packages agree as
tests/test_torch_eval.py holds them (classes exact, scores 1e-5, pixel
boxes 1e-3) and the metric cells to 1e-4.

The evaluator cases of tests/test_coco.py run here as the cases of one
parametrised test, once against each package.
"""

import json

import numpy as np
import pytest
import torch

from tests.torch_port import to_jax_config
from yolo_tpu.data import coco as jcoco
from yolo_tpu.eval import coco_map as jcoco_map
from yolo_tpu.eval import runner as jrunner
from yolo_tpu.eval import voc_map as jvoc_map
from yolo_tpu.models import graph as jgraph
from yolo_tpu_torch.configs import (COCO_NAMES, Conv, ModelConfig, Route,
                                    Shortcut, Upsample, YoloHead)
from yolo_tpu_torch.data import coco as tcoco
from yolo_tpu_torch.data.synthetic import write_coco_scenes
from yolo_tpu_torch.eval import coco_map as tcoco_map
from yolo_tpu_torch.eval import runner as trunner
from yolo_tpu_torch.eval import voc_map as tvoc_map
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph

torch.set_num_threads(1)

CELLS = ("map", "map50", "map75", "map_small", "map_medium", "map_large",
         "ar1", "ar10", "ar", "ar_small", "ar_medium", "ar_large")
PACKAGES = {"jax": (jcoco, jcoco_map, jvoc_map),
            "port": (tcoco, tcoco_map, tvoc_map)}
CLASS_NAMES = ("cat", "dog", "bird")
HEAD = 3 * (5 + 80)
# yolov3's layer kinds at narrow widths with COCO-80 heads at /16 and /8
NARROW_COCO = ModelConfig(
    name="narrow-v3-coco",
    layers=(
        Conv(8), Conv(16, stride=2),                        # 0-1
        Conv(8, 1), Conv(16), Shortcut(-3),                 # 2-4
        Conv(32, stride=2), Conv(64, stride=2),             # 5-6
        Conv(32, 1), Conv(64), Shortcut(-3),                # 7-9
        Conv(128, stride=2), Conv(64, 1), Conv(128),        # 10-12
        Conv(HEAD, 1, bn=False, act="linear"),              # 13
        YoloHead((3, 4, 5)),                                # 14 (/16)
        Route((-4,)), Conv(32, 1), Upsample(2),             # 15-17
        Route((-1, 9)), Conv(64),                           # 18-19
        Conv(HEAD, 1, bn=False, act="linear"),              # 20
        YoloHead((0, 1, 2)),                                # 21 (/8)
    ),
    anchors=((6, 8), (12, 16), (20, 14), (28, 40), (50, 36), (70, 80)),
    class_names=COCO_NAMES, input_size=96)


def _write_coco(path, images, annotations, categories=None):
    path.write_text(json.dumps({
        "images": images, "annotations": annotations,
        # non-contiguous ids in shuffled order, one not in CLASS_NAMES
        "categories": categories or [
            {"id": 7, "name": "dog"}, {"id": 2, "name": "cat"},
            {"id": 99, "name": "zebra"}, {"id": 13, "name": "bird"}]}))


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for (gp, ga), (wp, wa) in zip(got, want):
        assert gp == wp and set(ga) == set(wa)
        for k in ga:
            np.testing.assert_array_equal(ga[k], wa[k])
            assert np.asarray(ga[k]).dtype == np.asarray(wa[k]).dtype


# --- loading -------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """COCO-format JPEG scenes: crowd regions, ellipses whose areas are
    below their boxes', objects in every area range."""
    root = tmp_path_factory.mktemp("coco")
    sizes = [(96, 128), (120, 90), (80, 80), (100, 150)]
    path = write_coco_scenes(str(root), sizes, seed=3, crowd=0.2)
    return str(root), path


def test_load_coco_and_category_ids_match_jax(scenes, tmp_path):
    root, path = scenes
    _assert_samples_equal(tcoco.load_coco(path, COCO_NAMES, root),
                          jcoco.load_coco(path, COCO_NAMES, root))
    assert tcoco.category_ids(path, COCO_NAMES) == \
        jcoco.category_ids(path, COCO_NAMES)
    with open(path) as f:
        doc = json.load(f)
    anns = doc["annotations"]
    assert any(a["iscrowd"] for a in anns)
    assert any(a["area"] != a["bbox"][2] * a["bbox"][3] for a in anns)
    # a class list that names a subset, and a missing area (box fallback)
    del anns[0]["area"]
    p = tmp_path / "subset.json"
    p.write_text(json.dumps(doc))
    subset = COCO_NAMES[::3]
    _assert_samples_equal(tcoco.load_coco(str(p), subset, root),
                          jcoco.load_coco(str(p), subset, root))
    assert tcoco.category_ids(str(p), subset) == \
        jcoco.category_ids(str(p), subset)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_load_coco_schema_and_mapping(tmp_path, pkg):
    """tests/test_coco.py's loader cases, in both packages."""
    coco = PACKAGES[pkg][0]
    p = tmp_path / "inst.json"
    _write_coco(p, images=[
        {"id": 10, "file_name": "a.jpg", "width": 200, "height": 100},
        {"id": 11, "file_name": "b.jpg", "width": 100, "height": 100},
        {"id": 12, "file_name": "e.jpg", "width": 10, "height": 10}],
        annotations=[
            {"image_id": 10, "category_id": 7, "bbox": [20, 30, 40, 20],
             "iscrowd": 0},
            {"image_id": 10, "category_id": 99, "bbox": [0, 0, 10, 10],
             "iscrowd": 0},
            {"image_id": 11, "category_id": 2, "bbox": [10, 10, 50, 80],
             "iscrowd": 1, "area": 321.5}])
    samples = coco.load_coco(str(p), CLASS_NAMES, image_root="/imgs")
    assert [s[0] for s in samples] == ["/imgs/a.jpg", "/imgs/b.jpg",
                                       "/imgs/e.jpg"]
    a, b, e = (s[1] for s in samples)
    assert a["width"] == 200 and a["height"] == 100
    assert list(a["classes"]) == [1] and list(a["difficult"]) == [0]
    np.testing.assert_allclose(a["boxes"][0], [0.2, 0.4, 0.2, 0.2],
                               rtol=1e-6)
    assert list(a["areas"]) == [800.0]           # box-area fallback
    assert list(b["classes"]) == [0] and list(b["difficult"]) == [1]
    assert list(b["areas"]) == [321.5]
    assert e["boxes"].shape == (0, 4)
    assert coco.category_ids(str(p), CLASS_NAMES) == {0: 2, 1: 7, 2: 13}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_wrong_names_tripwire(tmp_path, capsys, pkg):
    coco = PACKAGES[pkg][0]
    doc = {"images": [{"id": 1, "width": 64, "height": 64,
                       "file_name": "a.jpg"}],
           "annotations": [{"id": 1, "image_id": 1, "category_id": 5,
                            "bbox": [1, 1, 10, 10], "area": 100}],
           "categories": [{"id": 5, "name": "zebra"}]}
    p = tmp_path / "i.json"
    p.write_text(json.dumps(doc))
    coco.load_coco(str(p), ("cat", "dog"), str(tmp_path))
    assert "all 1 annotations dropped" in capsys.readouterr().err
    coco.load_coco(str(p), ("zebra",), str(tmp_path))
    assert "dropped" not in capsys.readouterr().err


# --- the areas that build_ground_truth carries --------------------------------

def _thin_object(tmp_path):
    """One image, one object: a 200x60 box (12000 px^2, 'large') whose
    segmentation area is 800 px^2 ('small')."""
    p = tmp_path / "thin.json"
    _write_coco(p, images=[{"id": 5, "file_name": "t.jpg", "width": 320,
                            "height": 240}],
                annotations=[{"image_id": 5, "category_id": 2,
                              "bbox": [10, 20, 200, 60], "area": 800.0,
                              "iscrowd": 0}])
    return str(p)


def test_build_ground_truth_keeps_coco_areas(tmp_path):
    """The port's build_ground_truth once dropped 'areas'; the COCO
    evaluator then bucketed this object as large, where pycocotools and
    the JAX package bucket it as small."""
    samples = tcoco.load_coco(_thin_object(tmp_path), CLASS_NAMES)
    got, got_ids = trunner.build_ground_truth(samples, CLASS_NAMES)
    want, want_ids = jrunner.build_ground_truth(
        jcoco.load_coco(_thin_object(tmp_path), CLASS_NAMES), CLASS_NAMES)
    assert got_ids == want_ids == {0: 5}
    assert set(got[0]) == set(want[0]) and "areas" in got[0]
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    dets = {0: [(0, 0.9, 10.0, 20.0, 210.0, 80.0)]}
    t = tcoco_map.evaluate_coco(dets, got, len(CLASS_NAMES))
    j = jcoco_map.evaluate_coco(dets, want, len(CLASS_NAMES))
    assert t["map_small"] == j["map_small"] == 1.0
    assert t["map_large"] == j["map_large"] == 0.0
    # without the areas (the fault), the same object scores as large
    no_areas = {0: {k: v for k, v in got[0].items() if k != "areas"}}
    before = tcoco_map.evaluate_coco(dets, no_areas, len(CLASS_NAMES))
    assert before["map_small"] == 0.0 and before["map_large"] == 1.0


# --- the evaluator: random inputs ----------------------------------------------

def _random_coco_inputs(seed, n_images=8, n_classes=5):
    """GT with crowd regions and areas in every range (some areas apart
    from their boxes'), and detections: jittered hits, duplicates and
    noise, more than max_dets of some classes on some images."""
    rng = np.random.default_rng(seed)
    gt, dets = {}, {}
    for i in range(n_images):
        g = int(rng.integers(0, 7))
        xy = rng.uniform(0, 400, (g, 2))
        wh = np.exp(rng.uniform(np.log(4), np.log(250), (g, 2)))
        boxes = np.concatenate([xy, xy + wh], -1)
        areas = wh.prod(-1) * np.where(rng.uniform(size=g) < 0.4,
                                       rng.uniform(0.2, 1.0, g), 1.0)
        gt[i] = {"boxes": boxes, "classes": rng.integers(0, n_classes, g),
                 "difficult": (rng.uniform(size=g) < 0.15).astype(np.int32),
                 "areas": areas}
        d = []
        for b, c in zip(boxes, gt[i]["classes"]):
            for _ in range(int(rng.integers(0, 4))):
                d.append((int(c), float(rng.uniform()),
                          *(b + rng.normal(0, 0.05 * (b[2] - b[0]) + 1, 4))))
        for _ in range(int(rng.integers(0, 15))):
            xy = rng.uniform(0, 400, 2)
            d.append((int(rng.integers(0, n_classes)), float(rng.uniform()),
                      *xy, *(xy + rng.uniform(3, 200, 2))))
        dets[i] = d
    dets[n_images] = [(0, 0.5, 1.0, 1.0, 30.0, 30.0)]   # no GT entry
    return dets, gt


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_dets", [100, 3])
def test_evaluate_coco_matches_jax(seed, max_dets):
    dets, gt = _random_coco_inputs(seed)
    got = tcoco_map.evaluate_coco(dets, gt, 5, max_dets=max_dets)
    want = jcoco_map.evaluate_coco(dets, gt, 5, max_dets=max_dets)
    assert set(got) == set(want) == set(CELLS) | {"ap"}
    for cell in CELLS:
        assert abs(got[cell] - want[cell]) <= 1e-12, cell
    assert got["ap"].keys() == want["ap"].keys()
    np.testing.assert_allclose(list(got["ap"].values()),
                               list(want["ap"].values()), rtol=0, atol=1e-12)
    assert 0.0 < got["map"] < got["map50"] <= 1.0
    # the same inputs without areas: box areas
    plain = {i: {k: v for k, v in g.items() if k != "areas"}
             for i, g in gt.items()}
    assert tcoco_map.evaluate_coco(dets, plain, 5, max_dets=max_dets) == \
        jcoco_map.evaluate_coco(dets, plain, 5, max_dets=max_dets)


# --- the evaluator: tests/test_coco.py's cases, in both packages ---------------

def _det(cls, score, x1, y1, x2, y2):
    return (cls, score, x1, y1, x2, y2)


def _gt(boxes, classes, difficult=None, **extra):
    boxes = np.asarray(boxes, np.float64)
    return {"boxes": boxes, "classes": np.asarray(classes),
            "difficult": (np.zeros(len(boxes)) if difficult is None
                          else np.asarray(difficult)), **extra}


def _scene(seed):
    rng = np.random.default_rng(seed)
    gt, dets = {}, {}
    for img in range(4):
        b = rng.uniform(0, 80, (3, 2))
        gt[img] = _gt(np.concatenate([b, b + rng.uniform(5, 30, (3, 2))], 1),
                      rng.integers(0, 2, 3))
        dets[img] = [_det(int(rng.integers(0, 2)), float(rng.uniform()),
                          *rng.uniform(0, 100, 4)) for _ in range(5)]
    return gt, dets


def case_perfect_detections(ev, _):
    gt = {0: _gt([[0, 0, 10, 10], [20, 20, 40, 50]], [0, 1])}
    dets = {0: [_det(0, 0.9, 0, 0, 10, 10), _det(1, 0.8, 20, 20, 40, 50)]}
    r = ev.evaluate_coco(dets, gt, num_classes=3)
    assert r["map"] == r["map50"] == r["map75"] == 1.0
    assert set(r["ap"]) == {0, 1}


def case_iou_ladder(ev, _):
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0])}
    r = ev.evaluate_coco({0: [_det(0, 0.9, 0, 0, 10, 8)]}, gt, 1)
    assert r["map50"] == 1.0 and r["map75"] == 1.0
    np.testing.assert_allclose(r["map"], 0.7, atol=1e-9)
    assert np.isclose((ev.COCO_IOU_THRESHOLDS <= 0.8).mean(), 0.7)


def case_crowd_not_false_positive(ev, _):
    gt = {0: _gt([[0, 0, 10, 10], [50, 50, 90, 90]], [0, 0], [0, 1])}
    dets = {0: [_det(0, 0.95, 55, 55, 70, 70), _det(0, 0.90, 0, 0, 10, 10)]}
    r = ev.evaluate_coco(dets, gt, num_classes=1)
    assert r["map"] == 1.0
    r2 = ev.evaluate_coco(dets, {0: _gt(gt[0]["boxes"], [0, 0])}, 1)
    assert r2["map"] < r["map"]


def case_duplicate_detection_is_fp(ev, _):
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0])}
    dets = {0: [_det(0, 0.9, 0, 0, 10, 10), _det(0, 0.8, 0, 0, 10, 10)]}
    assert ev.evaluate_coco(dets, gt, 1, iou_thresholds=[0.5])["map"] == 1.0
    dets_rev = {0: [_det(0, 0.9, 0, 0, 10.2, 10.2),
                    _det(0, 0.8, 0, 0, 10.2, 10.2)]}
    gt2 = {0: _gt([[0.0, 0.0, 10.0, 10.0], [30.0, 30.0, 40.0, 40.0]], [0, 0])}
    r2 = ev.evaluate_coco(dets_rev, gt2, 1, iou_thresholds=[0.5])
    assert 0.0 < r2["map"] < 1.0


def case_max_dets_cap(ev, _):
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0])}
    dets = {0: [_det(0, 0.9, 100, 100, 110, 110),
                _det(0, 0.8, 200, 200, 210, 210), _det(0, 0.1, 0, 0, 10, 10)]}
    full = ev.evaluate_coco(dets, gt, 1, iou_thresholds=[0.5])
    capped = ev.evaluate_coco(dets, gt, 1, iou_thresholds=[0.5], max_dets=2)
    assert full["map"] > 0.0 and capped["map"] == 0.0


def case_map50_close_to_voc_auc(ev, voc):
    rng = np.random.default_rng(3)
    gt, dets = {}, {}
    for img in range(6):
        boxes = rng.uniform(0, 80, (3, 2))
        boxes = np.concatenate([boxes, boxes + rng.uniform(10, 30, (3, 2))],
                               axis=1)
        gt[img] = _gt(boxes, [0, 0, 1])
        d = []
        for b, c in zip(boxes, (0, 0, 1)):
            if rng.uniform() < 0.8:
                d.append(_det(c, float(rng.uniform(0.5, 1)),
                              *(b + rng.uniform(-2, 2, 4))))
        d.append(_det(int(rng.integers(0, 2)), float(rng.uniform(0, 0.5)),
                      *rng.uniform(0, 100, 4)))
        dets[img] = d
    coco = ev.evaluate_coco(dets, gt, num_classes=2)
    v = voc.evaluate(dets, gt, num_classes=2, use_07_metric=False)
    assert abs(coco["map50"] - v["map"]) < 0.03
    assert coco["map"] <= coco["map50"]


def case_max_dets_per_image_per_class(ev, _):
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0])}
    dets = {0: [_det(1, 0.9, 50, 50, 60, 60), _det(1, 0.8, 70, 70, 80, 80),
                _det(0, 0.5, 0, 0, 10, 10)]}
    r = ev.evaluate_coco(dets, gt, 2, iou_thresholds=[0.5], max_dets=2)
    assert r["ap"][0] == 1.0
    dets2 = {0: [_det(0, 0.9, 50, 50, 60, 60), _det(0, 0.8, 70, 70, 80, 80),
                 _det(0, 0.5, 0, 0, 10, 10)]}
    r2 = ev.evaluate_coco(dets2, gt, 2, iou_thresholds=[0.5], max_dets=2)
    assert r2["ap"][0] == 0.0


def case_average_recall(ev, _):
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0])}
    r = ev.evaluate_coco({0: [_det(0, 0.9, 0, 0, 10, 8)]}, gt, 1)
    np.testing.assert_allclose(r["ar"], 0.7, atol=1e-9)
    assert ev.evaluate_coco({0: [_det(0, 0.9, 0, 0, 10, 10)]}, gt,
                            1)["ar"] == 1.0
    dets = {0: [_det(0, 0.9, 50, 50, 60, 60), _det(0, 0.8, 70, 70, 80, 80),
                _det(0, 0.1, 0, 0, 10, 10)]}
    assert ev.evaluate_coco(dets, gt, 1, max_dets=2)["ar"] == 0.0


def case_detection_order_irrelevant(ev, _):
    gt, dets = _scene(0)
    shuffled = {i: list(reversed(d)) for i, d in dets.items()}
    assert ev.evaluate_coco(dets, gt, 2) == ev.evaluate_coco(shuffled, gt, 2)


def case_image_id_relabeling_irrelevant(ev, _):
    gt, dets = _scene(1)
    remap = {0: 100, 1: 7, 2: 55, 3: 3}
    gt2 = {remap[i]: g for i, g in gt.items()}
    dets2 = {remap[i]: d for i, d in dets.items()}
    assert ev.evaluate_coco(dets, gt, 2) == ev.evaluate_coco(dets2, gt2, 2)


def case_coordinate_scaling_irrelevant(ev, _):
    gt, dets = _scene(2)
    s = 7.3
    gt2 = {i: _gt(g["boxes"] * s, g["classes"]) for i, g in gt.items()}
    dets2 = {i: [(c, sc, x1 * s, y1 * s, x2 * s, y2 * s)
                 for (c, sc, x1, y1, x2, y2) in d] for i, d in dets.items()}
    np.testing.assert_allclose(ev.evaluate_coco(dets, gt, 2)["map"],
                               ev.evaluate_coco(dets2, gt2, 2)["map"],
                               rtol=1e-12)


def case_extra_empty_images_irrelevant(ev, _):
    gt, dets = _scene(3)
    gt2 = dict(gt)
    gt2[999] = _gt(np.zeros((0, 4)), [])
    assert ev.evaluate_coco(dets, gt, 2) == ev.evaluate_coco(dets, gt2, 2)


def case_perfect_per_range(ev, _):
    for side, name in ((20, "small"), (50, "medium"), (200, "large")):
        gt = {0: _gt([[0.0, 0.0, side, side]], [0], [0])}
        r = ev.evaluate_coco({0: [(0, 0.9, 0.0, 0.0, side, side)]}, gt, 1)
        assert r[f"map_{name}"] == 1.0 and r[f"ar_{name}"] == 1.0
        for other in {"small", "medium", "large"} - {name}:
            assert r[f"map_{other}"] == 0.0


def case_out_of_range_gt_is_ignored_not_fp(ev, _):
    gt = {0: _gt([[0, 0, 20, 20], [40, 40, 240, 240]], [0, 0], [0, 0])}
    dets = {0: [(0, 0.9, 0, 0, 20, 20), (0, 0.8, 40, 40, 240, 240)]}
    r = ev.evaluate_coco(dets, gt, 1)
    assert r["map_small"] == r["map_large"] == r["map"] == 1.0


def case_unmatched_det_outside_range_ignored(ev, _):
    gt = {0: _gt([[0, 0, 20, 20]], [0], [0])}
    dets = {0: [(0, 0.9, 0, 0, 20, 20), (0, 0.95, 300, 300, 500, 500)]}
    r = ev.evaluate_coco(dets, gt, 1)
    assert r["map_small"] == 1.0 and r["map"] < 1.0


def case_ar_maxdets_ladder(ev, _):
    gt = {0: _gt([[0, 0, 50, 50], [100, 100, 150, 150]], [0, 0], [0, 0])}
    dets = {0: [(0, 0.9, 0, 0, 50, 50), (0, 0.8, 100, 100, 150, 150)]}
    r = ev.evaluate_coco(dets, gt, 1, iou_thresholds=[0.5])
    assert r["ar1"] == 0.5 and r["ar10"] == 1.0 and r["ar"] == 1.0


def case_detection_on_image_missing_from_gt_is_fp(ev, _):
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0])}
    clean = ev.evaluate_coco({0: [_det(0, 0.9, 0, 0, 10, 10)]}, gt, 1,
                             iou_thresholds=[0.5])
    extra = ev.evaluate_coco({0: [_det(0, 0.9, 0, 0, 10, 10)],
                              7: [_det(0, 0.95, 0, 0, 10, 10)]}, gt, 1,
                             iou_thresholds=[0.5])
    assert clean["map"] == 1.0 and extra["map"] < 1.0


def case_area_ranges_validated(ev, _):
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0])}
    dets = {0: [_det(0, 0.9, 0, 0, 10, 10)]}
    with pytest.raises(ValueError, match="unknown area range"):
        ev.evaluate_coco(dets, gt, 1, area_ranges=["all", "tiny"])
    with pytest.raises(ValueError, match="must include 'all'"):
        ev.evaluate_coco(dets, gt, 1, area_ranges=["small"])


def case_area_buckets_use_segmentation_areas(ev, _):
    det = [(0, 0.9, 0.0, 0.0, 200.0, 60.0)]
    base = _gt([[0.0, 0.0, 200.0, 60.0]], [0], [0])
    r = ev.evaluate_coco({0: det}, {0: dict(base, areas=np.array([800.0]))},
                         1, iou_thresholds=[0.5])
    assert r["map_small"] == pytest.approx(1.0)
    r2 = ev.evaluate_coco({0: det}, {0: base}, 1, iou_thresholds=[0.5])
    assert r2["map_large"] == pytest.approx(1.0) and r2["map_small"] == 0.0


def case_map50_75_only_for_present_thresholds(ev, _):
    det = [(0, 0.9, 0.0, 0.0, 10.0, 10.0)]
    gt = {0: _gt([[0.0, 0.0, 10.0, 10.0]], [0], [0])}
    r = ev.evaluate_coco({0: det}, gt, 1, iou_thresholds=[0.6, 0.7])
    assert "map50" not in r and "map75" not in r
    r2 = ev.evaluate_coco({0: det}, gt, 1)
    assert r2["map50"] == pytest.approx(1.0)
    assert r2["map75"] == pytest.approx(1.0)


EVALUATOR_CASES = {name[5:]: fn for name, fn in sorted(globals().items())
                   if name.startswith("case_")}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", sorted(EVALUATOR_CASES))
def test_evaluator_case(case, pkg):
    _, coco_map, voc_map = PACKAGES[pkg]
    EVALUATOR_CASES[case](coco_map, voc_map)


# --- JPEG scenes through a detector --------------------------------------------

def test_coco_jpeg_scenes_collect_and_score_match_jax(scenes):
    """A narrow yolov3 with COCO-80 heads at 96 on 4 COCO-format JPEG
    scenes: collect_detections (reference head, per-class NMS at the
    PR-curve threshold) in both packages from the same folded weights,
    then evaluate_coco on each package's ground truth. The port decodes
    with its own decoder, the JAX package with cv2."""
    root, path = scenes
    cfg = NARROW_COCO
    jcfg = to_jax_config(cfg)
    params = dw.synthetic_detector_params(cfg, 0)
    folded = tgraph.fold_params(cfg.layers, params, cfg.bn_eps)
    samples = tcoco.load_coco(path, cfg.class_names, root)
    jsamples = jcoco.load_coco(path, cfg.class_names, root)
    want = jrunner.collect_detections(jcfg, jgraph.params_to_jax(folded),
                                      jsamples, batch=4)
    got = trunner.collect_detections(cfg, folded, samples, batch=4,
                                     device="cpu")
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
    gt, _ = trunner.build_ground_truth(samples, cfg.class_names)
    jgt, _ = jrunner.build_ground_truth(jsamples, cfg.class_names)
    assert all("areas" in g for g in gt.values())
    t = tcoco_map.evaluate_coco(got, gt, cfg.num_classes)
    j = jcoco_map.evaluate_coco(want, jgt, cfg.num_classes)
    for cell in CELLS:
        assert abs(t[cell] - j[cell]) <= 1e-4, cell
