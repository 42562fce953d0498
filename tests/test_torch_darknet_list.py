"""The port's darknet-native dataset tools (yolo_tpu_torch/data/
darknet_list.py, data/anchors.py) against the JAX package's: every test
of tests/test_darknet_list.py and tests/test_anchors.py runs again with
the port's module (and the port's CLI, on the CPU) in the JAX one's
place, and the two give identical results on the same files. k-means is
numpy in both: anchors are equal for a seed."""

import numpy as np
import pytest

import tests.test_anchors as janchors
import tests.test_darknet_list as jlist
import yolo_tpu
import yolo_tpu.cli  # noqa: F401  (the attribute the tests swap)
from tests.torch_port import PortCli, jax_test_names, rerun_jax_test
from yolo_tpu.data import anchors as ja
from yolo_tpu.data import darknet_list as jdl
from yolo_tpu_torch.data import anchors as ta
from yolo_tpu_torch.data import darknet_list as tdl


@pytest.mark.parametrize("name", jax_test_names(jlist))
def test_port_passes_jax_darknet_list_test(name, tmp_path, capsys,
                                           monkeypatch):
    monkeypatch.setattr(jlist, "dl", tdl)
    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(jlist, name, {"tmp_path": tmp_path, "capsys": capsys,
                                 "monkeypatch": monkeypatch})


@pytest.mark.parametrize("name", jax_test_names(janchors))
def test_port_passes_jax_anchors_test(name, tmp_path, capsys, monkeypatch):
    for attr in ("_iou_wh", "collect_wh", "kmeans_anchors"):
        monkeypatch.setattr(janchors, attr, getattr(ta, attr))
    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(janchors, name, {"tmp_path": tmp_path, "capsys": capsys,
                                    "monkeypatch": monkeypatch})


@pytest.mark.parametrize("units", [13, (20, 12), (608, 608)])
@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_anchors_equal_jax(units, seed):
    rng = np.random.default_rng(seed + 10)
    wh = rng.uniform(0.02, 0.9, (300, 2))
    wh[:7] = 0.0   # degenerate boxes are dropped in both
    want = ja.kmeans_anchors(wh, 5, units_wh=units, seed=seed)
    got = ta.kmeans_anchors(wh, 5, units_wh=units, seed=seed)
    np.testing.assert_array_equal(got["anchors"], want["anchors"])
    assert got["avg_iou"] == want["avg_iou"]


def test_list_images_equal_jax(tmp_path, capsys):
    """The same list file, labels and images (PNG and JPEG, one with an
    EXIF rotation, one label missing, one stray class id) give the same
    samples and the same warnings."""
    from yolo_tpu_torch.data.png import encode_png
    from yolo_tpu_torch.data.synthetic import encode_jpeg

    img_dir = tmp_path / "data" / "images"
    lbl_dir = tmp_path / "data" / "labels"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        img = rng.integers(0, 256, (30 + i, 40 + 2 * i, 3), np.uint8)
        if i % 2:
            data = encode_jpeg(img, 90, orientation=6 if i == 3 else None)
            name = f"{i}.jpg"
        else:
            data, name = encode_png(img), f"{i}.png"
        (img_dir / name).write_bytes(data)
        paths.append(str(img_dir / name))
        if i != 4:
            (lbl_dir / f"{i}.txt").write_text(
                f"{i % 3} 0.5 0.5 0.2 0.3\n7 0.1 0.1 0.1 0.1\n")
    lst = tmp_path / "train.txt"
    lst.write_text("\n".join(paths) + "\n")
    names = ("a", "b", "c")
    want = jdl.list_images(str(lst), names)
    want_err = capsys.readouterr().err
    got = tdl.list_images(str(lst), names)
    assert capsys.readouterr().err == want_err
    assert len(got) == len(want) == 5
    for (wp, wa), (gp, ga) in zip(want, got):
        assert gp == wp and set(ga) == set(wa)
        for k in wa:
            np.testing.assert_array_equal(ga[k], wa[k])
    assert (got[3][1]["width"], got[3][1]["height"]) == (33, 46)
