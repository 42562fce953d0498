"""The fused entry route of the port (yolo_tpu_torch/ops/entry.py and
detect_raw(entry="fused")) against the JAX package's
(yolo_tpu/ops/pallas/entry_kernel.py, run in interpret mode on the CPU as
its own tests run it). On a CPU tensor the CUDA wrapper takes the plain
version, so these tests hold the plain version and the route;
tests/test_torch_cuda.py holds the kernel against the plain version on
the card. YOLOv2-COCO at 160 is in tests/test_torch_entry_coco.py (its
interpret-mode compiles take minutes; separate files run on separate
workers).

The JAX kernel's interpret mode takes about a minute per call at
96x96 on the CPU, so the kernel test runs at 32x32 and 32x48; the
detect_raw test runs tiny-voc's entry at 96.

Tolerances:
  * letterbox: the same interpolation sums in another order: fp32 rtol
    1e-5 / atol 1e-6 (tests/test_entry_kernel.py's bound). With a bf16
    row pass, a row sum can round to the neighbouring bf16 value: at
    most one bf16 ulp of 1.0 (2^-8) where that happens, >= 99.9% of the
    values within the fp32 bound.
  * fused entry: fp32 rtol 1e-5 / atol 1e-5 (tests/test_entry_kernel.py);
    bf16 output: 1 bf16 ulp of the output plus 1e-5 of its scale (the
    fp32 sums' noise before rounding).
  * detect_raw: see tests/torch_port.py::check_fused_entry_route.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port import check_fused_entry_route
from yolo_tpu.configs import specs as jspecs
from yolo_tpu.ops.pallas import entry_kernel as ek
from yolo_tpu_torch.configs import Conv, MaxPool, Route, get_variant
from yolo_tpu_torch.configs.specs import ModelConfig
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.models import predict as tpredict
from yolo_tpu_torch.ops import entry
from yolo_tpu_torch.ops.cuda import entry_kernel

torch.set_num_threads(1)

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(60, 80), (80, 60), (64, 64)])
def test_letterbox_matches_jax_planes(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(4).integers(0, 256, (2, *shape, 3),
                                          dtype=np.uint8)
    want = np.asarray(ek.letterbox_planes(jnp.asarray(x), 64,
                                          interp_dtype=jdt))
    got = entry.letterbox_padded(torch.from_numpy(x), 64, interp_dtype=tdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 66, 66, 3)
    assert (got[:, 0] == 0).all() and (got[:, -1] == 0).all()
    assert (got[:, :, 0] == 0).all() and (got[:, :, -1] == 0).all()
    planes = np.asarray(ek.build_planes(jnp.asarray(got[:, 1:-1, 1:-1]
                                                    .numpy())))
    assert planes.shape == want.shape
    close = np.isclose(planes, want, rtol=1e-5, atol=1e-6)
    if tdt == torch.float32:
        assert close.all()
    else:
        assert close.mean() >= 0.999
        assert np.abs(planes - want).max() <= 2.0 ** -8


@pytest.mark.parametrize("shape,cout,dtype", [((32, 32), 16, "fp32"),
                                              ((32, 32), 16, "bf16"),
                                              ((32, 48), 32, "fp32")])
def test_plain_fused_entry_matches_jax_kernel(shape, cout, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *shape, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    want = np.asarray(ek.fused_entry(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), out_dtype=jdt,
                                     interpret=True).astype(jnp.float32))
    xpad = torch.from_numpy(np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))))
    kernel = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = entry.fused_entry(xpad, kernel, torch.from_numpy(b), out_dtype=tdt)
    assert got.dtype == tdt and got.is_contiguous(
        memory_format=torch.channels_last)
    got = got.float().permute(0, 2, 1, 3).numpy()  # -> JAX's NHCW
    assert got.shape == want.shape == (2, shape[0] // 2, cout,
                                       shape[1] // 2)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= ulp + 1e-5 * np.abs(want).max()).all()
    # the CUDA wrapper takes the plain version on the CPU, and counts no
    # launch there
    before = entry_kernel.launches
    again = entry_kernel.fused_entry(xpad, kernel, torch.from_numpy(b),
                                     out_dtype=tdt)
    assert entry_kernel.launches == before
    assert np.array_equal(again.float().permute(0, 2, 1, 3).numpy(), got)


def _first(layer):
    return (layer,) + get_variant("tiny-voc").layers[1:]


@pytest.mark.parametrize("layers", [
    get_variant("tiny-voc").layers, get_variant("coco").layers,
    get_variant("coco").layers[1:], _first(Conv(16, stride=2)),
    _first(Conv(16, act="linear")), _first(Conv(16, size=1)),
    (Conv(16), MaxPool(2, 1), Conv(8))],
    ids=["tiny-voc", "coco", "coco-from-1", "stride-2", "linear", "1x1",
         "pool-stride-1"])
def test_entry_eligible_matches_jax(layers):
    jlayers = tuple(getattr(jspecs, type(l).__name__)(
        **dataclasses.asdict(l)) for l in layers)
    assert entry.eligible(layers) == ek.eligible(jlayers)


def _images(seed, b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, 120, 160, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_detect_raw_fused_entry_matches_jax_tiny_voc(tmp_path, dtype):
    check_fused_entry_route(tmp_path, "tiny-voc", 96, dtype,
                            conf=0.3 if dtype == "fp32" else 0.2)


class _RectConfig(ModelConfig):
    """A net whose input is not square; the port's configs are square
    only, so the check of the route is reached through this stand-in."""

    @property
    def input_hw(self):
        return (self.input_size, self.input_size + 32)


def _raising_case(case):
    kw = {}
    cfg = get_variant("tiny-voc", input_size=64)
    if case == "stretch":
        kw["resize"] = "stretch"
    elif case == "entry-1x1":
        cfg = dataclasses.replace(cfg, layers=_first(Conv(16, size=1)))
    elif case == "route-into-entry":
        cfg = dataclasses.replace(cfg, layers=(
            Conv(16), MaxPool(), Conv(16), Route((-2,)),
            Conv(8, 1, bn=False, act="linear")))
    elif case == "rectangular":
        cfg = _RectConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    elif case == "above-416":
        cfg = get_variant("tiny-voc", input_size=448)
    elif case == "conv-impl-cuda":
        kw["conv_impl"] = "cuda"
    return cfg, kw


@pytest.mark.parametrize("case,match", [
    ("stretch", "letterbox only"), ("entry-1x1", "conv3x3"),
    ("route-into-entry", "conv3x3"), ("rectangular", "square"),
    ("above-416", "416"), ("conv-impl-cuda", "conv_impl")])
def test_fused_entry_raises_where_the_reference_does(case, match):
    cfg, kw = _raising_case(case)
    params = tgraph.fold_params(
        cfg.layers, dw.random_params(cfg.layers, np.random.default_rng(0)),
        cfg.bn_eps)
    net = tgraph.Darknet(cfg.layers, params, device="cpu")
    with pytest.raises(ValueError, match=match):
        tpredict.detect_raw(cfg, net, torch.from_numpy(_images(0, 1)),
                            entry="fused", **kw)
