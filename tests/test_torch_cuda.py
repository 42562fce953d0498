"""CUDA kernels of yolo_tpu_torch against their plain PyTorch versions,
on the card. Marked ``cuda``; every test skips without a CUDA device.
Run on a GPU machine (no JAX needed there):

    YOLO_TPU_TEST_BACKEND=cuda python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances:
  * NMS keep masks must be identical: the kernel computes the IoU in the
    plain version's operation order, with IEEE division and no FMA
    contraction.
  * conv and entry, fp32: 1e-5 of the output's scale (max |plain|): true
    fp32 products on both sides, summed in other orders.
  * conv and entry, bf16 output: 1 bf16 ulp of the output plus that fp32
    bound (the two fp32 sums may round to neighbouring bf16 values).
"""

import numpy as np
import pytest
import torch

from yolo_tpu_torch.configs import Conv, MaxPool, Reorg, Route, get_variant
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.ops import conv, entry
from yolo_tpu_torch.ops.cuda import conv_kernel, entry_kernel, nms_kernel
from yolo_tpu_torch.ops.nms import _geom, _suppress, _suppress_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rows(seed, g, k, n_classes, device):
    rng = np.random.default_rng(seed)
    boxes = np.stack([rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.1, 0.9, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k)),
                      rng.uniform(0.05, 0.3, (g, k))], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (g, k)), axis=1).astype(np.float32)
    classes = rng.integers(0, n_classes, (g, k)).astype(np.float32)
    return (_geom(torch.from_numpy(boxes).to(device)).contiguous(),
            torch.from_numpy(scores).to(device),
            torch.from_numpy(classes).to(device))


@pytest.mark.parametrize("g,k,n_classes", [
    (1, 128, 5), (1, 256, 5), (32, 128, 5), (32, 256, 80), (2560, 128, 1),
    (7, 100, 3), (3, 1, 1), (5, 33, 2)])
def test_suppress_kernel_matches_plain(cuda, g, k, n_classes):
    geom, scores, classes = _rows(g * 1000 + k, g, k, n_classes, cuda)
    before = nms_kernel.launches
    got = nms_kernel.suppress(geom, scores, classes, conf_threshold=0.3,
                              iou_threshold=0.45)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    want = _suppress_torch(geom, scores, classes, 0.3, 0.45)
    assert got.dtype == torch.float32 and got.device == geom.device
    assert torch.equal(got, want)


def test_router_takes_the_kernel_on_cuda(cuda):
    geom, scores, classes = _rows(1, 4, 128, 3, cuda)
    before = nms_kernel.launches
    got = _suppress(geom, scores, classes.to(torch.int32), 0.3, 0.45,
                    use_kernel=True)
    assert nms_kernel.launches == before + 1
    assert torch.equal(got, _suppress_torch(geom, scores, classes, 0.3, 0.45))


@pytest.mark.parametrize("bad", ["k", "dtype", "contiguous", "device"])
def test_suppress_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    geom, scores, classes = _rows(2, 2, 300 if bad == "k" else 64, 2, cuda)
    if bad == "dtype":
        scores = scores.double()
    elif bad == "contiguous":
        geom = geom.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "device":
        classes = classes.cpu()
    with pytest.raises(ValueError):
        nms_kernel.suppress(geom, scores, classes, conf_threshold=0.3,
                            iou_threshold=0.45)


def _bf16_ulp(x):
    """bf16 ulp (7 stored mantissa bits) at the magnitude of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _assert_within(got, want):
    """The tolerances of the module docstring; returns max |got - want|."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = 1e-5 * w.abs().max()
    if got.dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    assert bool((err <= bound).all()), float(err.max())
    return float(err.max())


def _conv_inputs(seed, b, hw, cin, co, ks, dtype, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, cin, hw, hw, generator=g).to(device, dtype)
    k = (torch.randn(co, cin, ks, ks, generator=g)
         * (2.0 / (ks * ks * cin)) ** 0.5).to(device, dtype)
    bias = (torch.randn(co, generator=g) * 0.5).to(device)
    return (x.contiguous(memory_format=torch.channels_last),
            k.contiguous(memory_format=torch.channels_last), bias)


# the (H=W, CIN, CO, ks) of YOLOv2-COCO 416's 16 convs on the kernel
COCO_SHAPES = [(52, 128, 256, 3), (52, 256, 128, 1), (26, 256, 512, 3),
               (26, 512, 256, 1), (13, 512, 1024, 3), (13, 1024, 512, 1),
               (13, 1024, 1024, 3), (13, 1280, 1024, 3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,hw,cin,co,ks,act", [
    (1, 7, 128, 128, 3, "leaky"), (3, 7, 256, 128, 1, "leaky"),
    (3, 7, 128, 256, 3, "linear"), (1, 13, 256, 256, 1, "linear"),
    (2, 9, 384, 128, 3, "leaky"), (1, 1, 128, 128, 3, "leaky"),
    # ragged M: 3 x 7 x 7 = 147 rows, 1 x 5 x 11 = 55 rows
    (3, 7, 128, 128, 3, "leaky"), (1, 5, 256, 512, 3, "linear"),
    # act="linear" at a split batch-1 shape
    (1, 13, 1024, 1024, 3, "linear"),
    # batch 1 at each YOLOv2-COCO shape (the split plans)
    *[(1, *s, "leaky") for s in COCO_SHAPES]])
def test_conv_kernel_matches_plain(cuda, b, hw, cin, co, ks, act, dtype):
    x, k, bias = _conv_inputs(b * 100 + hw, b, hw, cin, co, ks, dtype, cuda)
    before = conv_kernel.launches
    got = conv_kernel.fused_conv_bias_act(x, k, bias, act=act)
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_within(got, conv.fused_conv_bias_act(x, k, bias, act=act))


@pytest.mark.parametrize("bm,bn", sorted(conv_kernel.TILES))
@pytest.mark.parametrize("splits", [1, 5, 18])
def test_conv_kernel_takes_every_tile_and_uneven_splits(cuda, monkeypatch,
                                                        bm, bn, splits):
    """Each tile shape of the bf16 kernel, forced in place of the plan, at
    a ragged M (2 x 9 x 9 = 162 rows) and K = 18 chunks: unsplit, cut 5
    ways (3 or 4 chunks each: uneven) and 18 ways (1 chunk each)."""
    b, hw, cin, co, ks = 2, 9, 128, 256, 3
    x, k, bias = _conv_inputs(splits, b, hw, cin, co, ks, torch.bfloat16,
                              cuda)
    p = conv_kernel.Plan(bm, bn, splits, conv_kernel.workspace_bytes(
        b * hw * hw, co, splits))
    monkeypatch.setattr(conv_kernel, "plan", lambda *a, **kw: p)
    got = conv_kernel.fused_conv_bias_act(x, k, bias)
    torch.cuda.synchronize()
    _assert_within(got, conv.fused_conv_bias_act(x, k, bias))


@pytest.mark.parametrize("b,hw,cin,co,ks", [(1, 13, 1024, 1024, 3),
                                            (1, 26, 512, 256, 1),
                                            (8, 13, 1024, 512, 1),
                                            (32, 13, 1280, 1024, 3)])
def test_conv_kernel_is_deterministic(cuda, b, hw, cin, co, ks):
    """Two calls on the same inputs give the same bytes: split-K sums its
    partials in split order, without atomics."""
    x, k, bias = _conv_inputs(7, b, hw, cin, co, ks, torch.bfloat16, cuda)
    first = conv_kernel.fused_conv_bias_act(x, k, bias)
    second = conv_kernel.fused_conv_bias_act(x, k, bias)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_conv_kernel_returns_an_empty_batch_without_a_launch(cuda):
    x, k, bias = _conv_inputs(0, 0, 13, 256, 256, 3, torch.bfloat16, cuda)
    before = conv_kernel.launches
    got = conv_kernel.fused_conv_bias_act(x, k, bias)
    assert tuple(got.shape) == (0, 256, 13, 13)
    assert conv_kernel.launches == before


def test_conv_wrapper_rejects_a_plan_the_kernel_does_not_take(cuda,
                                                             monkeypatch):
    x, k, bias = _conv_inputs(0, 1, 5, 128, 128, 3, torch.bfloat16, cuda)
    before = conv_kernel.launches
    for bad, error in (
            (conv_kernel.Plan(128, 128, 2, 0), ValueError),  # no workspace
            (conv_kernel.Plan(128, 256, 1, 0), RuntimeError),  # BN > CO
            (conv_kernel.Plan(32, 128, 1, 0), RuntimeError),  # no such tile
            (conv_kernel.Plan(64, 128, 19, conv_kernel.workspace_bytes(
                25, 128, 19)), RuntimeError)):  # more splits than chunks
        monkeypatch.setattr(conv_kernel, "plan", lambda *a, **kw: bad)
        with pytest.raises(error, match="plan|workspace"):
            conv_kernel.fused_conv_bias_act(x, k, bias)
    assert conv_kernel.launches == before


@pytest.mark.parametrize("bad", ["dtype", "device", "contiguous", "cin",
                                 "ks", "kernel-dtype"])
def test_conv_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    cin = 64 if bad == "cin" else 128
    ks = 5 if bad == "ks" else 3
    x, k, bias = _conv_inputs(0, 1, 5, cin, 128, ks, torch.bfloat16, cuda)
    if bad == "dtype":
        x, k = x.half(), k.half()
    elif bad == "device":
        bias = bias.cpu()
    elif bad == "contiguous":
        x = x.contiguous()  # NCHW bytes
    elif bad == "kernel-dtype":
        k = k.float()
    before = conv_kernel.launches
    with pytest.raises(ValueError):
        conv_kernel.fused_conv_bias_act(x, k, bias)
    assert conv_kernel.launches == before


def _entry_inputs(seed, b, h, w, cout, device):
    g = torch.Generator().manual_seed(seed)
    xpad = torch.nn.functional.pad(torch.rand(b, h, w, 3, generator=g),
                                   (0, 0, 1, 1, 1, 1))
    k = torch.randn(cout, 3, 3, 3, generator=g) * 0.3
    bias = torch.randn(cout, generator=g) * 0.1
    return xpad.to(device), k.to(device), bias.to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,w,cout", [(1, 8, 8, 16), (3, 14, 22, 32),
                                        (1, 2, 2, 32), (2, 96, 96, 48)])
def test_entry_kernel_matches_plain(cuda, b, h, w, cout, dtype):
    xpad, k, bias = _entry_inputs(b * 7 + h, b, h, w, cout, cuda)
    before = entry_kernel.launches
    got = entry_kernel.fused_entry(xpad, k, bias, out_dtype=dtype)
    torch.cuda.synchronize()
    assert entry_kernel.launches == before + 1
    assert tuple(got.shape) == (b, cout, h // 2, w // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_within(got, entry.fused_entry(xpad, k, bias, out_dtype=dtype))


@pytest.mark.parametrize("bad", ["odd", "cout", "dtype", "device",
                                 "out-dtype"])
def test_entry_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    xpad, k, bias = _entry_inputs(0, 1, 7 if bad == "odd" else 8, 8,
                                  24 if bad == "cout" else 16, cuda)
    out_dtype = torch.float16 if bad == "out-dtype" else torch.bfloat16
    if bad == "dtype":
        xpad = xpad.half()
    elif bad == "device":
        k = k.cpu()
    before = entry_kernel.launches
    with pytest.raises(ValueError):
        entry_kernel.fused_entry(xpad, k, bias, out_dtype=out_dtype)
    assert entry_kernel.launches == before


def _narrow_layers():
    """tests/test_torch_conv.py's narrow yolov2: 6 convs on the kernel."""
    return (Conv(32), MaxPool(), Conv(128), Conv(128), Conv(128, 1),
            MaxPool(), Conv(256), Conv(128, 1, bn=False, act="linear"),
            Route((-4,)), Conv(128, 1), Reorg(2), Route((-1, -4)),
            Conv(256), Conv(16, 1, bn=False, act="linear"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_darknet_cuda_route_launches_the_kernel_per_eligible_conv(cuda,
                                                                  dtype):
    """Logits of the kernel route against the plain route: fp32 rtol 1e-4
    / atol 1e-4 * scale, bf16 2 bf16 ulps of the logits' scale (the
    whole-net bounds of tests/test_torch_graph.py)."""
    layers = _narrow_layers()
    rng = np.random.default_rng(3)
    params = tgraph.fold_params(
        layers, dw.random_params(layers, rng, scale=0.1), 1e-5)
    net = tgraph.Darknet(layers, params, device=cuda, dtype=dtype)
    x = torch.from_numpy(rng.uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)).to(cuda)
    want = net(x)
    before = conv_kernel.launches
    got = net(x, conv_impl="cuda")
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + sum(net.kernel_eligible) == \
        before + 6
    scale = float(want.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert float((got - want).abs().max()) <= \
            2 * float(_bf16_ulp(torch.tensor(scale)))


def test_detector_routes_launch_their_kernels(cuda):
    """tiny-voc at 96 through make_detector(entry="fused") and
    detect_raw(conv_impl="cuda"): one entry launch, and one conv launch
    per eligible conv, per call."""
    from yolo_tpu_torch.models.predict import detect_raw, make_detector

    cfg = get_variant("tiny-voc", input_size=96)
    params = tgraph.fold_params(
        cfg.layers, dw.synthetic_detector_params(cfg, 0), cfg.bn_eps)
    net = tgraph.Darknet(cfg.layers, params, device=cuda,
                         dtype=torch.bfloat16)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 120, 160, 3), dtype=np.uint8)).to(cuda)
    default = detect_raw(cfg, net, imgs)
    e0, c0 = entry_kernel.launches, conv_kernel.launches
    fused = make_detector(cfg, entry="fused")(net, imgs)
    torch.cuda.synchronize()
    assert (entry_kernel.launches, conv_kernel.launches) == (e0 + 1, c0)
    routed = detect_raw(cfg, net, imgs, conv_impl="cuda")
    torch.cuda.synchronize()
    assert entry_kernel.launches == e0 + 1
    assert conv_kernel.launches == c0 + sum(net.kernel_eligible) == c0 + 4
    for out in (fused, routed):
        assert out["boxes"].shape == default["boxes"].shape
        assert bool(torch.isfinite(out["boxes"]).all())
