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
  * the s8 conv kernel: the same bytes as its plain block for leaky,
    linear, relu and ramp (exact int32 sums, the same fp32 epilogue);
    mish, logistic and swish within 1 int8 code, 1e-6 relative in fp32
    and 1 bf16 ulp (expf / log1pf / tanhf against PyTorch's).
"""

import dataclasses

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


def _edge_rows(case, device):
    """(geom, scores, classes) of one edge case of the greedy pass: rows
    of K candidates from _rows, scores sorted desc, then bent so that the
    stop (the first score below conf 0.3) falls where the case says."""
    g, k = {"k1": (3, 1), "k33": (4, 33), "k100": (5, 100),
            "k256": (6, 256), "g2560": (2560, 128)}.get(case, (8, 128))
    geom, scores, classes = _rows(len(case) * 31 + k, g, k, 2, device)
    if case == "all_below":
        scores = scores * 0.29  # every score below conf: stop at 0
    elif case == "first_few":
        scores[:, 3:] = scores[:, 3:] * 0.1  # stop at 3
        scores[:, :3] = torch.tensor([0.95, 0.9, 0.85], device=device)
    elif case == "nan_first":
        # torch.topk ranks NaN first: they stop nothing and suppress
        # nothing, and the boxes at or above conf after them still do
        scores[:, :5] = float("nan")
        scores[:, 5:40] = torch.linspace(0.99, 0.5, 35, device=device)
        scores[:, 40:] = scores[:, 40:] * 0.5  # still sorted after 0.5
    elif case == "nan_boxes":
        geom = geom.clone()
        geom[:, 0, ::7] = float("nan")  # x1
        geom[:, 4, 3::11] = float("nan")  # area
        geom[:, 3, 5::13] = float("inf")  # y2
    return geom.contiguous(), scores.contiguous(), classes


@pytest.mark.parametrize("case", ["all_below", "first_few", "nan_first",
                                  "nan_boxes", "k1", "k33", "k100", "k256",
                                  "g2560"])
def test_suppress_kernel_edge_cases(cuda, case):
    """Identical keep masks where the greedy pass stops early (or at
    once), behind NaN scores, on NaN boxes, at ragged K and at G = 2560
    (the per-class grid of batch 32)."""
    geom, scores, classes = _edge_rows(case, cuda)
    got = nms_kernel.suppress(geom, scores, classes, conf_threshold=0.3,
                              iou_threshold=0.45)
    torch.cuda.synchronize()
    want = _suppress_torch(geom, scores, classes, 0.3, 0.45)
    assert torch.equal(got, want)
    kept = int(want.sum())
    if case == "all_below":
        assert kept == 0
    elif case == "first_few":
        assert 0 < kept <= 3 * scores.shape[0]
    elif case == "nan_first":  # the boxes after the NaNs still suppress
        assert 0 < kept < int((scores >= 0.3).sum())


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


@pytest.mark.parametrize("dtype,bm,bn", [
    *[(torch.bfloat16, *t) for t in sorted(conv_kernel.TILES)],
    *[(torch.float32, *t) for t in sorted(conv_kernel.F32_TILES)]],
    ids=lambda v: {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(v, v))
@pytest.mark.parametrize("splits", [1, 5, 18])
def test_conv_kernel_takes_every_tile_and_uneven_splits(cuda, monkeypatch,
                                                        dtype, bm, bn,
                                                        splits):
    """Each tile shape of each body, forced in place of the plan, at a
    ragged M (2 x 9 x 9 = 162 rows) and K of 18 bf16 or 36 fp32 chunks:
    unsplit, cut 5 ways (uneven) and 18 ways."""
    b, hw, cin, co, ks = 2, 9, 128, 256, 3
    x, k, bias = _conv_inputs(splits, b, hw, cin, co, ks, dtype, cuda)
    p = conv_kernel.Plan(bm, bn, splits, conv_kernel.workspace_bytes(
        b * hw * hw, co, splits))
    monkeypatch.setattr(conv_kernel, "plan", lambda *a, **kw: p)
    got = conv_kernel.fused_conv_bias_act(x, k, bias)
    torch.cuda.synchronize()
    _assert_within(got, conv.fused_conv_bias_act(x, k, bias))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,hw,cin,co,ks", [(1, 13, 1024, 1024, 3),
                                            (1, 26, 512, 256, 1),
                                            (8, 13, 1024, 512, 1),
                                            (32, 13, 1280, 1024, 3)])
def test_conv_kernel_is_deterministic(cuda, b, hw, cin, co, ks, dtype):
    """Two calls on the same inputs give the same bytes: split-K sums its
    partials in split order, without atomics."""
    x, k, bias = _conv_inputs(7, b, hw, cin, co, ks, dtype, cuda)
    first = conv_kernel.fused_conv_bias_act(x, k, bias)
    second = conv_kernel.fused_conv_bias_act(x, k, bias)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(first.view(bits), second.view(bits))


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
    # fp32: 36 chunks of 32, and only its own two tiles
    x, k = x.float(), k.float()
    for bad in (conv_kernel.Plan(192, 256, 1, 0),  # a bf16-only tile
                conv_kernel.Plan(64, 128, 37, conv_kernel.workspace_bytes(
                    25, 128, 37))):  # more splits than chunks
        monkeypatch.setattr(conv_kernel, "plan", lambda *a, **kw: bad)
        with pytest.raises(RuntimeError, match="plan"):
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


@pytest.mark.parametrize("batch", [1, 16, 32])
def test_suppress_kernel_at_the_eval_grid(cuda, batch):
    """The per-class grid of collect_detections / quick_map: G = B * 20
    rows of K = 128 candidates, one class per row, at conf 0.005, where
    most of a row clears the threshold. Keep masks identical, through
    the router nms_batch(impl="cuda") takes."""
    rng = np.random.default_rng(batch)
    g, k = batch * 20, 128
    geom, _, _ = _rows(batch, g, k, 1, cuda)
    # sigmoid(obj) * softmax(class)-like scores: many small, a few large
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (g, k)) ** 4,
                                       axis=1).astype(np.float32)).to(cuda)
    classes = torch.from_numpy(np.repeat(
        np.arange(g) % 20, k).reshape(g, k).astype(np.int32)).to(cuda)
    before = nms_kernel.launches
    got = _suppress(geom, scores, classes, 0.005, 0.45, use_kernel=True)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    want = _suppress_torch(geom, scores, classes.float(), 0.005, 0.45)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int((scores >= 0.005).sum())


def _tiny_train_cfg():
    from yolo_tpu_torch.configs import ModelConfig

    return ModelConfig(
        name="tiny-train", input_size=64, class_names=("a", "b", "c"),
        anchors=((1.0, 1.5), (2.5, 2.0)),
        layers=(Conv(8), MaxPool(), Conv(16), MaxPool(), Conv(16),
                MaxPool(), Conv(32), MaxPool(), Conv(32), MaxPool(),
                Conv(32), Route((-3,)), Conv(8, 1), Reorg(2),
                Route((-1, -4)), Conv(32),
                Conv(2 * 8, 1, bn=False, act="linear")))


def test_train_step_on_cuda_matches_cpu(cuda):
    """One fp32 SGD step (momentum, kernel-only decay) from the same
    state on the same batch: loss parts to a relative 1e-4; each param
    and BN-statistic update within 1e-3 of its tensor's largest update
    (cuDNN and oneDNN sum the convs in other orders)."""
    from yolo_tpu_torch.data.targets import encode_batch
    from yolo_tpu_torch.train import loop

    cfg = _tiny_train_cfg()
    rng = np.random.default_rng(7)
    params = dw.synthetic_detector_params(cfg, 7)
    boxes = [np.array([[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.2]],
                      np.float32)] * 4
    batch = encode_batch(boxes, [np.array([0, 2])] * 4, grid=2,
                         anchors=cfg.anchors, num_classes=3)
    batch["images"] = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    tcfg = loop.TrainConfig(learning_rate=1e-3, momentum=0.9,
                            weight_decay=5e-4)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        state = loop.init_state(cfg, params, tcfg, device=dev)
        m = loop.train_step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in batch.items()},
                            mcfg=cfg, tcfg=tcfg)
        out[dev.type] = ({k: float(v) for k, v in m.items()},
                         state.net.to_numpy())
    (m_gpu, p_gpu), (m_cpu, p_cpu) = out["cuda"], out["cpu"]
    for k in m_cpu:
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=1e-4)
    for p0, pa, pb in zip(params, p_gpu, p_cpu, strict=True):
        for key in p0:
            da = pa[key].astype(np.float64) - p0[key]
            db = pb[key].astype(np.float64) - p0[key]
            assert np.abs(da - db).max() <= 1e-3 * np.abs(db).max(), key


def test_prefetcher_delivers_on_the_card_in_order(cuda):
    """Batches arrive on the card, in order, equal to the host arrays,
    usable at once on the consumer's stream; metadata stays on the
    host."""
    from yolo_tpu_torch.data.pipeline import DevicePrefetcher

    host = [{"images": np.full((4, 32, 32, 3), i, np.float32),
             "tcls": np.full((4, 2), i, np.int32), "paths": [f"{i}.png"]}
            for i in range(9)]
    with DevicePrefetcher(iter(host), depth=3) as staged:
        got = [(b["images"].sum().item(), b["tcls"].device.type,
                b["images"].device.type, b["paths"]) for b in staged]
    assert [g[0] for g in got] == [float(i * 4 * 32 * 32 * 3)
                                   for i in range(9)]
    assert all(g[1] == g[2] == "cuda" for g in got)
    assert [g[3] for g in got] == [[f"{i}.png"] for i in range(9)]


@pytest.mark.parametrize("hw,cin,co,ks", [
    (76, 128, 256, 3), (19, 2048, 512, 1), (26, 768, 256, 1),
    (52, 384, 128, 1), (13, 512, 512, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 2])
def test_conv_kernel_matches_plain_at_yolo_shapes(cuda, b, hw, cin, co, ks,
                                                  dtype):
    """Shapes of the yolov3/v4 family: a 76x76 grid, CIN 2048 at CO 512
    (split-K at batch 1), CO 128 (no 256-wide tile), the route concats'
    CIN 768 and 384; a non-contiguous input (a grouped route's channel
    slice) is copied to channels_last by the route."""
    gen = torch.Generator(device=cuda).manual_seed(hw + cin)
    x = torch.randn(b, 2 * cin, hw, hw, generator=gen, device=cuda).to(
        dtype).contiguous(memory_format=torch.channels_last)[:, cin:]
    k = (torch.randn(co, cin, ks, ks, generator=gen, device=cuda)
         * (2.0 / (ks * ks * cin)) ** 0.5).to(dtype).contiguous(
             memory_format=torch.channels_last)
    bias = torch.randn(co, generator=gen, device=cuda) * 0.5
    with pytest.raises(ValueError):
        conv_kernel.fused_conv_bias_act(x, k, bias)   # not contiguous
    x = x.contiguous(memory_format=torch.channels_last)
    got = conv_kernel.fused_conv_bias_act(x, k, bias, act="linear")
    want = conv.fused_conv_bias_act(x, k, bias, act="linear")
    g, w = got.float(), want.float()
    tol = 1e-5 * w.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(torch.maximum(g.abs(), w.abs()))
    assert bool(((g - w).abs() <= tol).all())
    with pytest.raises(ValueError, match="act"):
        conv_kernel.fused_conv_bias_act(x, k, bias, act="mish")


def test_yolo_routes_launch_their_kernels(cuda):
    """yolov4-tiny at 160 through detect_raw(conv_impl="cuda"): one conv
    launch per kernel-eligible conv (11, as at 416) and one NMS launch a
    call; the fused entry raises."""
    from yolo_tpu_torch.models.predict import detect_raw

    cfg = get_variant("yolov4-tiny", input_size=160)
    params = tgraph.fold_params(
        cfg.layers, dw.synthetic_detector_params(cfg, 0), cfg.bn_eps)
    net = tgraph.Darknet(cfg.layers, params, device=cuda,
                         dtype=torch.bfloat16)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 120, 160, 3), dtype=np.uint8)).to(cuda)
    default = detect_raw(cfg, net, imgs)
    c0, n0 = conv_kernel.launches, nms_kernel.launches
    routed = detect_raw(cfg, net, imgs, conv_impl="cuda")
    torch.cuda.synchronize()
    assert conv_kernel.launches - c0 == sum(net.kernel_eligible) == 11
    assert nms_kernel.launches - n0 == 1
    assert routed["boxes"].shape == default["boxes"].shape
    assert bool(torch.isfinite(routed["boxes"]).all())
    with pytest.raises(ValueError, match="entry"):
        detect_raw(cfg, net, imgs, entry="fused")


# the (H, W, CIN, CO, ks) of the conv kernel's convs in yolov4's topology
# at a rectangular [net] width=640 height=384 (grids 80x48, 40x24, 20x12)
RECT_SHAPES = [(12, 20, 512, 256, 1), (12, 20, 512, 1024, 3),
               (12, 20, 1024, 512, 1), (12, 20, 2048, 512, 1),
               (24, 40, 256, 128, 1), (24, 40, 256, 512, 3),
               (24, 40, 512, 256, 1), (48, 80, 128, 256, 3),
               (48, 80, 256, 128, 1)]


@pytest.mark.parametrize("h,w,cin,co,ks", RECT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b", [1, 32])
def test_conv_kernel_matches_plain_at_rect_shapes(cuda, b, h, w, cin, co,
                                                  ks, dtype):
    """H != W: the TMA im2col map's halo, the M tiling over B*H*W and
    the split-K plan at the rectangular grids of a 640x384 yolov4."""
    gen = torch.Generator(device=cuda).manual_seed(h * w + cin)
    x = torch.randn(b, cin, h, w, generator=gen, device=cuda).to(
        dtype).contiguous(memory_format=torch.channels_last)
    k = (torch.randn(co, cin, ks, ks, generator=gen, device=cuda)
         * (2.0 / (ks * ks * cin)) ** 0.5).to(dtype).contiguous(
             memory_format=torch.channels_last)
    bias = torch.randn(co, generator=gen, device=cuda) * 0.5
    before = conv_kernel.launches
    got = conv_kernel.fused_conv_bias_act(x, k, bias, act="leaky")
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + 1
    assert tuple(got.shape) == (b, co, h, w)
    _assert_within(got, conv.fused_conv_bias_act(x, k, bias, act="leaky"))


def _custom_head_net(cuda, kind):
    """A small rectangular net ending in a new_coords or a Gaussian head,
    seeded detector weights."""
    from yolo_tpu_torch.configs import ModelConfig, YoloHead

    c = 4
    head = (Conv(2 * (5 + c), 1, bn=False, act="logistic")
            if kind == "new_coords"
            else Conv(2 * (9 + c), 1, bn=False, act="linear"))
    cfg = ModelConfig(
        name=kind, layers=(Conv(16, stride=2), Conv(32, stride=2),
                           Conv(32, stride=2), head,
                           YoloHead((0, 1), scale_xy=2.0,
                                    new_coords=kind == "new_coords",
                                    gaussian=kind == "gaussian")),
        anchors=((10, 14), (23, 27)), class_names=tuple("abcd"),
        input_size=96, input_width=160)
    params = tgraph.fold_params(cfg.layers,
                                dw.synthetic_detector_params(cfg, 0))
    return cfg, params


@pytest.mark.parametrize("kind", ["new_coords", "gaussian"])
def test_custom_heads_launch_the_nms_kernel_once(cuda, kind):
    """A new_coords or a Gaussian head on the card: one NMS launch a
    forward, and the same detections as the CPU at box level (every
    detection at conf + 0.05 has a same-class partner at IoU >= 0.5)."""
    from tests.torch_port import matched
    from yolo_tpu_torch.models.predict import detect_raw

    cfg, params = _custom_head_net(cuda, kind)
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 120, 200, 3), dtype=np.uint8))
    net = tgraph.Darknet(cfg.layers, params, device=cuda)
    before = nms_kernel.launches
    got = detect_raw(cfg, net, imgs.to(cuda))
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    want = detect_raw(cfg, tgraph.Darknet(cfg.layers, params, device="cpu"),
                      imgs)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.numpy() for k, v in want.items()}
    for a, b in ((want, got), (got, want)):
        hit, total = matched(a, b, cfg.conf_threshold)
        assert total >= 1 and hit == total


@pytest.mark.parametrize("variant", ["yolov3-tiny", "yolov4-tiny"])
def test_load_cfg_on_the_card_equals_the_builtin_variant(cuda, tmp_path,
                                                        variant):
    """load(weights, cfg=cfg_to_string(variant)) on the card gives the
    built-in variant's detections bit for bit, on both routes."""
    import yolo_tpu_torch
    from yolo_tpu_torch.configs.darknet_cfg import cfg_to_string
    from yolo_tpu_torch.models.predict import detect_raw

    cfg = get_variant(variant, input_size=160)
    wpath = str(tmp_path / "w.weights")
    dw.save(wpath, cfg.layers, dw.synthetic_detector_params(cfg, 0))
    path = tmp_path / "v.cfg"
    path.write_text(cfg_to_string(cfg))
    names = tmp_path / "v.names"
    names.write_text("\n".join(cfg.class_names) + "\n")
    imgs = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 120, 160, 3), dtype=np.uint8)).to(cuda)
    for precision in ("bf16", "fp32"):
        built = yolo_tpu_torch.load(wpath, variant, input_size=160,
                                    precision=precision)
        parsed = yolo_tpu_torch.load(wpath, cfg=str(path), names=str(names),
                                     precision=precision)
        assert parsed.params.device.type == "cuda"
        for route in ("torch", "cuda"):
            a = detect_raw(cfg, built.params, imgs, conv_impl=route)
            b = detect_raw(parsed.cfg, parsed.params, imgs, conv_impl=route)
            assert all(torch.equal(a[k], b[k]) for k in a), (precision, route)


# --- the tree head, the 9k eval grid, YOLO9000 and yolov1 shapes -------------

def _tree(tmp_path, n):
    from yolo_tpu_torch.configs.tree import parse_tree
    from yolo_tpu_torch.data.synthetic import write_tree

    return parse_tree(write_tree(str(tmp_path / f"{n}.tree"), n, seed=0))


@pytest.mark.parametrize("mode", ["traversal", "map"])
def test_tree_head_grid_launches_the_kernel_once(cuda, tmp_path, mode,
                                                 monkeypatch):
    """The fused YOLO9000 head (ops/head.py::detect_head_tree) on the
    card: one NMS launch on its (B, 5, K) grid, whose keep mask equals
    the plain suppression's on the same grid. (Two whole head calls are
    not compared: the tree math's CUDA reductions need not repeat to
    the bit.)"""
    from yolo_tpu_torch.data.synthetic import write_map
    from yolo_tpu_torch.ops.head import detect_head_tree

    tree = _tree(tmp_path, 300)
    tree_map = (tuple(write_map(str(tmp_path / "m.map"), tree, 20, seed=0))
                if mode == "map" else None)
    anchors = ((1.0, 1.5), (3.0, 4.0), (9.0, 9.5))
    logits = torch.from_numpy(np.random.default_rng(5).normal(
        0, 2, (4, 17, 17, 3 * (5 + tree.n_nodes))).astype(np.float32)
                              ).to(cuda)
    kw = dict(conf_threshold=0.3 if mode == "traversal" else 0.05,
              iou_threshold=0.45, tree_map=tree_map, pre_top_k=256)
    grids, suppress = [], nms_kernel.suppress

    def capture(geom, scores, classes, **skw):
        grids.append((geom.clone(), scores.clone(), classes.clone(), skw))
        return suppress(geom, scores, classes, **skw)

    monkeypatch.setattr(nms_kernel, "suppress", capture)
    before = nms_kernel.launches
    out = detect_head_tree(logits, anchors, tree, use_kernel=True, **kw)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1 and len(grids) == 1
    geom, scores, classes, skw = grids[0]
    assert tuple(geom.shape) == (4, 5, 256)
    got = suppress(geom, scores, classes, **skw)
    assert torch.equal(got, _suppress_torch(
        geom, scores, classes, skw["conf_threshold"],
        skw["iou_threshold"]))
    assert int(out["valid"].sum()) > 0


def test_9k_eval_grid_in_one_launch_and_in_class_chunks(cuda, tmp_path,
                                                        monkeypatch):
    """The exact eval's per-class grid at 9418 classes, (B * 9418, 5,
    128): one kernel launch while its geometry fits ops/nms.py's
    _CHUNK_ELEMS, one a class chunk under a smaller budget; the keep
    masks, hence the detections, equal the plain path's either way."""
    from yolo_tpu_torch.ops import nms as nms_mod

    b, n, c = 2, 845, 9418
    rng = np.random.default_rng(9)
    boxes = torch.from_numpy(np.stack([
        rng.uniform(0.1, 0.9, (b, n)), rng.uniform(0.1, 0.9, (b, n)),
        rng.uniform(0.05, 0.3, (b, n)), rng.uniform(0.05, 0.3, (b, n))],
        -1).astype(np.float32)).to(cuda)
    # one-hot traversal-like scores: each box scores at one node only
    scores = torch.zeros(b, n, c, device=cuda)
    node = torch.from_numpy(rng.integers(0, c, (b, n))).to(cuda)
    scores.scatter_(2, node[..., None], torch.from_numpy(rng.uniform(
        0, 1, (b, n, 1)).astype(np.float32)).to(cuda))
    kw = dict(conf_threshold=0.005, iou_threshold=0.45, top_k=128)
    want = nms_mod.nms_batch(boxes, scores, impl="torch", **kw)
    before = nms_kernel.launches
    whole = nms_mod.nms_batch(boxes, scores, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    chunk = 2048
    monkeypatch.setattr(nms_mod, "_CHUNK_ELEMS", 5 * 128 * b * chunk)
    before = nms_kernel.launches
    chunked = nms_mod.nms_batch(boxes, scores, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + -(-c // chunk)
    for k in want:
        assert torch.equal(whole[k], want[k]) and \
            torch.equal(chunked[k], want[k]), k
    assert int(want["valid"].sum()) > 0


# YOLO9000's six kernel conv shapes at 544 (17/34/68-px grids, 13 convs)
# and yolov1's eleven at 448 (56/28/14/7-px grids, 20 convs)
YOLO9000_SHAPES = [(68, 128, 256, 3), (68, 256, 128, 1), (34, 256, 512, 3),
                   (34, 512, 256, 1), (17, 512, 1024, 3),
                   (17, 1024, 512, 1)]
YOLOV1_SHAPES = [(56, 128, 256, 3), (56, 256, 256, 1), (56, 256, 512, 3),
                 (28, 512, 256, 1), (28, 256, 512, 3), (28, 512, 512, 1),
                 (28, 512, 1024, 3), (14, 1024, 512, 1),
                 (14, 512, 1024, 3), (14, 1024, 1024, 3),
                 (7, 1024, 1024, 3)]


@pytest.mark.parametrize("hw,cin,co,ks", YOLO9000_SHAPES + YOLOV1_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b", [1, 32])
def test_conv_kernel_matches_plain_at_yolo9000_and_yolov1_shapes(
        cuda, b, hw, cin, co, ks, dtype):
    """Grids the tiles cover in part (7x7 and 14x14 among them), at the
    split-K batch 1 and at batch 32."""
    gen = torch.Generator(device=cuda).manual_seed(hw * 7 + cin + co)
    x = torch.randn(b, cin, hw, hw, generator=gen, device=cuda).to(
        dtype).contiguous(memory_format=torch.channels_last)
    k = (torch.randn(co, cin, ks, ks, generator=gen, device=cuda)
         * (2.0 / (ks * ks * cin)) ** 0.5).to(dtype).contiguous(
             memory_format=torch.channels_last)
    bias = torch.randn(co, generator=gen, device=cuda) * 0.5
    before = conv_kernel.launches
    got = conv_kernel.fused_conv_bias_act(x, k, bias, act="leaky")
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + 1
    _assert_within(got, conv.fused_conv_bias_act(x, k, bias, act="leaky"))


def test_yolov1_grid_suppress_matches_plain(cuda):
    """The fused NMS route on yolov1's decode: 7x7x3 boxes by 20 classes
    give a (B, 5, 256) grid, K = min(2 * 128, 2940); the kernel's
    detections equal the plain suppression's, one launch."""
    from yolo_tpu_torch.configs.specs import DetectionHead
    from yolo_tpu_torch.ops.decode import decode_detection
    from yolo_tpu_torch.ops.nms import nms_batch

    head = DetectionHead(side=7, num=3, classes=20, sqrt=True)
    rng = np.random.default_rng(11)
    flat = np.concatenate([
        rng.normal(0.3, 0.15, (32, 49 * 20)), rng.normal(0.4, 0.2,
                                                         (32, 49 * 3)),
        rng.normal(0.5, 0.2, (32, 49 * 3 * 4))], 1).astype(np.float32)
    boxes, scores = decode_detection(torch.from_numpy(flat).to(cuda), head)
    kw = dict(conf_threshold=0.2, iou_threshold=0.45)
    before = nms_kernel.launches
    got = nms_batch(boxes, scores, impl="fused", **kw)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    want = nms_batch(boxes, scores, impl="fused_torch", **kw)
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert int(want["valid"].sum()) > 32


def test_yolov1_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A narrow yolov1 (tests/test_yolov1.py's cfg: [crop], [local],
    [dropout], a spatial [connected], [detection]) on the card in fp32:
    the flat head within 1e-4 of the CPU's scale ([local] and
    [connected] without TF32), one NMS launch a forward and the same
    detections: every one at conf + 0.05 has a same-class partner whose
    corners lie within 1 px (boxes clipped to a line have no IoU)."""
    from tests.test_yolov1 import V1_CFG
    from yolo_tpu_torch.configs.darknet_cfg import config_from_cfg
    from yolo_tpu_torch.models.predict import detect_raw

    path = tmp_path / "v1.cfg"
    path.write_text(V1_CFG)
    cfg = dataclasses.replace(config_from_cfg(str(path)), conf_threshold=0.2)
    params = tgraph.fold_params(cfg.layers,
                                dw.synthetic_detector_params(cfg, 0))
    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 120, 160, 3), dtype=np.uint8))
    gpu = tgraph.Darknet(cfg.layers, params, device=cuda)
    cpu = tgraph.Darknet(cfg.layers, params, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (4, 64, 64, 3)).astype(np.float32))
    a, b = gpu(x.to(cuda)).cpu(), cpu(x)
    torch.testing.assert_close(a, b, rtol=0,
                               atol=1e-4 * float(b.abs().max()))
    before = nms_kernel.launches
    got = detect_raw(cfg, gpu, imgs.to(cuda))
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    want = detect_raw(cfg, cpu, imgs)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.numpy() for k, v in want.items()}
    for p, q in ((want, got), (got, want)):
        total = 0
        for i in range(len(imgs)):
            for box, c, sc, v in zip(p["boxes"][i], p["classes"][i],
                                     p["scores"][i], p["valid"][i]):
                if v and sc >= cfg.conf_threshold + 0.05:
                    total += 1
                    assert any(v2 and c2 == c and np.abs(b2 - box).max() <= 1
                               for b2, c2, v2 in zip(
                                   q["boxes"][i], q["classes"][i],
                                   q["valid"][i]))
        assert total >= 1


# --- the s8 conv kernel (csrc/conv_s8_bias_act.cu) ---------------------------

def _s8_shapes():
    """Every distinct conv of YOLOv2-COCO @416, yolov3 @416 and yolov4
    @608 at batch 1 (h, w, cin, co, ks, stride, groups, dilation, act),
    and the shapes no built-in variant has: grouped on both bodies,
    depthwise, dilated, every activation, ragged M (odd sizes)."""
    from yolo_tpu_torch.models.quantize import conv_shapes

    shapes = set()
    for name, size in (("coco", 416), ("yolov3", 416), ("yolov4", 608)):
        shapes.update(conv_shapes(get_variant(name, input_size=size)))
    extra = [(13, 17, 64, 96, 3, 1, 2, 1, "leaky"),
             (11, 9, 48, 24, 3, 1, 3, 1, "leaky"),
             (10, 10, 32, 32, 3, 1, 32, 1, "relu"),
             (20, 20, 64, 64, 3, 1, 1, 2, "leaky"),
             (21, 19, 3, 16, 3, 2, 1, 1, "linear"),
             (7, 9, 96, 40, 5, 1, 1, 1, "logistic"),
             (15, 15, 64, 72, 3, 2, 1, 1, "swish"),
             (9, 11, 128, 200, 1, 1, 1, 1, "ramp"),
             (6, 6, 40, 24, 3, 1, 1, 3, "mish")]
    return sorted(shapes) + extra


@pytest.mark.parametrize("shape", _s8_shapes(),
                         ids=lambda s: "x".join(map(str, s[:8])) + s[8])
def test_conv_s8_kernel_matches_plain(cuda, shape):
    """The s8 kernel against its plain version on the same card tensors,
    float input (fp32, quantized by the wrapper) and chained int8 input,
    int8, bf16 and fp32 outputs. Leaky, linear, relu and ramp: equal
    bytes. Mish, logistic and swish (expf / log1pf / tanhf against
    PyTorch's): within 1 code, 1e-6 relative in fp32 and 1 bf16 ulp."""
    from yolo_tpu_torch.ops import conv_s8
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    h, w, cin, co, ks, stride, groups, dil, act = shape
    rng = np.random.default_rng(h * w + cin * co + ks)
    b = 3 if h * w < 400 else 1
    xq = torch.from_numpy(rng.integers(-127, 128, (b, cin, h, w)).astype(
        np.int8)).to(cuda).contiguous(memory_format=torch.channels_last)
    xf = torch.from_numpy(rng.uniform(-3, 3, (b, cin, h, w)).astype(
        np.float32)).to(cuda).contiguous(memory_format=torch.channels_last)
    kq = torch.from_numpy(rng.integers(-127, 128, (co, cin // groups, ks,
                                                   ks)).astype(np.int8)
                          ).to(cuda).contiguous(
                              memory_format=torch.channels_last)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, co).astype(
        np.float32)).to(cuda)
    bias = torch.from_numpy(rng.uniform(-1, 1, co).astype(np.float32)).to(
        cuda)
    exact = act in ("leaky", "linear", "relu", "ramp")
    for x in (xq, xf):
        for out_scale, dt in ((0.05, torch.float32), (None, torch.bfloat16),
                              (None, torch.float32)):
            kw = dict(x_inv=40.0, out_scale=out_scale, act=act,
                      stride=stride, groups=groups, dilation=dil,
                      out_dtype=dt)
            before = conv_s8_kernel.launches
            got = conv_s8_kernel.conv_s8_bias_act(x, kq, scale, bias, **kw)
            torch.cuda.synchronize()
            assert conv_s8_kernel.launches == before + 1
            want = conv_s8.conv_s8_bias_act(x, kq, scale, bias, **kw)
            assert got.shape == want.shape and got.dtype == want.dtype
            assert got.is_contiguous(memory_format=torch.channels_last)
            if exact:
                assert torch.equal(got, want), (out_scale, dt)
            elif out_scale is not None:
                assert (got.int() - want.int()).abs().max() <= 1
            else:
                torch.testing.assert_close(
                    got.float(), want.float(), atol=1e-6,
                    rtol=1e-6 if dt == torch.float32 else 2 ** -7)


def test_conv_s8_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    x = torch.zeros((1, 32, 8, 8), dtype=torch.int8, device=cuda
                    ).contiguous(memory_format=torch.channels_last)
    k = torch.zeros((16, 32, 3, 3), dtype=torch.int8, device=cuda
                    ).contiguous(memory_format=torch.channels_last)
    s = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="do not match"):
        conv_s8_kernel.conv_s8_bias_act(x, k, s, s, x_inv=1.0, groups=3)
    with pytest.raises(ValueError, match="int8"):
        conv_s8_kernel.conv_s8_bias_act(x, k.float(), s, s, x_inv=1.0)
    with pytest.raises(ValueError, match="channels_last"):
        conv_s8_kernel.conv_s8_bias_act(x.contiguous(), k, s, s, x_inv=1.0)
    with pytest.raises(ValueError, match="activation"):
        conv_s8_kernel.conv_s8_bias_act(x, k, s, s, x_inv=1.0, act="gelu")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_int8_forward_on_the_card_equals_the_cpu(cuda, dtype):
    """YOLOv2-COCO @128, chained int8 params: one s8 launch a conv and no
    plain block on the card, and the logits (and every layer's output,
    int8 codes at the chained boundaries) equal the CPU's bit for bit:
    the sums are exact and the epilogue repeats the plain arithmetic."""
    from yolo_tpu_torch.models import quantize
    from yolo_tpu_torch.ops import conv_s8
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    cfg = get_variant("coco", input_size=128)
    rng = np.random.default_rng(19)
    raw = dw.random_params(cfg.layers, rng, scale=0.03)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    q = quantize.prepare_int8(cfg, raw, x, device="cpu")
    gpu = tgraph.Darknet(cfg.layers, q, device=cuda, dtype=dtype)
    cpu = tgraph.Darknet(cfg.layers, q, device="cpu", dtype=dtype)
    xt = torch.from_numpy(x).to(dtype)
    before, plain = conv_s8_kernel.launches, conv_s8.cuda_calls
    outs = gpu.run(xt.to(cuda).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last), return_all=True)
    torch.cuda.synchronize()
    assert conv_s8_kernel.launches - before == 23
    assert conv_s8.cuda_calls == plain
    want = cpu.run(xt.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last), return_all=True)
    assert sum(o.dtype == torch.int8 for o in want) >= 15
    for i, (a, b) in enumerate(zip(outs, want)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), i


_S8_WIDE = [(1, 13, 1024, 3), (3, 7, 256, 1), (2, 26, 512, 3)]
_S8_TILE_CASES = (
    [(("wgmma", 128, bn, 0, 128), s) for bn in (128, 64) for s in _S8_WIDE]
    + [(("wgmma", 128, 64, 0, chunk), s) for chunk, s in (
        (64, (2, 23, 64, 3)), (64, (1, 13, 1024, 3)), (32, (1, 31, 32, 3)),
        (32, (3, 7, 256, 1)))]
    + [(("mma", bm, 64), s) for bm in (128, 64)
       for s in _S8_WIDE + [(2, 23, 64, 3), (1, 31, 32, 3)]])


@pytest.mark.parametrize("plan,shape", _S8_TILE_CASES, ids=lambda v: (
    "x".join(map(str, v)) if isinstance(v[0], int) else
    f"{v[0]}{v[1]}x{v[2]}" + (f"k{v[4]}" if len(v) > 4 else "")))
def test_conv_s8_kernel_takes_every_tile(cuda, monkeypatch, plan, shape):
    """Each tile and K chunk of the wgmma and mma bodies, forced through
    the plan, on ragged M (the last tile past the batch's pixels), int8,
    bf16 and fp32 outputs: the plain version's bytes."""
    from yolo_tpu_torch.ops import conv_s8
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    b, hw, cin, ks = shape
    monkeypatch.setattr(conv_s8_kernel, "plan",
                        lambda *a, **k: conv_s8_kernel.Plan(*plan))
    rng = np.random.default_rng(b * hw + cin)
    co = 512
    cl = torch.channels_last
    x = torch.from_numpy(rng.integers(-127, 128, (b, cin, hw, hw)).astype(
        np.int8)).to(cuda).contiguous(memory_format=cl)
    k = torch.from_numpy(rng.integers(-127, 128, (co, cin, ks, ks)).astype(
        np.int8)).to(cuda).contiguous(memory_format=cl)
    scale = torch.from_numpy(rng.uniform(1e-6, 1e-5, co).astype(
        np.float32)).to(cuda)
    bias = torch.from_numpy(rng.uniform(-1, 1, co).astype(np.float32)).to(
        cuda)
    for out_scale, dt in ((0.05, torch.float32), (None, torch.bfloat16),
                          (None, torch.float32)):
        kw = dict(x_inv=1.0, out_scale=out_scale, act="leaky", out_dtype=dt)
        got = conv_s8_kernel.conv_s8_bias_act(x, k, scale, bias, **kw)
        torch.cuda.synchronize()
        want = conv_s8.conv_s8_bias_act(x, k, scale, bias, **kw)
        assert torch.equal(got, want), (out_scale, dt)


# --- the s8 kernel's stem body (conv 0 + its pool) and the wgmma body's
# tiles and K splits, forced through the plan; the int8 maxpool kernel ------

def _s8_case(rng, b, h, w, cin, co, ks, groups, device):
    cl = torch.channels_last
    xq = torch.from_numpy(rng.integers(-127, 128, (b, cin, h, w)).astype(
        np.int8)).to(device).contiguous(memory_format=cl)
    xf = torch.from_numpy(rng.uniform(-3, 3, (b, cin, h, w)).astype(
        np.float32)).to(device).contiguous(memory_format=cl)
    kq = torch.from_numpy(rng.integers(-127, 128, (co, cin // groups, ks,
                                                   ks)).astype(np.int8)
                          ).to(device).contiguous(memory_format=cl)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, co).astype(
        np.float32)).to(device)
    bias = torch.from_numpy(rng.uniform(-1, 1, co).astype(np.float32)).to(
        device)
    return xq, xf, kq, scale, bias


def _plain_s8(x, kq, scale, bias, pool=None, **kw):
    """The plain block, then the plain maxpool (int8 codes: the running
    maximum; floats: F.max_pool2d), on the card."""
    from yolo_tpu_torch.ops import conv_s8, pool as pool_ops

    y = conv_s8.conv_s8_bias_act(x, kq, scale, bias, **kw)
    if pool is None:
        return y
    if y.dtype == torch.int8:
        return pool_ops.maxpool_s8_plain(y, *pool)
    return pool_ops.maxpool_nchw(y, *pool)


def _assert_s8_equal(got, want, act, out_scale, dt):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    if act in ("leaky", "linear", "relu", "ramp"):
        assert torch.equal(got, want), (act, out_scale, dt)
    elif out_scale is not None:
        assert (got.int() - want.int()).abs().max() <= 1
    else:
        torch.testing.assert_close(
            got.float(), want.float(), atol=1e-6,
            rtol=1e-6 if dt == torch.float32 else 2 ** -7)


def _stem_shapes():
    """(b, h, w, cin, co, ks, stride, act): conv 0 of YOLOv2-COCO, yolov3
    @416, yolov4 @608 (3->32 3x3), of the tiny variants (3->16, yolov4-
    tiny's stride 2), and ragged or odd ones: odd sizes, a 1x1 over 32
    channels, a 5x5 over one, CO 24 and 40 (a partial 32-channel chunk),
    the non-monotone epilogues."""
    return [(2, 416, 416, 3, 32, 3, 1, "leaky"),
            (1, 608, 608, 3, 32, 3, 1, "mish"),
            (2, 416, 416, 3, 16, 3, 1, "leaky"),
            (2, 416, 416, 3, 32, 3, 2, "leaky"),
            (3, 21, 19, 3, 16, 3, 2, "linear"),
            (2, 37, 45, 32, 24, 1, 1, "relu"),
            (2, 30, 26, 1, 40, 5, 2, "logistic"),
            (1, 13, 70, 3, 8, 3, 1, "ramp")]


@pytest.mark.parametrize("pool", [None, (2, 2), (2, 1), (3, 1), (8, 3)],
                         ids=lambda p: "nopool" if p is None else
                         f"pool{p[0]}s{p[1]}")
@pytest.mark.parametrize("shape", _stem_shapes(),
                         ids=lambda s: "x".join(map(str, s[:7])) + s[7])
def test_conv_s8_stem_matches_plain(cuda, shape, pool):
    """The stem body on every conv-0 shape, with and without its fused
    pool: int8, bf16 and fp32 in (a float input quantized in the kernel)
    and int8, bf16 and fp32 out, against the plain block and the plain
    pool. Leaky, linear, relu, ramp: the same bytes; mish and logistic
    within the s8 kernel's bounds (1 code, 1 bf16 ulp, 1e-6 in fp32)."""
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    b, h, w, cin, co, ks, stride, act = shape
    assert conv_s8_kernel.plan(b * h * w, cin, co, 1, stride=stride,
                               ks=ks).body == "stem"
    rng = np.random.default_rng(h * w + cin * co + ks + stride)
    xq, xf, kq, scale, bias = _s8_case(rng, b, h, w, cin, co, ks, 1, cuda)
    for x in (xq, xf, xf.to(torch.bfloat16)):
        for out_scale, dt in ((0.05, torch.float32), (None, torch.bfloat16),
                              (None, torch.float32)):
            kw = dict(x_inv=40.0, out_scale=out_scale, act=act,
                      stride=stride, out_dtype=dt)
            before = conv_s8_kernel.launches
            got = conv_s8_kernel.conv_s8_bias_act(x, kq, scale, bias,
                                                  pool=pool, **kw)
            torch.cuda.synchronize()
            assert conv_s8_kernel.launches == before + 1
            want = _plain_s8(x, kq, scale, bias, pool=pool, **kw)
            _assert_s8_equal(got, want, act, out_scale, dt)


def _wgmma_shapes():
    """The wgmma body's shapes among _s8_shapes (YOLOv2-COCO @416,
    yolov3 @416, yolov4 @608 at batch 1), leaky."""
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    return [s for s in _s8_shapes()[:-9]
            if conv_s8_kernel.plan(s[0] * s[1], s[2], s[3], s[6],
                                   stride=s[5], dilation=s[7],
                                   ks=s[4]).body == "wgmma"]


def _wgmma_plans(cin, co, ks):
    """Every tile and split the wgmma body is built for that takes the
    shape: BN 64 and 128, unsplit
    and split in 3 (where K spans three stages)."""
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel as sk

    chunk = next(c for c in (128, 64, 32) if cin % c == 0)
    steps = -(-ks * ks * cin // sk.STAGE_K)
    return [sk.Plan("wgmma", 128, bn, chunk=chunk, splits=s)
            for bn in (64, 128)
            if co % bn == 0
            for s in (1, 3) if s <= steps]


@pytest.mark.parametrize("shape", _wgmma_shapes(),
                         ids=lambda s: "x".join(map(str, s[:8])))
def test_conv_s8_wgmma_takes_every_tile_and_split(cuda, monkeypatch,
                                                  shape):
    """Each tile width and K split of the wgmma body, forced through the
    plan, at every wgmma shape of the three nets (batch 2 at 13-26 px,
    else 1; the last tile ragged where M is): int8 and bf16 in, int8,
    bf16 and fp32 out, the plain block's bytes."""
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    h, w, cin, co, ks, stride, groups, dil, act = shape
    b = 2 if h * w < 1000 else 1
    rng = np.random.default_rng(h * w + cin * co + ks)
    xq, xf, kq, scale, bias = _s8_case(rng, b, h, w, cin, co, ks, 1, cuda)
    for p in _wgmma_plans(cin, co, ks):
        monkeypatch.setattr(conv_s8_kernel, "plan", lambda *a, _p=p, **k: _p)
        for x in (xq, xf.to(torch.bfloat16)):
            for out_scale, dt in ((0.05, torch.float32),
                                  (None, torch.bfloat16),
                                  (None, torch.float32)):
                kw = dict(x_inv=40.0, out_scale=out_scale, act=act,
                          out_dtype=dt)
                got = conv_s8_kernel.conv_s8_bias_act(x, kq, scale, bias,
                                                      **kw)
                torch.cuda.synchronize()
                want = _plain_s8(x, kq, scale, bias, **kw)
                assert torch.equal(got, want), (p, x.dtype, out_scale, dt)


def test_conv_s8_wrapper_refuses_a_pool_off_the_stem(cuda):
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel

    cl = torch.channels_last
    x = torch.zeros((1, 32, 8, 8), dtype=torch.int8, device=cuda
                    ).contiguous(memory_format=cl)
    k = torch.zeros((64, 32, 3, 3), dtype=torch.int8, device=cuda
                    ).contiguous(memory_format=cl)
    s = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="stem"):
        conv_s8_kernel.conv_s8_bias_act(x, k, s, s, x_inv=1.0, pool=(2, 2))
    with pytest.raises(ValueError, match="bfloat16"):
        conv_s8_kernel.conv_s8_bias_act(x.half(), k, s, s, x_inv=1.0)


def _pool_shapes():
    """(b, c, h, w, size, stride): every darknet pool the built-in nets
    have (2x2/2, tiny's 2x2/1, yolov3-spp's and yolov4's 5/9/13 stride
    1) at their widths, a 3x3/2, and channel counts off the 16-byte
    vectors (20, 3) and odd sizes."""
    return [(2, 32, 416, 416, 2, 2), (2, 64, 208, 208, 2, 2),
            (4, 128, 104, 104, 2, 2), (4, 256, 52, 52, 2, 2),
            (8, 512, 26, 26, 2, 2), (8, 512, 13, 13, 2, 1),
            (2, 512, 19, 19, 5, 1), (2, 512, 19, 19, 9, 1),
            (2, 512, 19, 19, 13, 1), (3, 48, 15, 17, 3, 2),
            (3, 20, 9, 11, 2, 2), (3, 3, 13, 7, 3, 1), (1, 16, 1, 1, 2, 2)]


@pytest.mark.parametrize("shape", _pool_shapes(),
                         ids=lambda s: "x".join(map(str, s)))
def test_maxpool_s8_kernel_matches_plain(cuda, shape):
    """The int8 maxpool kernel against the running maximum on the same
    card tensor: the same bytes, one launch."""
    from yolo_tpu_torch.ops import pool as pool_ops
    from yolo_tpu_torch.ops.cuda import pool_kernel

    b, c, h, w, size, stride = shape
    rng = np.random.default_rng(b * c + h * w + size)
    x = torch.from_numpy(rng.integers(-128, 128, (b, c, h, w)).astype(
        np.int8)).to(cuda).contiguous(memory_format=torch.channels_last)
    before = pool_kernel.launches
    got = pool_ops.maxpool_nchw(x, size, stride)
    torch.cuda.synchronize()
    assert pool_kernel.launches == before + 1
    want = pool_ops.maxpool_s8_plain(x, size, stride)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == want.shape and torch.equal(got, want)


def test_maxpool_s8_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from yolo_tpu_torch.ops.cuda import pool_kernel

    x = torch.zeros((1, 16, 8, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        pool_kernel.maxpool_s8(x, 2, 2)
    with pytest.raises(ValueError, match="int8"):
        pool_kernel.maxpool_s8(x.float(), 2, 2)


@pytest.mark.parametrize("name", ["coco", "tiny-voc", "yolov3-tiny"])
def test_int8_fused_route_on_the_card_equals_the_cpu(cuda, name):
    """The int8 forward on the fused route (conv 0 + pool 1 in one stem
    launch; the other pools of int8 codes on the pool kernel): the
    card's logits equal the CPU's, one s8 launch a conv, one pool launch
    an unfused pool of int8 codes, no plain block or pool on the
    card."""
    from yolo_tpu_torch.configs import MaxPool as MP
    from yolo_tpu_torch.models import quantize
    from yolo_tpu_torch.ops import conv_s8, pool as pool_ops
    from yolo_tpu_torch.ops.cuda import conv_s8_kernel, pool_kernel

    cfg = get_variant(name, input_size=128)
    rng = np.random.default_rng(23)
    raw = dw.random_params(cfg.layers, rng, scale=0.03)
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    q = quantize.prepare_int8(cfg, raw, x, device="cpu")
    gpu = tgraph.Darknet(cfg.layers, q, device=cuda, dtype=torch.bfloat16)
    cpu = tgraph.Darknet(cfg.layers, q, device="cpu", dtype=torch.bfloat16)
    assert gpu.fused_pools == cpu.fused_pools and 0 in gpu.fused_pools
    xt = torch.from_numpy(x)
    counts = (conv_s8_kernel.launches, pool_kernel.launches,
              conv_s8.cuda_calls, pool_ops.cuda_calls)
    got = gpu(xt.to(cuda))
    torch.cuda.synchronize()
    convs = sum(isinstance(l, Conv) for l in cfg.layers)
    every = cpu.run(xt.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last), return_all=True)
    int8_pools = sum(isinstance(l, MP) and every[i - 1].dtype == torch.int8
                     for i, l in enumerate(cfg.layers))
    assert (conv_s8_kernel.launches - counts[0],
            pool_kernel.launches - counts[1], conv_s8.cuda_calls,
            pool_ops.cuda_calls) == (convs,
                                     int8_pools - len(gpu.fused_pools),
                                     counts[2], counts[3])
    want = cpu(xt)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a.cpu(), b)
