"""The fused conv block of the port (yolo_tpu_torch/ops/conv.py, the
conv_impl="cuda" route of Darknet) against the JAX package's Pallas
kernel (yolo_tpu/ops/pallas/conv_kernel.py) on the CPU, in interpret
mode. On a CPU tensor the CUDA wrapper takes the plain version, so these
tests hold the plain version and the routing; tests/test_torch_cuda.py
holds the kernel against the plain version on the card.

Tolerances:
  * fp32: rtol 1e-5 / atol 1e-5 for one block (tests/test_pallas_conv.py's
    own bound; the sums run in other orders), and for whole nets rtol
    1e-4 / atol 1e-4 * max|logit| (tests/test_torch_graph.py's).
  * bf16: both sides sum exact products of bf16 values in fp32 and round
    once. The two fp32 sums agree to the fp32 bound above (1e-5 of the
    output's scale), and rounding adds at most 1 bf16 ulp of the output:
    one block is held to that sum and to >= 99% identical elements
    (measured: 99.99%; near zero, where the output's own ulp is smaller
    than the sums' noise, up to 8 ulps apart). Whole nets: 2 bf16 ulps of
    the logits' scale, as tests/test_torch_graph.py.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port import to_jax_config
from yolo_tpu.models import graph as jgraph
from yolo_tpu.ops.pallas import conv_kernel as jck
from yolo_tpu_torch.configs import Conv, MaxPool, Reorg, Route, get_variant
from yolo_tpu_torch.configs.specs import weighted_specs
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import graph as tgraph
from yolo_tpu_torch.ops import conv
from yolo_tpu_torch.ops.cuda import build, conv_kernel

torch.set_num_threads(1)

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _to_port(x_nhwc, k_hwio, dtype):
    """NHWC numpy -> (B, C, H, W) channels_last; HWIO -> OIHW
    channels_last."""
    x = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    k = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    return x, k.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ks,act", [(3, "leaky"), (1, "leaky"),
                                    (3, "linear"), (1, "linear")])
def test_plain_block_matches_jax_kernel(ks, act, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(ks * 10 + len(act))
    x = rng.normal(0, 1, (2, 6, 6, 128)).astype(np.float32)
    w = rng.normal(0, 0.05, (ks, ks, 128, 256)).astype(np.float32)
    b = rng.normal(0, 0.5, 256).astype(np.float32)
    want = np.asarray(jck.fused_conv_bias_act(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b), act=act,
        interpret=True).astype(jnp.float32))
    xt, kt = _to_port(x, w, tdt)
    got = conv.fused_conv_bias_act(xt, kt, torch.from_numpy(b), act=act)
    assert got.dtype == tdt and tuple(got.shape) == (2, 256, 6, 6)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.float().permute(0, 2, 3, 1).numpy()
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        noise = 1e-5 * np.abs(want).max()
        assert (np.abs(got - want) <= ulp + noise).all()
        assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("shape,stride", [
    ((3, 3, 128, 256), 1), ((3, 3, 128, 256), 2), ((3, 3, 3, 128), 1),
    ((3, 3, 128, 125), 1), ((1, 1, 256, 128), 1), ((5, 5, 128, 128), 1),
    ((3, 3, 1280, 1024), 1)])
def test_eligible_matches_jax(shape, stride):
    k = np.zeros(shape, np.float32)
    assert conv.eligible(k, stride) == jck.eligible(k, stride)


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    x, k = _to_port(rng.normal(0, 1, (1, 5, 5, 128)).astype(np.float32),
                    rng.normal(0, 0.05, (3, 3, 128, 128)).astype(np.float32),
                    torch.bfloat16)
    b = torch.from_numpy(rng.normal(0, 0.5, 128).astype(np.float32))
    before = conv_kernel.launches
    got = conv_kernel.fused_conv_bias_act(x, k, b, act="leaky")
    assert conv_kernel.launches == before  # no kernel on the CPU
    assert torch.equal(got, conv.fused_conv_bias_act(x, k, b, act="leaky"))
    with pytest.raises(ValueError, match="act"):
        conv.fused_conv_bias_act(x, k, b, act="mish")


# the (H=W, CIN, CO, ks) of YOLOv2-COCO 416's 16 convs on the kernel
COCO_SHAPES = [(52, 128, 256, 3), (52, 256, 128, 1), (26, 256, 512, 3),
               (26, 512, 256, 1), (13, 512, 1024, 3), (13, 1024, 512, 1),
               (13, 1024, 1024, 3), (13, 1280, 1024, 3)]


def _check_plan(batch, h, w, cin, co, ks):
    """The plan's invariants, which the kernel's C entry point also
    checks: a tile the bf16 kernel is built for, BN divides CO, each split
    a run of whole BK chunks, the splits covering K once, the workspace
    of the splits."""
    p = conv_kernel.plan(batch, h, w, cin, co, ks)
    m, k = batch * h * w, ks * ks * cin
    assert (p.bm, p.bn) in conv_kernel.TILES and co % p.bn == 0
    steps = k // conv_kernel.BK
    ranges = conv_kernel.split_steps(steps, p.splits)
    assert len(ranges) == p.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(end > begin for begin, end in ranges)
    for begin, end in ranges:
        for c in range(begin, end):  # a BK chunk lies inside one tap
            k0 = c * conv_kernel.BK
            assert k0 // cin == (k0 + conv_kernel.BK - 1) // cin
    assert p.workspace_bytes == (4 * p.splits * m * co if p.splits > 1
                                 else 0)
    return p, math.ceil(m / p.bm) * (co // p.bn)


@pytest.mark.parametrize("batch", [1, 8, 32, 128])
@pytest.mark.parametrize("hw,cin,co,ks", COCO_SHAPES)
def test_plan_of_the_coco_convs(batch, hw, cin, co, ks):
    """At batch 32 and 128 the output tiles alone fill the card: no split.
    Batch 1 splits K until the 13x13 layers have >= 132 blocks."""
    p, tiles = _check_plan(batch, hw, hw, cin, co, ks)
    m = batch * hw * hw
    if batch >= 32:
        assert p.splits == 1
        assert max(math.ceil(m / bm) * (co // bn) for bm, bn in
                   conv_kernel.TILES if co % bn == 0) >= conv_kernel.SMS
    if batch == 1 and hw == 13:
        assert tiles * p.splits >= conv_kernel.SMS and p.splits > 1


@pytest.mark.parametrize("batch,h,w,cin,co,ks", [
    (3, 7, 7, 128, 128, 3), (1, 1, 1, 128, 128, 3), (2, 9, 9, 384, 128, 3),
    (1, 5, 11, 256, 512, 3), (1, 13, 13, 256, 256, 1),
    (1, 1, 1, 128, 128, 1), (5, 3, 17, 640, 384, 3),
    (64, 13, 13, 1280, 1024, 3)])
def test_plan_of_ragged_shapes(batch, h, w, cin, co, ks):
    p, tiles = _check_plan(batch, h, w, cin, co, ks)
    steps = ks * ks * cin // conv_kernel.BK
    # a split only where the tiles leave SMs idle, and never more splits
    # than K chunks
    assert p.splits == 1 or tiles < conv_kernel.SMS
    assert p.splits <= steps


def test_plan_of_fp32_is_its_one_unsplit_tile():
    for hw, cin, co, ks in COCO_SHAPES:
        assert conv_kernel.plan(1, hw, hw, cin, co, ks, bf16=False) == \
            conv_kernel.Plan(64, 64, 1, 0)


def test_split_steps_cover_k_once_when_splits_do_not_divide_it():
    assert conv_kernel.split_steps(18, 5) == [(0, 3), (3, 7), (7, 10),
                                              (10, 14), (14, 18)]
    assert conv_kernel.split_steps(4, 4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert conv_kernel.split_steps(144, 1) == [(0, 144)]


@pytest.mark.parametrize("bad", [None, "device", "dtype", "nchw-bytes",
                                 "unaligned"])
def test_pointer_checks_of_the_kernel_wrappers(bad):
    """build.check_tensor, which the conv and entry wrappers run on every
    tensor before its pointer goes to a kernel."""
    x = torch.zeros(2, 128, 3, 3).contiguous(memory_format=torch.channels_last)
    device, dtype = torch.device("cpu"), torch.float32
    if bad == "device":
        device = torch.device("meta")
    elif bad == "dtype":
        dtype = torch.bfloat16
    elif bad == "nchw-bytes":
        x = x.contiguous()
    elif bad == "unaligned":
        x = torch.zeros(2 * 128 * 9 + 1)[1:].view(2, 3, 3, 128).permute(
            0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
    if bad is None:
        build.check_tensor("x", x, device, dtype, True)
    else:
        with pytest.raises(ValueError, match="x must"):
            build.check_tensor("x", x, device, dtype, True)


def _narrow_yolov2():
    """yolov2's layer kinds at 128-multiple widths where the kernel
    applies: 3x3 and 1x1 convs on and off the kernel, leaky and linear,
    a pool, a route, a reorg and a concat route feeding a 640-channel
    conv."""
    layers = (
        Conv(32), MaxPool(),                     # 0-1   3 -> 32: plain
        Conv(128),                               # 2     32 -> 128: plain
        Conv(128), Conv(128, 1),                 # 3-4   kernel
        MaxPool(),                               # 5
        Conv(256),                               # 6     kernel
        Conv(128, 1, bn=False, act="linear"),    # 7     kernel, linear
        Route((-4,)),                            # 8 ->  4
        Conv(128, 1),                            # 9     kernel
        Reorg(2),                                # 10    -> 512 channels
        Route((-1, -4)),                         # 11 -> (10, 7): 640
        Conv(256),                               # 12    kernel
        Conv(2 * (5 + 3), 1, bn=False, act="linear"),  # 13 plain
    )
    return dataclasses.replace(get_variant("voc"), layers=layers,
                               anchors=((1.0, 1.5), (3.0, 2.0)),
                               class_names=("a", "b", "c"), input_size=32)


def _counting(monkeypatch, module, name, **bound):
    """Replace module.name by a wrapper that counts its calls (and binds
    ``bound`` keyword arguments)."""
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs, **bound)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_darknet_cuda_route_matches_jax_pallas_route(monkeypatch, dtype):
    """Darknet.forward(conv_impl="cuda") against apply_layers(
    conv_impl="pallas") with the Pallas kernel in interpret mode: the
    same 6 convs go through the kernel in both."""
    tdt, jdt = DTYPES[dtype]
    cfg = _narrow_yolov2()
    rng = np.random.default_rng(7)
    folded = tgraph.fold_params(
        cfg.layers, dw.random_params(cfg.layers, rng, scale=0.1), cfg.bn_eps)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jax_calls = _counting(monkeypatch, jck, "fused_conv_bias_act",
                          interpret=True)
    want = np.asarray(jgraph.apply_layers(
        to_jax_config(cfg).layers, jgraph.params_to_jax(folded),
        jnp.asarray(x), eps=cfg.bn_eps, compute_dtype=jdt,
        conv_impl="pallas"))
    port_calls = _counting(monkeypatch, tgraph.conv_kernel,
                           "fused_conv_bias_act")
    net = tgraph.Darknet(cfg.layers, folded, device="cpu", dtype=tdt)
    got = net(torch.from_numpy(x), conv_impl="cuda").numpy()
    assert len(jax_calls) == len(port_calls) == 6
    assert [tuple(s) for s in jax_calls] == \
        [(s[0], s[2], s[3], s[1]) for s in port_calls]  # NHWC vs NCHW
    assert got.shape == want.shape == (2, 8, 8, 16)
    scale = float(np.abs(want).max())
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert np.abs(got - want).max() <= 2 * _bf16_ulp(scale)


def test_coco_cuda_route_sends_its_16_eligible_convs_to_the_kernel(
        monkeypatch):
    """YOLOv2-COCO at full width (input cut to 64): the kernel takes the
    16 convs with CIN and CO multiples of 128 (layers 8-10, 12-16, 18-24
    and 29), 81.5% of the net's FLOPs; the default route sends none. On
    the CPU both routes run the same plain block, so they agree exactly."""
    cfg = get_variant("coco", input_size=64)
    folded = tgraph.fold_params(cfg.layers,
                                dw.synthetic_detector_params(cfg, 0),
                                cfg.bn_eps)
    net = tgraph.Darknet(cfg.layers, folded, device="cpu",
                         dtype=torch.bfloat16)
    convs = [i for i, l in enumerate(cfg.layers) if isinstance(l, Conv)]
    on_kernel = [idx for idx, ok in zip(convs, net.kernel_eligible) if ok]
    assert on_kernel == [8, 9, 10, 12, 13, 14, 15, 16, 18, 19, 20, 21, 22,
                         23, 24, 29]
    assert all(hasattr(net, f"kernel{i}_bf16") == ok
               for i, ok in enumerate(net.kernel_eligible))
    calls = _counting(monkeypatch, tgraph.conv_kernel, "fused_conv_bias_act")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    plain = net(x)
    assert calls == []
    routed = net(x, conv_impl="cuda")
    assert len(calls) == 16
    assert torch.equal(routed, plain)
    with pytest.raises(ValueError, match="conv_impl"):
        net(x, conv_impl="pallas")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_coco_416_kernel_convs_match_the_jax_pallas_route(monkeypatch,
                                                          dtype):
    """The convs of YOLOv2-COCO 416 that the JAX package's
    apply_layers(conv_impl="pallas") sends to its kernel, traced by
    shape only (jax.eval_shape, the kernel stubbed), against the port's
    eligible set. bf16: the same 16. fp32: the JAX route also asks the
    TPU's VMEM budget (conv_kernel.feasible, which the port does not
    port), and the 1280 -> 1024 3x3 conv's double-buffered fp32 weights
    do not fit it, so that conv stays on XLA there: 15 against the
    port's 16."""
    _, jdt = DTYPES[dtype]
    cfg = get_variant("coco")
    convs = weighted_specs(cfg.layers)
    shapes = [(c.size, c.size, cin, c.filters) for c, cin in
              zip(convs, dw._conv_in_channels(cfg.layers))]
    routed = []

    def stub(x, kernel, bias, *, act="leaky", interpret=False):
        routed.append(tuple(kernel.shape))
        return jnp.zeros(x.shape[:3] + kernel.shape[-1:], x.dtype)

    monkeypatch.setattr(jck, "fused_conv_bias_act", stub)
    params = [{"kernel": jax.ShapeDtypeStruct(s, jnp.float32),
               "bias": jax.ShapeDtypeStruct(s[-1:], jnp.float32)}
              for s in shapes]
    out = jax.eval_shape(lambda p, x: jgraph.apply_layers(
        to_jax_config(cfg).layers, p, x, eps=cfg.bn_eps, compute_dtype=jdt,
        conv_impl="pallas"), params,
        jax.ShapeDtypeStruct((1, 416, 416, 3), jnp.float32))
    assert out.shape == (1, 13, 13, 425)
    port = [s for s, c in zip(shapes, convs)
            if conv.eligible(np.broadcast_to(np.float32(0), s), c.stride)]
    assert len(port) == 16
    if dtype == "bf16":
        assert routed == port
    else:
        assert routed == port[:-1] and port[-1] == (3, 3, 1280, 1024)
        assert not jck.feasible((1, 13, 13, 1280), port[-1], 4)
