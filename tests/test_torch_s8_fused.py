"""The s8 kernel's fused conv + maxpool route and its plan, on the CPU.

  * the wrapper's fused call (conv_s8_bias_act(..., pool=...)) equals
    the plain block followed by the plain pool, and the JAX package's
    conv_block_int8 followed by its maxpool (yolo_tpu/ops/pool.py), at
    2x2/2, 2x2/1 and 3x3/1, for int8, bf16 and fp32 outputs, bit for
    bit (leaky: the int32 sums are exact and the epilogue is JAX's
    arithmetic);
  * Darknet.run takes the fused route exactly where the rule says: an
    int8 conv on the stem body (stem_takes) whose next layer is a
    maxpool and whose output nothing else reads, unless run returns
    every layer; on YOLOv2-COCO (conv 0 + pool 1; conv 16 feeds route
    25, so pool 17 stays apart), tiny-voc and yolov3-tiny;
  * plan picks the stem body for conv 0 of YOLOv2-COCO, yolov3 and
    yolov4 and keeps dp4a for narrow groups; the wgmma body's K splits;
  * the int8 pool wrapper's and the fused call's refusals.
The whole int8 forward against the JAX package's is
tests/test_torch_quantize_slice.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.configs.specs import Conv as JConv
from yolo_tpu.models import quantize as jq
from yolo_tpu.ops import pool as jpool
from yolo_tpu_torch.configs import MaxPool, get_variant
from yolo_tpu_torch.configs.specs import Conv
from yolo_tpu_torch.io import darknet_weights as dw
from yolo_tpu_torch.models import quantize
from yolo_tpu_torch.models.graph import Darknet, params_from_numpy
from yolo_tpu_torch.ops import conv_s8, pool
from yolo_tpu_torch.ops.cuda import conv_s8_kernel, pool_kernel

torch.set_num_threads(1)

_KERNEL, _MAXPOOL = conv_s8_kernel.conv_s8_bias_act, pool.maxpool_nchw


def _block(rng, cin, co, ks, chained_out):
    p = {"kernel_q": rng.integers(-127, 128, (ks, ks, cin, co)).astype(
             np.int8),
         "w_scale": rng.uniform(0.001, 0.01, co).astype(np.float32),
         "x_scale": np.float32(rng.uniform(0.01, 0.05)),
         "bias": rng.uniform(-1, 1, co).astype(np.float32)}
    if chained_out:
        p["out_scale"] = np.float32(rng.uniform(0.02, 0.2))
    return p


@pytest.mark.parametrize("out", ["int8", "bf16", "fp32"])
@pytest.mark.parametrize("size,stride", [(2, 2), (2, 1), (3, 1)])
def test_fused_conv_pool_equals_conv_then_pool(size, stride, out):
    """conv 0's shape (3 -> 32 channels, 3x3, leaky) on odd sizes: the
    fused call equals the plain block then maxpool_nchw, and JAX's
    conv_block_int8 then maxpool_nhwc, bit for bit."""
    rng = np.random.default_rng(size * 10 + stride)
    spec = Conv(32, size=3, act="leaky")
    jspec = JConv(32, size=3, act="leaky")
    p = _block(rng, 3, 32, 3, out == "int8")
    tp = params_from_numpy((spec,), [p], "cpu")[0]
    dtype = torch.float32 if out == "fp32" else torch.bfloat16
    jdtype = jnp.float32 if out == "fp32" else jnp.bfloat16
    x = jnp.asarray(rng.uniform(0, 1, (2, 23, 17, 3)).astype(np.float32),
                    jdtype)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
    kw = dict(x_inv=float(np.float32(1) / p["x_scale"]),
              out_scale=None if out != "int8" else float(p["out_scale"]),
              act="leaky", out_dtype=dtype)
    scale = tp["x_scale"] * tp["w_scale"]
    before = conv_s8_kernel.launches
    got = conv_s8_kernel.conv_s8_bias_act(tx, tp["kernel_q"], scale,
                                          tp["bias"], pool=(size, stride),
                                          **kw)
    assert conv_s8_kernel.launches == before
    plain = pool.maxpool_nchw(conv_s8.conv_s8_bias_act(
        tx, tp["kernel_q"], scale, tp["bias"], **kw), size, stride)
    assert got.dtype == plain.dtype and torch.equal(got, plain)
    assert got.is_contiguous(memory_format=torch.channels_last)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jpool.maxpool_nhwc(jq.conv_block_int8(x, jp, jspec,
                                                 compute_dtype=jdtype),
                              size, stride)
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)))


def _int8_net(name, size=96):
    cfg = get_variant(name, input_size=size)
    rng = np.random.default_rng(31)
    raw = dw.random_params(cfg.layers, rng, scale=0.03)
    x = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    q = quantize.prepare_int8(cfg, raw, x, device="cpu")
    return cfg, Darknet(cfg.layers, q, device="cpu", dtype=torch.bfloat16), x


def _calls(monkeypatch, net, x, return_all):
    """(conv layer index of each s8 call, its pool) and the pools that
    ran apart, in one run of net on x."""
    convs, pools = [], []
    conv_layers = [i for i, l in enumerate(net.layers) if isinstance(l, Conv)]

    def conv(*a, pool=None, **kw):
        convs.append((conv_layers[len(convs)], pool))
        return _KERNEL(*a, pool=pool, **kw)

    def apart(x, size, stride):
        pools.append((size, stride, x.dtype))
        return _MAXPOOL(x, size, stride)

    monkeypatch.setattr(conv_s8_kernel, "conv_s8_bias_act", conv)
    monkeypatch.setattr("yolo_tpu_torch.models.graph.maxpool_nchw", apart)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)
    out = net.run(xt, return_all=return_all)
    return convs, pools, out


@pytest.mark.parametrize("name,fused", [
    ("coco", {0: (2, 2)}), ("tiny-voc", {0: (2, 2)}),
    ("yolov3-tiny", {0: (2, 2)}), ("yolov4-tiny", {})])
def test_darknet_fuses_exactly_where_the_rule_says(monkeypatch, name,
                                                   fused):
    """The fused pools are the rule's: an int8 conv on the stem body
    followed by a maxpool, its output not routed. A run passes each of
    them to its conv's call and runs every other pool apart; with
    return_all nothing fuses, and the logits of both runs agree."""
    cfg, net, x = _int8_net(name)
    assert net.fused_pools == fused
    routed = {i for i, l in enumerate(cfg.layers)
              if isinstance(l, Conv) and i in net._routed
              and isinstance(cfg.layers[i + 1], MaxPool)}
    assert not routed & set(fused)
    if name == "coco":
        assert routed == {16}  # conv 16 feeds route 25: pool 17 apart
    convs, pools, out = _calls(monkeypatch, net, x, False)
    assert [c for c in convs if c[1] is not None] == sorted(fused.items())
    n_pools = sum(isinstance(l, MaxPool) for l in cfg.layers)
    assert len(pools) == n_pools - len(fused)
    convs_all, pools_all, every = _calls(monkeypatch, net, x, True)
    assert all(p is None for _, p in convs_all)
    assert len(pools_all) == n_pools
    want = every[-1]
    got = out[0] if isinstance(out, tuple) else out
    if not isinstance(out, tuple):
        assert torch.equal(got, want.permute(0, 2, 3, 1).float())


def test_darknet_leaves_a_routed_producer_unfused(monkeypatch):
    """A stem-shaped int8 conv whose output a route also reads keeps its
    pool apart: tiny-voc with a route to conv 0 added after the first
    pool."""
    import dataclasses

    from yolo_tpu_torch.configs.specs import Route

    cfg = get_variant("tiny-voc", input_size=64)
    layers = list(cfg.layers)
    # after pool 1: route back to conv 0 and pool it again
    layers[2:2] = [Route((-2,)), MaxPool(2, 2)]
    cfg = dataclasses.replace(cfg, layers=tuple(layers))
    rng = np.random.default_rng(5)
    raw = dw.random_params(cfg.layers, rng, scale=0.03)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    q = quantize.prepare_int8(cfg, raw, x, device="cpu")
    net = Darknet(cfg.layers, q, device="cpu", dtype=torch.bfloat16)
    assert 0 in net._routed and net.fused_pools == {}
    convs, _, _ = _calls(monkeypatch, net, x, False)
    assert all(p is None for _, p in convs)


@pytest.mark.parametrize("name,size", [("coco", 416), ("yolov3", 416),
                                       ("yolov4", 608), ("tiny-voc", 416),
                                       ("yolov4-tiny", 416)])
def test_plan_takes_the_stem_for_conv0(name, size):
    cfg = get_variant(name, input_size=size)
    c0 = cfg.layers[0]
    assert c0.size * c0.size * 3 <= conv_s8_kernel.STEM_K
    ho = (size - 1) // c0.stride + 1
    assert conv_s8_kernel.plan(32 * ho * ho, 3, c0.filters, 1,
                               stride=c0.stride, ks=c0.size) == \
        conv_s8_kernel.Plan("stem")


@pytest.mark.parametrize("cin_g,co_g,groups,stride,dil,ks,body", [
    (3, 32, 1, 1, 1, 3, "stem"), (1, 40, 1, 2, 1, 5, "stem"),
    (32, 24, 1, 1, 1, 1, "stem"), (3, 30, 1, 1, 1, 3, "dp4a"),
    (3, 32, 1, 3, 1, 3, "dp4a"), (3, 32, 1, 1, 2, 3, "dp4a"),
    (1, 1, 64, 1, 1, 3, "dp4a"), (3, 16, 2, 1, 1, 3, "dp4a"),
    (4, 32, 1, 1, 1, 3, "dp4a")])
def test_plan_keeps_dp4a_for_narrow_groups(cin_g, co_g, groups, stride,
                                           dil, ks, body):
    """The stem takes ungrouped, undilated convs of stride 1 or 2 with a
    window of at most 32 bytes and CO % 8; grouped narrow convs and the
    rest stay on dp4a."""
    assert conv_s8_kernel.plan(10 ** 5, cin_g, co_g, groups, stride=stride,
                               dilation=dil, ks=ks).body == body


@pytest.mark.parametrize("m,cin,co,ks,bn", [
    (169, 1024, 1024, 3, 128), (5408, 1024, 1024, 3, 128),
    (21632, 1024, 1024, 3, 128), (21632, 1280, 1024, 3, 128),
    (5408, 256, 512, 3, 64), (86528, 128, 256, 3, 64),
    (21632, 512, 256, 1, 64)])
def test_plan_tile_widths(m, cin, co, ks, bn):
    """128-wide tiles from K = WGMMA_WIDE_K on 128-byte boxes, else 64
    (tools/port_perf.py tiles_s8's ranking)."""
    assert conv_s8_kernel.plan(m, cin, co, 1, ks=ks).bn == bn


@pytest.mark.parametrize("m,cin,co,ks,splits", [
    (169, 1024, 1024, 3, 8), (169, 512, 1024, 3, 8), (676, 256, 512, 3, 2),
    (2704, 128, 256, 3, 1), (5408, 1024, 1024, 3, 1),
    (169, 1280, 1024, 3, 8), (169, 1024, 512, 1, 4), (169, 64, 64, 1, 1)])
def test_plan_splits_k_where_the_tiles_do_not_fill_the_card(m, cin, co, ks,
                                                            splits):
    """wgmma plans split K where their 128-row tiles number fewer than
    the card's 132 SMs: as many splits as fill it, two stages a split
    at least."""
    p = conv_s8_kernel.plan(m, cin, co, 1, ks=ks)
    assert p.body == "wgmma" and p.splits == splits, p
    tiles = -(-m // 128) * (co // p.bn)
    assert tiles * p.splits <= conv_s8_kernel.SMS or p.splits == 1
    assert p.splits <= max(1, -(-ks * ks * cin // conv_s8_kernel.STAGE_K)
                           // 2)


@pytest.mark.parametrize("bad", [(0, 2), (2, 0), (2.0, 2), (True, 1)])
def test_pool_wrapper_refuses_bad_sizes(bad):
    x = torch.zeros((1, 16, 8, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="positive ints"):
        pool_kernel.maxpool_s8(x, *bad)
    w = torch.zeros((16, 16, 3, 3), dtype=torch.int8)
    s = torch.ones(16)
    with pytest.raises(ValueError, match="positive ints"):
        conv_s8_kernel.conv_s8_bias_act(x, w, s, s, x_inv=1.0, pool=bad)


def test_pool_wrapper_refuses_what_the_kernel_does_not_take():
    """Not int8 codes, not 4-D, or neither on the card nor on the CPU:
    ValueError before any launch; a CPU tensor runs the plain pool."""
    x = torch.zeros((1, 16, 8, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        pool_kernel.maxpool_s8(x.float(), 2, 2)
    with pytest.raises(ValueError, match="4-D"):
        pool_kernel.maxpool_s8(x[0], 2, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pool_kernel.maxpool_s8(x.to("meta"), 2, 2)
    before = pool_kernel.launches
    got = pool_kernel.maxpool_s8(x.contiguous(
        memory_format=torch.channels_last), 3, 1)
    assert pool_kernel.launches == before and got.shape == (1, 16, 8, 8)


@pytest.mark.parametrize("size,stride", [(2, 2), (2, 1), (3, 1), (5, 1),
                                         (3, 2), (13, 1)])
def test_plain_int8_pool_out_hw(size, stride):
    """maxpool_s8_plain's output size is pool.out_hw's, the size the
    kernel and the fused stem write."""
    for h, w in ((13, 13), (8, 11), (1, 3)):
        x = torch.randint(-128, 128, (1, 4, h, w), dtype=torch.int8)
        got = pool.maxpool_s8_plain(x, size, stride)
        assert tuple(got.shape[-2:]) == pool.out_hw(h, w, size, stride)
        f = pool.maxpool_nchw(x.float(), size, stride)
        assert tuple(f.shape[-2:]) == pool.out_hw(h, w, size, stride)
