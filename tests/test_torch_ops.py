"""yolo_tpu_torch letterbox / maxpool / reorg against the JAX package and
the numpy oracles, on the CPU, fp32.

Tolerances: letterbox 1e-5 abs (fp32 matmuls summing a few products in
another order than XLA's; the JAX op's own gate against the cv2 oracle
is the same 1e-5); unletterbox 1e-4 abs in pixels (fp32 on a 640-pixel
scale); maxpool and reorg are exact (a max and a permutation move values
without arithmetic)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_tpu.ops import letterbox as jlb
from yolo_tpu.ops import numpy_ref as npr
from yolo_tpu.ops.pool import maxpool_nhwc as jax_maxpool
from yolo_tpu.ops.reorg import reorg_nhwc as jax_reorg
from yolo_tpu_torch.ops import letterbox as tlb
from yolo_tpu_torch.ops.pool import maxpool_nhwc
from yolo_tpu_torch.ops.reorg import reorg_nchw, reorg_nhwc

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (100, 300),
                                   (160, 160)])
def test_letterbox_matches_jax_and_cv2(shape):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    got = tlb.letterbox(torch.from_numpy(imgs), 160).numpy()
    want_jax = np.asarray(jlb.letterbox(jnp.asarray(imgs), 160))
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=1e-5)
    for i in range(2):
        want_cv2, scale, px, py = npr.letterbox(imgs[i], 160, 160)
        np.testing.assert_allclose(got[i], want_cv2, rtol=0, atol=1e-5)
    assert tlb.letterbox_geometry(*shape, 160) == \
        jlb.letterbox_geometry(*shape, 160)


def test_letterbox_rect_net_and_upscale():
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (1, 50, 70, 3), dtype=np.uint8)
    got = tlb.letterbox(torch.from_numpy(imgs), (96, 160)).numpy()
    want = np.asarray(jlb.letterbox(jnp.asarray(imgs), (96, 160)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlb._lerp_matrix(50, 96),
                                  jlb._lerp_matrix(50, 96))


def test_letterbox_bf16_matches_jax_within_one_ulp():
    """bf16 rounds after each matmul in both packages; one bf16 ulp at
    1.0 is 2**-7, the most two fp32 sums rounded apart can differ."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (1, 120, 200, 3), dtype=np.uint8)
    got = tlb.letterbox(torch.from_numpy(imgs), 96,
                        dtype=torch.bfloat16).float().numpy()
    want = np.asarray(jlb.letterbox(jnp.asarray(imgs), 96,
                                    dtype=jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -7)


def test_stretch_matches_jax_and_cv2():
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (1, 100, 300, 3), dtype=np.uint8)
    got = tlb.stretch_resize(torch.from_numpy(imgs), 128).numpy()
    want = np.asarray(jlb.stretch_resize(jnp.asarray(imgs), 128))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], npr.stretch_resize(imgs[0], 128, 128),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("src_hw,net", [((480, 640), 416),
                                        ((300, 100), (96, 160))])
def test_unletterbox_and_unstretch_match_jax(src_hw, net):
    rng = np.random.default_rng(6)
    boxes = np.stack([rng.uniform(0, 1, (2, 20)), rng.uniform(0, 1, (2, 20)),
                      rng.uniform(0.01, 0.8, (2, 20)),
                      rng.uniform(0.01, 0.8, (2, 20))], -1).astype(np.float32)
    h, w = src_hw
    got = tlb.unletterbox_boxes_xyxy(torch.from_numpy(boxes), src_h=h,
                                     src_w=w, net_size=net).numpy()
    want = np.asarray(jlb.unletterbox_boxes_xyxy(
        jnp.asarray(boxes), src_h=h, src_w=w, net_size=net))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    got = tlb.unstretch_boxes_xyxy(torch.from_numpy(boxes), src_h=h,
                                   src_w=w).numpy()
    want = np.asarray(jlb.unstretch_boxes_xyxy(jnp.asarray(boxes),
                                               src_h=h, src_w=w))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("size,stride,hw", [(2, 2, (12, 12)), (2, 1, (13, 13)),
                                            (2, 2, (13, 9)), (5, 1, (8, 8)),
                                            (3, 2, (9, 10))])
def test_maxpool_matches_jax_and_oracle(size, stride, hw):
    x = np.random.default_rng(7).normal(size=(2, *hw, 5)).astype(np.float32)
    got = maxpool_nhwc(torch.from_numpy(x), size, stride).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_maxpool(
        jnp.asarray(x), size, stride)))
    np.testing.assert_array_equal(got, npr.maxpool_nhwc(x, size, stride))


def test_maxpool_stride1_keeps_size_and_pads_at_end():
    """tiny-YOLO's 2x2/1 pool: darknet pads the END with -inf, so the last
    row/column pools over itself (a symmetric pad would shift it)."""
    x = -np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    got = maxpool_nhwc(torch.from_numpy(x), 2, 1).numpy()
    assert got.shape == x.shape
    np.testing.assert_array_equal(got[0, -1, -1, 0], x[0, -1, -1, 0])
    np.testing.assert_array_equal(got, npr.maxpool_nhwc(x, 2, 1))


@pytest.mark.parametrize("shape", [(2, 26, 26, 64), (1, 4, 6, 8)])
def test_reorg_matches_jax_and_darknet_oracle(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = reorg_nhwc(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_reorg(jnp.asarray(x),
                                                            2)))
    np.testing.assert_array_equal(got, npr.reorg_nhwc(x, 2))


def test_reorg_is_not_pixel_unshuffle():
    x = torch.arange(2 * 8 * 4 * 4, dtype=torch.float32).reshape(2, 8, 4, 4)
    got = reorg_nchw(x, 2)
    unshuffled = torch.nn.functional.pixel_unshuffle(x, 2)
    assert got.shape == unshuffled.shape
    assert not torch.equal(got, unshuffled)
    # but it is a permutation of the same values
    assert torch.equal(got.flatten().sort().values,
                       x.flatten().sort().values)


def test_reorg_on_channels_last_memory():
    """The executor hands reorg channels_last tensors: the result must not
    depend on the memory format."""
    x = torch.randn(2, 16, 6, 6, generator=torch.Generator().manual_seed(0))
    cl = x.contiguous(memory_format=torch.channels_last)
    assert torch.equal(reorg_nchw(cl, 2), reorg_nchw(x, 2))
