"""Darknet-style training augmentation (port of yolo_tpu/data/augment.py:
random crop with jitter, horizontal flip, HSV distortion, blur, gaussian
noise, the yolov4 mosaic and the classifier rotate/scale crop;
yolov2-voc.cfg: jitter=0.3, hue=0.1, saturation=1.5, exposure=1.5).

Host-side numpy and C, without OpenCV: the JAX package's cv2 calls are
replaced by
  * cv2.copyMakeBorder(BORDER_REPLICATE) -> np.pad(mode="edge"), exact;
  * cv2's 8-bit RGB -> HSV -> rgb2hsv_u8, cv2's fixed-point division
    tables (hsv_shift 12), byte for byte;
  * cv2's 8-bit HSV -> RGB -> hsv2rgb_u8 (native.preproc, in
    native/resample.c): OpenCV 5's AVX2 float32 sector formula with its
    fused multiply-adds, truncated in the vectorized blocks of a row and
    rounded in the row's tail, byte for byte;
  * cv2.GaussianBlur(ksize, 0) -> native.preproc.gaussian_blur_u8 and
    cv2.warpAffine(INTER_LINEAR | WARP_INVERSE_MAP, BORDER_REPLICATE) ->
    native.preproc.warp_affine_u8 (native/resample.c), byte for byte.
As there, a 1-channel image keeps its channel axis where cv2 would drop
it. Boxes are normalized (cx, cy, w, h).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from yolo_tpu_torch.data.targets import _as_hw
from yolo_tpu_torch.native.preproc import (gaussian_blur_u8, hsv2rgb_u8,
                                           warp_affine_u8)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The JAX package's AugmentConfig, field for field. mosaic and
    mixup act in data.pipeline.train_batches, the classifier geometry
    keys (angle, aspect, min_crop, max_crop) in
    data.imagefolder.classifier_train_batches."""
    flip: bool = True
    jitter: float = 0.3
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5
    min_box_visibility: float = 0.25  # drop boxes mostly cropped away
    mosaic: bool = False
    mixup: bool = False
    angle: float = 0.0
    aspect: float = 1.0
    min_crop: int = 0
    max_crop: int = 0
    blur: int = 0
    gaussian_noise: float = 0.0

    @property
    def classifier_geometry(self) -> bool:
        """True when any classifier scale/rotation key is active."""
        return bool(self.angle or self.aspect != 1.0
                    or self.min_crop or self.max_crop)


def _rand_scale(rng: np.random.Generator, s: float) -> float:
    """darknet rand_scale: uniform in [1, s], inverted half the time;
    s < 1 samples [s, 1]."""
    lo, hi = (1.0, s) if s >= 1.0 else (s, 1.0)
    v = rng.uniform(lo, hi)
    return v if rng.uniform() < 0.5 else 1.0 / v


_HSV_SHIFT = 12


def _div_table(num: int) -> np.ndarray:
    """cv2's RGB2HSV_b tables: saturate_cast<int>(num / i), 0 at i = 0."""
    i = np.arange(256, dtype=np.float64)
    t = np.zeros(256, np.int32)
    t[1:] = np.rint(num / i[1:]).astype(np.int32)
    return t


_SDIV = _div_table(255 << _HSV_SHIFT)
_HDIV180 = _div_table((180 << _HSV_SHIFT) / 6.0)


def rgb2hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) for (H, W, 3) uint8: H in
    [0, 180), S and V in [0, 255]. int32 holds every product."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    out = np.empty(img.shape, np.uint8)
    out[..., 1] = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    out[..., 2] = v
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h[h < 0] += 180
    out[..., 0] = h
    return out


def distort_hsv(img_u8: np.ndarray, rng: np.random.Generator,
                cfg: AugmentConfig) -> np.ndarray:
    """Hue shift, saturation and exposure scales in cv2's 8-bit HSV, the
    JAX package's draws in its order."""
    if cfg.hue == 0 and cfg.saturation == 1 and cfg.exposure == 1:
        return img_u8
    if img_u8.ndim == 2 or img_u8.shape[-1] == 1:
        # gray: exposure only; the hue and saturation draws still happen
        rng.uniform(-cfg.hue, cfg.hue)
        _rand_scale(rng, cfg.saturation)
        dexp = _rand_scale(rng, cfg.exposure)
        return np.clip(np.rint(img_u8.astype(np.float32) * dexp),
                       0, 255).astype(np.uint8)
    hsv = rgb2hsv_u8(img_u8).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] + rng.uniform(-cfg.hue, cfg.hue) * 180.0) % 180.0
    hsv[..., 1] = np.clip(hsv[..., 1] * _rand_scale(rng, cfg.saturation), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * _rand_scale(rng, cfg.exposure), 0, 255)
    return hsv2rgb_u8(hsv.astype(np.uint8))


def jitter_crop(img_u8: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
                rng: np.random.Generator, cfg: AugmentConfig):
    """Random crop with darknet-style jitter on each edge; the window may
    extend beyond the image (edge replication); boxes re-normalized to
    the crop, clipped, low-visibility boxes dropped."""
    h, w = img_u8.shape[:2]
    dw, dh = int(w * cfg.jitter), int(h * cfg.jitter)
    left = rng.integers(-dw, dw + 1)
    right = rng.integers(-dw, dw + 1)
    top = rng.integers(-dh, dh + 1)
    bottom = rng.integers(-dh, dh + 1)
    x1, x2 = int(left), int(w - right)
    y1, y2 = int(top), int(h - bottom)
    if x2 - x1 < w // 4 or y2 - y1 < h // 4:
        return img_u8, boxes, classes
    pad_l, pad_t = max(0, -x1), max(0, -y1)
    pad_r, pad_b = max(0, x2 - w), max(0, y2 - h)
    src = img_u8
    if pad_l or pad_t or pad_r or pad_b:
        pad = ((pad_t, pad_b), (pad_l, pad_r)) + ((0, 0),) * (img_u8.ndim - 2)
        src = np.pad(img_u8, pad, mode="edge")
    crop = src[y1 + pad_t:y2 + pad_t, x1 + pad_l:x2 + pad_l]
    cw, ch = x2 - x1, y2 - y1

    if len(boxes) == 0:
        return crop, boxes, classes
    b = boxes.astype(np.float64)
    px1 = np.clip(b[:, 0] * w - b[:, 2] * w / 2 - x1, 0, cw)
    py1 = np.clip(b[:, 1] * h - b[:, 3] * h / 2 - y1, 0, ch)
    px2 = np.clip(b[:, 0] * w + b[:, 2] * w / 2 - x1, 0, cw)
    py2 = np.clip(b[:, 1] * h + b[:, 3] * h / 2 - y1, 0, ch)
    nw, nh = (px2 - px1) / cw, (py2 - py1) / ch
    visibility = np.where(
        b[:, 2] * b[:, 3] > 0,
        (nw * cw / w / np.maximum(b[:, 2], 1e-9)) *
        (nh * ch / h / np.maximum(b[:, 3], 1e-9)), 0.0)
    keep = (nw > 0.001) & (nh > 0.001) & (visibility >= cfg.min_box_visibility)
    out = np.stack([(px1 + px2) / 2 / cw, (py1 + py2) / 2 / ch, nw, nh],
                   axis=-1)[keep].astype(np.float32)
    return crop, out, classes[keep]


def flip_horizontal(img_u8: np.ndarray, boxes: np.ndarray):
    img = img_u8[:, ::-1]
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, 0] = 1.0 - boxes[:, 0]
    return np.ascontiguousarray(img), boxes


def apply_blur(img_u8: np.ndarray, boxes: np.ndarray,
               rng: np.random.Generator, cfg: AugmentConfig) -> np.ndarray:
    """[net] blur: a draw of none / background / full. The background
    mode blurs with ksize 17 and copies each truth box back sharp (the
    only mode of blur=1); the full mode blurs with ksize
    (blur // 2) * 2 + 1. boxes are normalized xywh."""
    if not cfg.blur:
        return img_u8
    mode = int(rng.integers(0, 3))   # none / background / full
    if mode == 0:
        return img_u8
    background = mode == 1 or int(cfg.blur) == 1
    ksize = 17 if background else (int(cfg.blur) // 2) * 2 + 1
    dst = gaussian_blur_u8(img_u8, ksize)
    if dst.ndim == 2:                # as cv2's 2-D result in the JAX package
        dst = dst[..., None]
    if background:
        h, w = img_u8.shape[:2]
        for cx, cy, bw, bh in np.asarray(boxes,
                                         np.float64).reshape(-1, 4):
            x1 = max(int((cx - bw / 2) * w), 0)
            y1 = max(int((cy - bh / 2) * h), 0)
            x2 = min(int((cx + bw / 2) * w) + 1, w)
            y2 = min(int((cy + bh / 2) * h) + 1, h)
            if x2 > x1 and y2 > y1:
                dst[y1:y2, x1:x2] = img_u8[y1:y2, x1:x2]
    return dst


def apply_gaussian_noise(img_u8: np.ndarray, rng: np.random.Generator,
                         cfg: AugmentConfig) -> np.ndarray:
    """[net] gaussian_noise: on a coin flip, additive N(0, sigma) with
    sigma = min(value, 127), saturated into uint8."""
    if not cfg.gaussian_noise:
        return img_u8
    if int(rng.integers(0, 2)) == 0:
        return img_u8
    sigma = min(float(cfg.gaussian_noise), 127.0)
    noise = rng.normal(0.0, sigma, img_u8.shape)
    return np.clip(img_u8.astype(np.float64) + noise, 0.0,
                   255.0).astype(np.uint8)


def rotate_scale_crop(img_u8: np.ndarray, size: int, *, rad: float,
                      scale: float, aspect: float, dx: float,
                      dy: float) -> np.ndarray:
    """darknet image.c rotate_crop_image as one warp: output pixel
    (x, y) samples the input at
      R(rad) @ diag(aspect/scale, 1/scale) @ (x - size/2 + dx,
                                              y - size/2 + dy) + center
    (bilinear, coordinates clamped to the image), the matrix in float32
    as the JAX package builds it."""
    h, w = img_u8.shape[:2]
    cosr, sinr = float(np.cos(rad)), float(np.sin(rad))
    ax, ay = aspect / scale, 1.0 / scale
    ox, oy = dx - size / 2.0, dy - size / 2.0
    m = np.array(
        [[cosr * ax, -sinr * ay, w / 2.0 + cosr * ax * ox - sinr * ay * oy],
         [sinr * ax, cosr * ay, h / 2.0 + sinr * ax * ox + cosr * ay * oy]],
        np.float32)
    return warp_affine_u8(img_u8, m, (size, size))


def random_augment_classifier(img_u8: np.ndarray,
                              rng: np.random.Generator,
                              cfg: AugmentConfig,
                              size: int) -> np.ndarray:
    """darknet data.c random_augment_image: aspect = rand_scale(aspect);
    r = rand_int(min_crop, max_crop) becomes the scaled short side
    (scale = r / min(h, w*aspect)); rotation U(-angle, angle) degrees;
    center offset U(+-|scaled_extent - size|/2) per axis; one size x size
    resample. Absent min_crop/max_crop take darknet's parse defaults
    (net size, twice the net size)."""
    h, w = img_u8.shape[:2]
    aspect = _rand_scale(rng, cfg.aspect) if cfg.aspect != 1.0 else 1.0
    lo = cfg.min_crop or size
    hi = cfg.max_crop or 2 * size
    if lo > hi:
        raise ValueError(f"min_crop={lo} > max_crop={hi}")
    r = int(rng.integers(lo, hi + 1))
    scale = r / min(h, w * aspect)
    rad = (np.deg2rad(rng.uniform(-cfg.angle, cfg.angle))
           if cfg.angle else 0.0)
    dxm = abs(w * scale / aspect - size) / 2.0
    dym = abs(h * scale - size) / 2.0
    return rotate_scale_crop(
        img_u8, size, rad=rad, scale=scale, aspect=aspect,
        dx=float(rng.uniform(-dxm, dxm)), dy=float(rng.uniform(-dym, dym)))


def augment(img_u8: np.ndarray, boxes: np.ndarray, classes: np.ndarray,
            rng: np.random.Generator,
            cfg: AugmentConfig = AugmentConfig()
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full darknet-style augmentation for one training sample, the JAX
    package's draws in its order. As there, the classifier geometry keys
    (angle, aspect, min_crop, max_crop) and mosaic/mixup, which act at
    the pipeline level, do not act here."""
    img_u8, boxes, classes = jitter_crop(img_u8, boxes, classes, rng, cfg)
    if cfg.flip and rng.uniform() < 0.5:
        img_u8, boxes = flip_horizontal(img_u8, boxes)
    img_u8 = distort_hsv(img_u8, rng, cfg)
    img_u8 = apply_blur(img_u8, boxes, rng, cfg)
    img_u8 = apply_gaussian_noise(img_u8, rng, cfg)
    return img_u8, boxes, classes


def mosaic4(samples, net_size, rng: np.random.Generator,
            cfg: AugmentConfig = AugmentConfig()
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """yolov4 mosaic: a random cut point splits the net-size canvas into
    4 quadrants; each of the 4 (already augmented) samples is stretched
    to net size and gives its aligned quadrant. Boxes map through the
    stretch, are clipped to their quadrant and dropped below
    min_box_visibility of their area before the clip.

    samples: 4 tuples (img_u8 HxWxC, boxes (G, 4) normalized xywh,
    classes (G,)). net_size: int or (net_h, net_w). Returns (canvas
    uint8 (net_h, net_w, C), boxes (float64) normalized to the canvas,
    classes (int64))."""
    assert len(samples) == 4
    nh, nw = _as_hw(net_size)
    cx = int(nw * rng.uniform(0.25, 0.75))
    cy = int(nh * rng.uniform(0.25, 0.75))
    c = samples[0][0].shape[2] if samples[0][0].ndim == 3 else 1
    canvas = np.zeros((nh, nw, c), np.uint8)
    regions = ((0, 0, cx, cy), (cx, 0, nw, cy),
               (0, cy, cx, nh), (cx, cy, nw, nh))
    out_boxes, out_classes = [], []
    for (img, boxes, classes), (x1, y1, x2, y2) in zip(samples, regions):
        # only the kept quadrant, sampled with the whole-image stretch's
        # half-pixel map: src_x = (dst_x + x1 + 0.5) * w/nw - 0.5
        h, w = img.shape[:2]
        m = np.array([[w / nw, 0.0, (x1 + 0.5) * w / nw - 0.5],
                      [0.0, h / nh, (y1 + 0.5) * h / nh - 0.5]],
                     np.float64)
        quad = warp_affine_u8(img, m, (x2 - x1, y2 - y1))
        canvas[y1:y2, x1:x2] = (quad[..., None] if quad.ndim == 2
                                else quad)
        for box, cls in zip(np.asarray(boxes, np.float64), classes):
            bx1 = (box[0] - box[2] / 2) * nw
            by1 = (box[1] - box[3] / 2) * nh
            bx2 = (box[0] + box[2] / 2) * nw
            by2 = (box[1] + box[3] / 2) * nh
            area = max(bx2 - bx1, 0) * max(by2 - by1, 0)
            nx1, ny1 = max(bx1, x1), max(by1, y1)
            nx2, ny2 = min(bx2, x2), min(by2, y2)
            vis = max(nx2 - nx1, 0) * max(ny2 - ny1, 0)
            if area <= 0 or vis <= 0 or vis / area < cfg.min_box_visibility:
                continue
            out_boxes.append([(nx1 + nx2) / 2 / nw, (ny1 + ny2) / 2 / nh,
                              (nx2 - nx1) / nw, (ny2 - ny1) / nh])
            out_classes.append(int(cls))
    return (canvas,
            np.asarray(out_boxes, np.float64).reshape(-1, 4),
            np.asarray(out_classes, np.int64))


# darknet's parse defaults for absent keys (no HSV distortion unless the
# cfg asks; flip=1; jitter=0.2)
_DARKNET_PARSE_DEFAULTS = {"jitter": 0.2, "saturation": 1.0,
                           "exposure": 1.0, "hue": 0.0, "flip": True}


def config_from_net_params(net_hp: dict, *, mosaic: bool = False,
                           mixup: bool = False,
                           force_defaults: bool = False) -> AugmentConfig:
    """AugmentConfig from a darknet cfg's training keys ([net]
    saturation/exposure/hue/flip/... and the head's jitter). Absent keys
    take darknet's parse defaults; force_defaults=True takes the
    yolov2-voc values (the field defaults) instead."""
    kwargs = {} if force_defaults else dict(_DARKNET_PARSE_DEFAULTS)
    for k in ("jitter", "saturation", "exposure", "hue", "angle", "aspect"):
        if k in net_hp:
            kwargs[k] = float(net_hp[k])
    for k in ("min_crop", "max_crop", "blur"):
        if k in net_hp:
            kwargs[k] = int(net_hp[k])
    if "gaussian_noise" in net_hp:
        kwargs["gaussian_noise"] = float(net_hp["gaussian_noise"])
    if "flip" in net_hp:
        kwargs["flip"] = bool(net_hp["flip"])
    return AugmentConfig(mosaic=mosaic or bool(net_hp.get("mosaic", 0)),
                         mixup=mixup or bool(net_hp.get("mixup", 0)),
                         **kwargs)
