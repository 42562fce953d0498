"""Darknet classifier inference (port of yolo_tpu/models/classify.py;
darknet classifier.c predict_classifier): min-side resize + centre crop,
one forward through the softmax-head net, top-k labels.

The preprocess is darknet's geometry: ``resize_min(im, net->w)`` scales
so that the smaller side equals the net size (bilinear, as cv2.resize
INTER_LINEAR on float32 pixels, reproduced in numpy: the card machine
has no OpenCV), then
``crop_image`` takes the centred net x net window. darknet19 and
darknet53 are the pretrained-backbone sources of yolov2 and yolov3
fine-tuning (``partial`` cuts the .conv.NN files from them).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from yolo_tpu_torch.configs.specs import ModelConfig
from yolo_tpu_torch.models.graph import Darknet
from yolo_tpu_torch.ops.letterbox import as_hw


def _linear_taps(src: int, dst: int):
    """Bilinear taps along one axis with half-pixel centres: source x =
    (d + 0.5) * src / dst - 0.5, its floor and fraction in float64;
    positions left of the first pixel or at/after the last clamp to that
    pixel with fraction 0. Returns (i0, i1, w0, w1)."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    low, high = i0 < 0, i0 >= src - 1
    i0 = np.where(low, 0, np.where(high, src - 1, i0))
    frac = np.where(low | high, 0.0, frac)
    return i0, np.minimum(i0 + 1, src - 1), 1.0 - frac, frac


def resize_linear(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """(H, W, C) float32 -> (new_h, new_w, C) float32 as cv2.resize(img,
    (new_w, new_h), interpolation=INTER_LINEAR) gives it in a default
    OpenCV build, whose float path is Intel IPP's (taps in double): the
    horizontal pass, then the vertical, in float64, rounded once
    (within 2 float32 ulps of cv2's)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, new_w)
    y0, y1, b0, b1 = _linear_taps(h, new_h)
    src = img.astype(np.float64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    return (rows[y0] * b0[:, None, None]
            + rows[y1] * b1[:, None, None]).astype(np.float32)


def classifier_preprocess(image_u8: np.ndarray, net_size) -> np.ndarray:
    """(H, W, C) uint8 -> (net_h, net_w, C) float32 in [0, 1]: darknet
    resize_min (the smaller side to the net size, aspect kept) + centre
    crop. A rectangular net scales so that both extents are covered,
    then crops each axis; the square case keeps darknet's integer
    arithmetic."""
    h, w = image_u8.shape[:2]
    net_h, net_w = as_hw(net_size)
    if net_h == net_w:
        if w < h:
            new_w, new_h = net_w, (h * net_w) // w
        else:
            new_w, new_h = (w * net_h) // h, net_h
    else:
        scale = max(net_w / w, net_h / h)
        new_w = max(net_w, int(round(w * scale)))
        new_h = max(net_h, int(round(h * scale)))
    img = image_u8.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]
    resized = resize_linear(img, new_w, new_h)
    dx, dy = (new_w - net_w) // 2, (new_h - net_h) // 2
    return resized[dy:dy + net_h, dx:dx + net_w]


def make_classifier(cfg: ModelConfig):
    """``fn(net, images) -> (B, C)`` fp32 probabilities (a tree
    classifier's per-group conditionals) on the net's device; images
    (B, net_h, net_w, C) float in [0, 1], numpy or a tensor. The device
    and the compute dtype are the Darknet module's, chosen where it is
    built."""
    if cfg.head_kind != "softmax":
        raise ValueError(f"{cfg.name} is not a classifier "
                         f"(head_kind={cfg.head_kind})")

    def run(net: Darknet, images) -> torch.Tensor:
        return net(torch.as_tensor(images, device=net.device).float())

    return run


def top_k(probs, class_names: Tuple[str, ...], k: int = 5
          ) -> List[Tuple[str, float]]:
    """One image's probabilities -> [(name, prob)] best first."""
    probs = np.asarray(probs).reshape(-1)
    idx = np.argsort(-probs)[:k]
    return [(class_names[i], float(probs[i])) for i in idx]


def preprocess_samples(samples, net_size, channels: int = 3) -> tuple:
    """(path, label) samples -> (xs (N, net_h, net_w, C) float32, labels
    (N,) int64), decoded and preprocessed once (the mid-training eval's
    cache)."""
    from yolo_tpu_torch.data.pipeline import load_image

    xs = np.stack([classifier_preprocess(load_image(p, channels), net_size)
                   for p, _ in samples]).astype(np.float32)
    labels = np.asarray([lab for _, lab in samples], np.int64)
    return xs, labels


def _probs(cfg: ModelConfig, net: Darknet, xs) -> np.ndarray:
    """A batch's probabilities as numpy; a tree classifier's leaf-masked
    absolute probabilities."""
    probs = make_classifier(cfg)(net, xs).cpu().numpy()
    tree = cfg.softmax_tree
    return probs if tree is None else hierarchy_leaf_probs(probs, tree)


def accuracy_counts(cfg: ModelConfig, net: Darknet, xs, labels, *,
                    batch: int = 32, k: int = 5,
                    quantize_first_batch=None):
    """(n, top1_hits, topk_hits) over preprocessed arrays, darknet's
    `classifier valid` protocol in batches of ``batch`` (the last one
    padded with zeros): a tree classifier scores leaf-masked absolute
    probabilities, and an internal-node label is a hit when it lies on
    the predicted leaf's root path. quantize_first_batch(xs) -> net
    hooks int8 calibration on the first (padded) batch, whose net then
    scores every batch."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    tree = cfg.softmax_tree
    n = len(labels)
    top1 = topk = 0
    for i in range(0, n, batch):
        chunk = xs[i:i + batch]
        real = len(chunk)
        if real < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - real,) + chunk.shape[1:],
                                 chunk.dtype)])
        if i == 0 and quantize_first_batch is not None:
            net = quantize_first_batch(chunk)
        order = np.argsort(-_probs(cfg, net, chunk)[:real], axis=-1)
        for true_idx, o in zip(labels[i:i + batch], order):
            if tree is not None:
                hits = [true_idx in tree.path(int(p)) for p in o[:k]]
                top1 += int(hits[0])
                topk += int(any(hits))
            else:
                top1 += int(o[0] == true_idx)
                topk += int(true_idx in o[:k])
    return n, top1, topk


def accuracy_from_arrays(cfg: ModelConfig, net: Darknet, xs, labels, *,
                         batch: int = 32, k: int = 5,
                         quantize_first_batch=None) -> dict:
    """accuracy_counts as the `classify --images` JSON dict."""
    n, top1, topk = accuracy_counts(
        cfg, net, xs, labels, batch=batch, k=k,
        quantize_first_batch=quantize_first_batch)
    if n == 0:
        raise ValueError("no images to score (empty input — check the "
                         "folder layout and --names class list)")
    return {"images": n, "top1": round(top1 / n, 4),
            f"top{k}": round(topk / n, 4)}


def imagefolder_accuracy(cfg: ModelConfig, net: Darknet, samples, *,
                         batch: int = 32, k: int = 5,
                         quantize_first_batch=None) -> dict:
    """Accuracy over (path, label) samples, decoding one batch at a time
    (the one-shot `classify --images`). quantize_first_batch(xs) -> net
    calibrates int8 once on the first chunk (zero-padded to ``batch``);
    every chunk then runs the quantized net."""
    from yolo_tpu_torch.data.pipeline import load_image

    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if not samples:
        raise ValueError("no images to score (empty imagefolder — "
                         "check the folder layout and --names class "
                         "list)")
    n_done = hits1 = hitsk = 0
    for i in range(0, len(samples), batch):
        chunk = samples[i:i + batch]
        xs = np.stack([classifier_preprocess(
            load_image(p, cfg.in_channels), cfg.input_hw)
            for p, _ in chunk]).astype(np.float32)
        labels = np.asarray([lab for _, lab in chunk], np.int64)
        if i == 0 and quantize_first_batch is not None:
            calib = xs
            if len(chunk) < batch:
                calib = np.concatenate(
                    [xs, np.zeros((batch - len(chunk),) + xs.shape[1:],
                                  xs.dtype)])
            net = quantize_first_batch(calib)
        n, h1, hk = accuracy_counts(cfg, net, xs, labels, batch=batch, k=k)
        n_done += n
        hits1 += h1
        hitsk += hk
    return {"images": n_done, "top1": round(hits1 / n_done, 4),
            f"top{k}": round(hitsk / n_done, 4)}


def hierarchy_leaf_probs(cond, tree) -> np.ndarray:
    """Tree-classifier conditionals (B, C) -> absolute probabilities with
    the internal nodes zeroed (the YOLO9000 classification protocol)."""
    from yolo_tpu_torch.ops.decode import (_tree_np_consts,
                                           tree_absolute_probs)

    absolute = tree_absolute_probs(torch.as_tensor(np.asarray(
        cond, np.float32)), tree).numpy()
    return np.where(_tree_np_consts(tree)["leaf"], absolute, 0.0)


def hierarchy_path(cond_row, tree) -> List[Tuple[str, float, float]]:
    """One image's conditionals -> the greedy root-to-leaf path as
    [(name, conditional, absolute)] (`classify --hierarchy`): each split
    takes its most confident child."""
    cond_row = np.asarray(cond_row).reshape(-1)
    out: List[Tuple[str, float, float]] = []
    group, p = 0, 1.0
    while True:
        members = list(tree.group_members(group))
        node = members[int(np.argmax(cond_row[members]))]
        c = float(cond_row[node])
        p *= c
        out.append((tree.names[node], c, p))
        if tree.leaf(node):
            return out
        group = tree.child_group[node]
