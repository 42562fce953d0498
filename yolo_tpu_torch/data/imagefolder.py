"""Imagefolder classifier datasets, ``<root>/<class_name>/<image>`` (port
of yolo_tpu/data/imagefolder.py): the layout `classify --images` scores
and `train --imagefolder` trains a softmax-head model on.

Training batches take darknet's inference geometry (resize_min + centre
crop, models/classify.classifier_preprocess), a seeded horizontal flip
and, with an AugmentConfig, the HSV distortion the detector pipeline
uses (data/augment.py::distort_hsv) on the source image before the
preprocess. With the classifier scale/rotation keys ([net] angle,
aspect, min_crop, max_crop) the geometry crop
(data/augment.py::random_augment_classifier) replaces the preprocess and
the HSV distortion acts on the net-size crop, darknet's order.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def list_imagefolder(root: str, class_names: Sequence[str]
                     ) -> List[Tuple[str, int]]:
    """(path, class_idx) samples; every subdirectory must be a class
    name (a stray directory raises rather than vanish)."""
    name_to_idx = {n: i for i, n in enumerate(class_names)}
    samples: List[Tuple[str, int]] = []
    for sub in sorted(os.listdir(root)):
        subdir = os.path.join(root, sub)
        if not os.path.isdir(subdir):
            continue
        if sub not in name_to_idx:
            raise ValueError(
                f"directory '{sub}' is not a class name of this model "
                f"(imagefolder layout: one subdirectory per class; pass "
                f"--names for custom label sets)")
        samples += [(os.path.join(subdir, f), name_to_idx[sub])
                    for f in sorted(os.listdir(subdir))
                    if os.path.splitext(f)[1].lower() in IMAGE_EXTS]
    if not samples:
        raise ValueError(f"no images under {root} "
                         f"(expected <dir>/<class>/<image> layout)")
    return samples


def steps_per_epoch(n_samples: int, batch: int) -> int:
    """Batches an epoch yields (the trailing partial batch wraps)."""
    return -(-n_samples // batch)


def _square_size(net_size) -> int:
    """The side of the geometry crop, which is square: a rectangular net
    raises."""
    if isinstance(net_size, (tuple, list)):
        if net_size[0] != net_size[1]:
            raise ValueError(
                "classifier geometry augmentation (angle/aspect/min_crop/"
                "max_crop) produces square crops — rectangular "
                "classifier nets must train without it")
        return int(net_size[0])
    return int(net_size)


def classifier_train_batches(samples: Sequence[Tuple[str, int]],
                             batch: int, net_size, *,
                             epochs: int = 1, seed: int = 0,
                             flip: bool = True, start_step: int = 0,
                             augment_cfg=None, channels: int = 3
                             ) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epochs of {"images" (B, net_h, net_w, C) float32 in [0,
    1], "labels" (B,) int32}; an epoch's trailing partial batch wraps
    with its leading samples.

    The shuffle and the flips of an epoch come from (seed, epoch) alone,
    the HSV draws from (seed, epoch, sample), never from how many
    batches were taken, so ``start_step`` resumes the stream where a run
    stopped. augment_cfg (data.augment.AugmentConfig) distorts HSV
    before the preprocess, or, with its classifier geometry keys, after
    the geometry crop that replaces the preprocess (square nets only);
    its flip field replaces ``flip``."""
    from yolo_tpu_torch.data.pipeline import load_image
    from yolo_tpu_torch.models.classify import classifier_preprocess

    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if len(samples) < batch:
        raise ValueError(f"dataset has {len(samples)} images but "
                         f"batch={batch} — need at least one full batch")
    spe = steps_per_epoch(len(samples), batch)
    first_epoch, skip_batches = divmod(start_step, spe)
    if augment_cfg is not None:
        flip = augment_cfg.flip
    for epoch in range(first_epoch, epochs):
        order = np.random.default_rng(
            (seed, 1, epoch)).permutation(len(samples))
        flips = (np.random.default_rng(
            (seed, 2, epoch)).random(len(samples)) < 0.5)
        start = skip_batches if epoch == first_epoch else 0
        for bi in range(start, spe):
            idx = order[bi * batch:(bi + 1) * batch]
            if len(idx) < batch:
                idx = np.concatenate([idx, order[:batch - len(idx)]])
            imgs, labels = [], []
            for j in idx:
                path, cls = samples[j]
                img = load_image(path, channels)
                if augment_cfg is not None:
                    from yolo_tpu_torch.data.augment import (
                        distort_hsv, random_augment_classifier)

                    aug_rng = np.random.default_rng(
                        (seed, 3, epoch, int(j)))
                    if augment_cfg.classifier_geometry:
                        img = random_augment_classifier(
                            img, aug_rng, augment_cfg,
                            _square_size(net_size))
                        img = distort_hsv(img, aug_rng, augment_cfg)
                        x = img.astype(np.float32) / 255.0
                    else:
                        img = distort_hsv(img, aug_rng, augment_cfg)
                        x = classifier_preprocess(img, net_size)
                else:
                    x = classifier_preprocess(img, net_size)
                if flip and flips[j]:
                    x = x[:, ::-1]
                imgs.append(x)
                labels.append(cls)
            yield {"images": np.stack(imgs).astype(np.float32),
                   "labels": np.asarray(labels, np.int32)}
