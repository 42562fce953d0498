"""Host data pipeline (port of yolo_tpu/data/pipeline.py): decode,
augment, letterbox and encode on host threads, then staged copies to the
card ahead of the consumer.

  training:  decode -> augment -> host letterbox (fp32) -> GT encode
             -> fixed-shape batch (train_batches)
  eval:      decode -> host letterbox -> one (net_h, net_w) shape for
             every source size (inference_batches)

Images decode with the port's own decoder by default on every host
(native/preproc.py: JPEG, PNG, BMP, PNM, TIFF and WebP, the bytes
cv2.imread gives), so that
the tests run the code the card runs; set_decoder("cv2") selects OpenCV
where it is installed. The host letterbox is the C one of
native/letterbox.c (cv2 INTER_LINEAR semantics, the JAX package's
native letterbox byte for byte); the stretch is the C one beside it (the
JAX package's numpy_ref.stretch_resize byte for byte). Torch runs one
intra-op thread in each pool worker, so that the workers do not
oversubscribe the cores.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import queue as queue_mod
import sys
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolo_tpu_torch.data import targets as tgt
from yolo_tpu_torch.data.augment import augment, mosaic4
from yolo_tpu_torch.data.voc import parse_annotation
from yolo_tpu_torch.device import resolve as resolve_device
from yolo_tpu_torch.native.preproc import (decode_image, letterbox_batch,
                                           stretch)
from yolo_tpu_torch.ops.letterbox import as_hw, letterbox_geometry


# Host image decoder: "native" (native/preproc.py, the default on every
# host: the JPEG, PNG, BMP, PNM, TIFF, WebP, GIF, Sun raster, PFM, HDR
# and JPEG 2000 files cv2 reads, with cv2's bytes) or "cv2" (OpenCV, only
# when asked for; it also reads AVIF files, which the native decoder
# raises for)
_DECODER = "native"


def _cv2():
    import cv2

    return cv2


def set_decoder(name: str) -> None:
    """Select the host image decoder for this process ("native" |
    "cv2"). "cv2" raises ImportError where OpenCV is not installed."""
    global _DECODER
    if name not in ("native", "cv2"):
        raise ValueError(f"unknown decoder {name!r} (native | cv2)")
    if name == "cv2":
        _cv2()
    _DECODER = name


def get_decoder() -> str:
    return _DECODER


def load_image_rgb(path: str) -> np.ndarray:
    """Host decode -> (H, W, 3) uint8 RGB (load_image at 3 channels)."""
    return load_image(path, 3)


def load_image(path: str, channels: int = 3) -> np.ndarray:
    """Host decode at the model's channel count -> (H, W, C) uint8 RGB
    (C=3) or gray (C=1), as cv2.imread(IMREAD_COLOR / IMREAD_GRAYSCALE)
    gives them, through the selected decoder. The native decoder raises
    ValueError for what it does not decode (native/preproc.py)."""
    if channels not in (1, 3):
        raise ValueError(f"channels={channels}: darknet image loading "
                         f"supports 1 (grayscale) or 3 (RGB)")
    if _DECODER == "native":
        return decode_image(path, channels)
    cv2 = _cv2()
    flag = cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE
    img = cv2.imread(path, flag)
    if img is None:
        raise FileNotFoundError(f"cannot decode image: {path}")
    return (cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if channels == 3
            else img[..., None])


def letterbox_boxes(boxes_xywh: np.ndarray, src_w: int, src_h: int,
                    net_size) -> np.ndarray:
    """Normalized source-image xywh boxes -> net-space normalized xywh
    after letterboxing (ops/letterbox.py's geometry)."""
    net_h, net_w = as_hw(net_size)
    scale, rh, rw, px, py = letterbox_geometry(src_h, src_w, net_size)
    b = np.asarray(boxes_xywh, np.float32).copy()
    out = np.empty_like(b)
    out[:, 0] = (b[:, 0] * src_w * scale + px) / net_w
    out[:, 1] = (b[:, 1] * src_h * scale + py) / net_h
    out[:, 2] = b[:, 2] * src_w * scale / net_w
    out[:, 3] = b[:, 3] * src_h * scale / net_h
    return out


def _host_resize(img: np.ndarray, size, resize: str) -> np.ndarray:
    """(H, W, C) uint8 -> (net_h, net_w, C) float32 in [0, 1]: the C
    letterbox or the C stretch on this thread (native/preproc.py)."""
    if resize == "stretch":
        return stretch(img, size)
    return letterbox_batch(img[None], size, n_threads=1)[0]


def _check_resize(resize: str) -> None:
    if resize not in ("letterbox", "stretch"):
        raise ValueError(f"unknown resize {resize!r} (letterbox | stretch)")


def _one_torch_thread() -> None:
    """Pool-worker initializer: one intra-op thread for torch ops run in
    this worker (the OpenMP thread count is per thread)."""
    torch.set_num_threads(1)


class _Pool:
    """A ThreadPoolExecutor whose workers run torch on one thread; on
    exit the calling thread's torch thread count is set again, since
    torch also keeps the last count as the default for new threads."""

    def __init__(self, workers: int):
        self._saved = torch.get_num_threads()
        self.pool = cf.ThreadPoolExecutor(workers,
                                          initializer=_one_torch_thread)

    def __enter__(self):
        return self.pool

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)
        torch.set_num_threads(self._saved)
        return False


class DevicePrefetcher:
    """Wrap a host-batch iterator (dicts of numpy arrays and metadata)
    and keep up to ``depth`` batches staged on ``device`` ahead of the
    consumer. On CUDA a thread copies each batch from pinned host memory
    on a side stream and records an event; the consumer's stream waits on
    that event before the batch is handed over (and the tensors are
    recorded on that stream), so the copies overlap the consumer's work.
    Metadata (paths, shapes, pad counts) stays on the host. device:
    "cuda" by default, raising without a card; "cpu" only when asked
    for. sharding (parallel/sharding.py: batch_sharding(mesh), or the
    mesh): each batch is split into one contiguous shard per mesh device
    and each shard staged on its device, handed over as a
    sharding.Sharded of per-shard dicts (a mesh of one device hands over
    the plain dict on it). close() (or a with block) stops the thread
    early."""

    def __init__(self, host_iter: Iterable, depth: int = 2, device="cuda",
                 sharding=None):
        mesh = getattr(sharding, "mesh", sharding)
        self.devices = ((resolve_device(device),) if mesh is None
                        else mesh.devices)
        self.device = self.devices[0]
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        streams = {d: torch.cuda.Stream(d) for d in set(self.devices)
                   if d.type == "cuda"}

        def stage_shard(batch, lo, hi, dev):
            out = {}
            for k, v in batch.items():
                if not isinstance(v, np.ndarray):
                    out[k] = v
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
                if dev.type == "cuda":
                    with torch.cuda.stream(streams[dev]):
                        t = t.pin_memory().to(dev, non_blocking=True)
                elif dev != t.device:
                    t = t.to(dev)
                out[k] = t
            return out

        def stage(batch):
            sizes = {len(v) for v in batch.values()
                     if isinstance(v, np.ndarray)}
            b = sizes.pop() if len(sizes) == 1 else 0
            n = len(self.devices)
            if n > 1 and (sizes or not b or b % n):
                raise ValueError(f"a batch of {b} rows does not shard over "
                                 f"the {n} devices of the mesh")
            if n == 1:
                shards = [stage_shard(batch, None, None, self.device)]
            else:
                rows = b // n
                shards = [stage_shard(batch, i * rows, (i + 1) * rows, d)
                          for i, d in enumerate(self.devices)]
            events = {}
            for d, stream in streams.items():
                events[d] = torch.cuda.Event()
                events[d].record(stream)
            if n == 1:
                return shards[0], events
            from yolo_tpu_torch.parallel.sharding import Sharded

            return Sharded(mesh, shards), events

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            it = iter(host_iter)
            try:
                for batch in it:
                    if not put(stage(batch)):
                        break
            except BaseException as e:  # surfaced on next()
                self._err = e
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Dict]:
        while True:
            item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            batch, events = item
            for d, event in events.items():
                consumer = torch.cuda.current_stream(d)
                consumer.wait_event(event)
                for shard in (batch if isinstance(batch, tuple)
                              else (batch,)):
                    for v in shard.values():
                        if isinstance(v, torch.Tensor) and v.device == d:
                            v.record_stream(consumer)
            yield batch

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue_mod.Empty:
                pass
            self._thread.join(timeout=0.1)
            timeout -= 0.1
            if timeout <= 0:
                raise RuntimeError("DevicePrefetcher thread did not stop")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def inference_batches(image_paths: Sequence[str], batch_size: int, *,
                      net_size=None, workers: int = 8,
                      skip_errors: bool = True, resize: str = "letterbox",
                      channels: int = 3) -> Iterator[Dict]:
    """Decode images in parallel into inference batches.

    net_size=(net_h, net_w) or an int (the host-preprocess mode): uniform
    (B, net_h, net_w, C) float32 batches, one shape for every source
    size; each batch carries its 'paths' and source 'shapes' for the box
    un-mapping, and the last is padded to batch_size by repeating its
    final image, with 'pad' the count.

    net_size=None (the device-preprocess mode): raw uint8 (B, H, W, C)
    batches bucketed by source shape, each full bucket yielded as it
    fills and the remainders, padded as above, at the end, in order of
    first appearance (the JAX package's bucketing)."""
    _check_resize(resize)

    def load(path):
        try:
            img = load_image(path, channels)
        except (FileNotFoundError, OSError, ValueError) as e:
            if skip_errors:
                print(f"skipping {path}: {e}", file=sys.stderr)
                return None
            raise
        if net_size is None:
            return path, img
        return path, img.shape[:2], _host_resize(img, net_size, resize)

    with _Pool(workers) as pool:
        # at most ~4 batches of decodes in flight
        paths_iter = iter(image_paths)
        inflight: collections.deque = collections.deque()

        def refill():
            while len(inflight) < max(workers, batch_size) * 4:
                p = next(paths_iter, None)
                if p is None:
                    return
                inflight.append(pool.submit(load, p))

        def decoded():
            refill()
            while inflight:
                item = inflight.popleft().result()
                refill()
                if item is not None:
                    yield item

        if net_size is None:
            buckets: Dict[Tuple[int, int], List] = {}
            for path, img in decoded():
                items = buckets.setdefault(img.shape[:2], [])
                items.append((path, img))
                if len(items) == batch_size:
                    del buckets[img.shape[:2]]
                    yield {"images": np.stack([im for _, im in items]),
                           "paths": [p for p, _ in items]}
            for items in buckets.values():
                pad = batch_size - len(items)
                yield {"images": np.stack([im for _, im in items]
                                          + [items[-1][1]] * pad),
                       "paths": [p for p, _ in items], "pad": pad}
            return
        chunk: List = []
        for item in decoded():
            chunk.append(item)
            if len(chunk) == batch_size:
                yield _assemble_preprocessed(chunk, 0)
                chunk = []
        if chunk:
            yield _assemble_preprocessed(chunk, batch_size - len(chunk))


def _assemble_preprocessed(chunk, pad: int) -> Dict:
    """chunk items: (path, src_shape, preprocessed image)."""
    images = [img for _, _, img in chunk]
    images += [images[-1]] * pad
    out = {"images": np.stack(images),
           "paths": [p for p, _, _ in chunk],
           "shapes": [s for _, s, _ in chunk]}
    if pad:
        out["pad"] = pad
    return out


def train_batches(pairs: Sequence[Tuple[str, object]], *, class_names,
                  anchors, num_classes: int, net_size, batch_size: int,
                  rng: np.random.Generator, workers: int = 8,
                  shuffle: bool = True, size_for_batch=None,
                  augment_cfg=None, model_cfg=None,
                  resize: str = "letterbox", channels: int = 3
                  ) -> Iterator[Dict]:
    """(image, annotation) pairs -> fixed-shape train batches: images in
    [0, 1] and the encoded targets, by model_cfg's head kind
    (data.targets.encode_batch_for; without model_cfg, the region
    head's encode_batch from anchors and num_classes). One epoch, the
    remainder dropped. The annotation is a VOC XML path or a dict in
    parse_annotation's schema.

    size_for_batch(batch_idx) -> int | None switches the net size
    (darknet multi-scale); augment_cfg (data.augment.AugmentConfig)
    turns on jitter/flip/HSV per sample, each sample drawing from its
    own generator; resize="stretch" trains with the aspect-ignoring
    resize (normalized boxes need no transform). augment_cfg.mosaic
    makes each sample a 4-image mosaic at the net size (data.augment.
    mosaic4; resize does not act); augment_cfg.mixup blends each sample
    0.5/0.5 in float32 with a second random one after the resize and
    concatenates their truths. The generators are the JAX package's:
    (aug_base, idx) per sample, (aug_base, idx, 4) for the mosaic's
    picks and cut with (aug_base, idx, k) for its k-th image, and
    (aug_base, idx, 2) for mixup's pick with (aug_base, idx, 3) for its
    second image."""
    _check_resize(resize)
    order = np.arange(len(pairs))
    if shuffle:
        rng.shuffle(order)
    n_batches = len(order) // batch_size
    if n_batches == 0:
        raise ValueError(f"dataset has {len(pairs)} images but "
                         f"batch={batch_size} — need at least one "
                         f"full batch")
    aug_base = int(rng.integers(0, 2 ** 31))  # per-sample generators
    # warn once when the first batches keep no object because every
    # annotated name is outside the class list (a wrong names list)
    drop_stats = {"kept": 0, "unknown": 0, "warned": False}
    lock = threading.Lock()

    def load_sample(idx: int, rng_key):
        """The augmented (img, boxes, classes) of one dataset index."""
        img_path, ann = pairs[int(idx)]
        img = load_image(img_path, channels)
        if isinstance(ann, dict):
            keep = np.asarray(ann["difficult"]) == 0
            boxes, classes = ann["boxes"][keep], ann["classes"][keep]
        else:
            ann = parse_annotation(ann, class_names)
            boxes, classes = ann["boxes"], ann["classes"]
            with lock:
                drop_stats["kept"] += len(classes)
                drop_stats["unknown"] += ann.get("n_unknown", 0)
        if augment_cfg is not None:
            img, boxes, classes = augment(
                img, boxes, classes, np.random.default_rng(rng_key),
                augment_cfg)
        return img, boxes, classes

    def geom(idx: int, rng_key, size):
        """One sample through the resize -> (image, boxes, classes) in
        net space."""
        img, boxes, classes = load_sample(idx, rng_key)
        h, w = img.shape[:2]
        image = _host_resize(img, size, resize)
        if resize == "letterbox":
            boxes = letterbox_boxes(boxes, w, h, size)
        return image, boxes, classes

    def prepare(idx: int, size):
        idx = int(idx)
        if augment_cfg is not None and augment_cfg.mosaic:
            rng_m = np.random.default_rng((aug_base, idx, 4))
            picks = [idx] + [int(order[rng_m.integers(0, len(order))])
                             for _ in range(3)]
            samples = [load_sample(i, (aug_base, idx, k))
                       for k, i in enumerate(picks)]
            canvas, boxes, classes = mosaic4(samples, size, rng_m,
                                             augment_cfg)
            return canvas.astype(np.float32) / 255.0, boxes, classes
        if augment_cfg is not None and augment_cfg.mixup:
            rng_x = np.random.default_rng((aug_base, idx, 2))
            other = int(order[rng_x.integers(0, len(order))])
            img_a, box_a, cls_a = geom(idx, (aug_base, idx), size)
            img_b, box_b, cls_b = geom(other, (aug_base, idx, 3), size)
            image = 0.5 * img_a + 0.5 * img_b
            boxes = (np.concatenate([box_a, box_b])
                     if len(box_a) or len(box_b) else box_a)
            classes = (np.concatenate([cls_a, cls_b])
                       if len(cls_a) or len(cls_b) else cls_a)
            return image, boxes, classes
        return geom(idx, (aug_base, idx), size)

    size = net_size
    with _Pool(workers) as pool:
        for bi in range(n_batches):
            if size_for_batch is not None:
                size = size_for_batch(bi) or size
            idxs = order[bi * batch_size:(bi + 1) * batch_size]
            chunk = list(pool.map(lambda i: prepare(i, size), idxs))
            if (not drop_stats["warned"] and drop_stats["kept"] == 0
                    and drop_stats["unknown"] > 0):
                drop_stats["warned"] = True
                print(f"WARNING: the first {drop_stats['unknown']} "
                      "annotated objects were ALL dropped because their "
                      "class names are not in the model's class list — "
                      "training would see only background. Check the "
                      "class names against the dataset.", file=sys.stderr)
            yield _assemble(chunk, size, anchors, num_classes, model_cfg)


def _assemble(chunk, size, anchors, num_classes, model_cfg=None) -> Dict:
    """Stack one batch and encode its ground truth: by model_cfg's head
    kind, or for the region head from (anchors, num_classes)."""
    images = np.stack([c[0] for c in chunk])
    boxes, classes = [c[1] for c in chunk], [c[2] for c in chunk]
    nh, nw = tgt._as_hw(size)
    if model_cfg is not None:
        enc = tgt.encode_batch_for(model_cfg, boxes, classes,
                                   input_size=(nh, nw))
    else:
        enc = tgt.encode_batch(boxes, classes, grid=(nh // 32, nw // 32),
                               anchors=anchors, num_classes=num_classes)
    enc["images"] = images
    return enc
