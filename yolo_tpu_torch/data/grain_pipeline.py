"""The grain loader of the JAX package (yolo_tpu/data/grain_pipeline.py)
without grain: the batches, the worker processes and the checkpoint
state of a grain 0.2.15 DataLoader over an IndexSampler, written anew.

  * Record order: the sampler's global index g (0, 1, ..., num_epochs *
    n - 1) maps to record index_shuffle(g % n, n - 1, seed + g // n),
    grain's MapDataset.range(n).shuffle(seed), reshuffled each epoch;
    index_shuffle is grain's C++ one (a Simon block cipher keyed by
    std::seed_seq, cycle-walked into [0, n): _epoch_order).
  * Per-record rng: np.random.Generator(np.random.Philox(key=seed + g)),
    which the darknet augmentations draw from (_prepare).
  * worker_count = W > 0: W worker processes (the spawn start method, as
    the parent may hold CUDA); worker w takes the global indices w, w +
    W, ... and batches them itself, dropping its own remainder; the
    loader reads the workers round robin, starting after the last one it
    read. worker_count = 0 batches in this process.
  * State: grain's JSON bytes ("version", "last_seen_indices",
    "last_worker_index", "worker_count", "sampler", "data_source"); a
    state written by the JAX package's loader restores here and the
    other way round, and a state of another data source (JAX's content
    hash of the paths), sampler or worker count is refused.

CheckpointableGrainIterator keeps the states of the last 16 pulls, so
the position of the last consumed batch can be saved behind a
DevicePrefetcher; MultiScaleGrainIterator keeps one loader per size
bucket (at most 4, least recently used first out) and carries the
position across buckets. `train --loader grain` selects this loader.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import json
import math
import multiprocessing as mp
import queue as queue_mod
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# grain's index_shuffle (its C++ one, grain/_src/python/experimental/
# index_shuffle; the pure-Python Feistel file beside it orders otherwise)

_M32 = 0xFFFFFFFF


def _seed_seq(seed: int, n: int) -> list:
    """std::seed_seq{seed}.generate of n 32-bit words (C++11
    [rand.util.seedseq])."""
    v = [int(seed) & _M32]
    s = len(v)
    b = [0x8B8B8B8B] * n
    if n == 0:
        return b
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39
         else 3 if n >= 7 else (n - 1) // 2)
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def tt(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * tt(b[k % n] ^ b[(k + p) % n]
                           ^ b[(k - 1) % n])) & _M32
        if k == 0:
            r2 = (r1 + s) & _M32
        elif k <= s:
            r2 = (r1 + k % n + v[k - 1]) & _M32
        else:
            r2 = (r1 + k % n) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * tt((b[k % n] + b[(k + p) % n]
                               + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


@functools.lru_cache(maxsize=8)
def _epoch_order(n: int, seed: int) -> np.ndarray:
    """grain's index_shuffle(i, max_index=n - 1, seed, rounds=4) for
    every i in [0, n): where each index lands in a pseudorandom
    permutation of [0, n). The block is ceil(log2(n - 1)) bits, made
    even, at least 16; the Simon Feistel network on its two w-bit halves
    takes one key a half round, f(r) = (rotl1 r & rotl8 r) ^ rotl2 r;
    an index is encrypted again until it falls below n (cycle walking).
    Computed at once: the cipher on its whole domain, then every index
    walked through that table (from a small n through a 2^16 domain the
    walk takes thousands of steps an index)."""
    if n == 1:
        return np.zeros(1, np.int64)
    block = int(math.ceil(math.log2(n - 1)))
    w = max(block + block % 2, 16) // 2
    keys = _seed_seq(seed, 4)
    mask = np.uint64((1 << w) - 1)
    x = np.arange(1 << (2 * w), dtype=np.uint64)

    def rotl(v, r):
        return ((v << np.uint64(r)) | (v >> np.uint64(w - r))) & mask

    left, right = (x >> np.uint64(w)) & mask, x & mask
    for i in range(0, len(keys), 2):
        left ^= (rotl(right, 1) & rotl(right, 8)) ^ rotl(right, 2)
        left ^= np.uint64(keys[i]) & mask
        right ^= (rotl(left, 1) & rotl(left, 8)) ^ rotl(left, 2)
        right ^= np.uint64(keys[i + 1]) & mask
    table = ((left << np.uint64(w)) | right).astype(np.int64)
    # an index past the domain (n - 1 a power of two) loses its high
    # bits, as in grain's fixed-width block
    out = table[np.arange(n) & (len(table) - 1)]
    out_of_range = out >= n
    while out_of_range.any():
        out[out_of_range] = table[out[out_of_range]]
        out_of_range = out >= n
    return out


# ---------------------------------------------------------------------------
# the sampler and the data source


class _IndexSampler:
    """grain's IndexSampler(num_records, NoSharding(), shuffle=True,
    num_epochs, seed): its checks, its repr and its records."""

    def __init__(self, num_records: int, num_epochs: Optional[int],
                 seed: int):
        if num_records <= 0:
            raise ValueError(
                "Invalid number of records in Sampler. "
                f"Got {num_records} records, but number of records "
                "must be greater than 0.")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError(
                "Invalid number of epochs in Index Sampler."
                f"Got {num_epochs} epochs, but number of epochs "
                "must be greater than 0.")
        if not isinstance(seed, (int, np.integer)):
            raise TypeError(f"Expected seed of int type. Got seed with "
                            f"type {type(seed)}")
        seed = int(seed)
        if seed < 0 or seed.bit_length() > 32:
            raise ValueError("Seed should be positive 32-bit integer.")
        self.n = int(num_records)
        self.num_epochs = num_epochs
        self.seed = seed
        self.max_index = (None if num_epochs is None
                          else int(num_epochs) * self.n)

    def __repr__(self) -> str:
        return (f"IndexSampler(num_records={self.n}, shard_options="
                f"NoSharding(shard_index=0, shard_count=1, "
                f"drop_remainder=False), shuffle=True, "
                f"num_epochs={self.num_epochs}, seed={self.seed})")

    def record_key(self, index: int) -> int:
        epoch, i = divmod(int(index), self.n)
        return int(_epoch_order(self.n, (self.seed + epoch) % 2 ** 32)[i])

    def rng(self, index: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(key=self.seed + index))


def _source_repr(pairs) -> str:
    """The JAX loader's data-source repr: a hash of the paths, each
    NUL-terminated, so a state of another list is refused."""
    h = hashlib.sha256()
    for p, _ in pairs:
        h.update(str(p).encode() + b"\0")
    return f"yolo_tpu._Source(n={len(pairs)}, paths_sha={h.hexdigest()[:16]})"


# ---------------------------------------------------------------------------
# records


def _load_raw(sample, *, class_names, augment_cfg=None, rng=None,
              channels: int = 3):
    """(image_path, annotation) -> raw augmented (img_u8, boxes,
    classes): the per-sample half of the plain, mosaic and mixup paths."""
    from yolo_tpu_torch.data.pipeline import load_image
    from yolo_tpu_torch.data.voc import parse_annotation

    img_path, ann = sample
    img = load_image(img_path, channels)
    if isinstance(ann, dict):
        keep = np.asarray(ann["difficult"]) == 0
        boxes, classes = ann["boxes"][keep], ann["classes"][keep]
    else:
        ann = parse_annotation(ann, class_names)
        boxes, classes = ann["boxes"], ann["classes"]
    if augment_cfg is not None:
        from yolo_tpu_torch.data.augment import augment

        img, boxes, classes = augment(img, boxes, classes, rng, augment_cfg)
    return img, boxes, classes


def _prepare(sample, *, class_names, anchors, num_classes, net_size,
             model_cfg=None, augment_cfg=None, rng=None,
             resize="letterbox", all_pairs=None, channels: int = 3):
    """(image_path, annotation) -> one fixed-shape training record.
    Mosaic and mixup draw their 3 (resp. 1) partners from ``all_pairs``
    with the record's own rng, so a record depends on its index alone."""
    from yolo_tpu_torch.data import targets as tgt
    from yolo_tpu_torch.data.pipeline import _host_resize, letterbox_boxes
    from yolo_tpu_torch.native.preproc import letterbox_batch
    from yolo_tpu_torch.ops.letterbox import as_hw

    nh, nw = as_hw(net_size)

    def geometry(img, boxes):
        """source-space (img_u8, boxes) -> net-space (float img, boxes)."""
        h, w = img.shape[:2]
        if resize == "stretch":
            # AlexeyAB letter_box=0: normalized boxes unchanged
            return _host_resize(img, (nh, nw), "stretch"), boxes
        image = letterbox_batch(img[None], (nh, nw), n_threads=1)[0]
        return image, letterbox_boxes(boxes, w, h, (nh, nw))

    def raw(s):
        return _load_raw(s, class_names=class_names, augment_cfg=augment_cfg,
                         rng=rng, channels=channels)

    if augment_cfg is not None and augment_cfg.mosaic:
        from yolo_tpu_torch.data.augment import mosaic4

        picks = [sample] + [all_pairs[int(rng.integers(len(all_pairs)))]
                            for _ in range(3)]
        samples = [raw(p) for p in picks]
        canvas, boxes, classes = mosaic4(samples, (nh, nw), rng, augment_cfg)
        image = canvas.astype(np.float32) / 255.0
    elif augment_cfg is not None and augment_cfg.mixup:
        # AlexeyAB mixup=1: a 0.5 / 0.5 blend with one random partner,
        # truths concatenated, blended after the geometry
        other = all_pairs[int(rng.integers(len(all_pairs)))]
        img_a, box_a, cls_a = raw(sample)
        img_b, box_b, cls_b = raw(other)
        im_a, box_a = geometry(img_a, box_a)
        im_b, box_b = geometry(img_b, box_b)
        image = 0.5 * im_a + 0.5 * im_b
        boxes = (np.concatenate([box_a, box_b])
                 if len(box_a) or len(box_b) else box_a)
        classes = (np.concatenate([cls_a, cls_b])
                   if len(cls_a) or len(cls_b) else cls_a)
    else:
        img, boxes, classes = raw(sample)
        image, boxes = geometry(img, boxes)
    if model_cfg is not None:
        enc = tgt.encode_for(model_cfg, boxes, classes, input_size=(nh, nw))
    else:
        enc = tgt.encode(boxes, classes, grid=(nh // 32, nw // 32),
                         anchors=anchors, num_classes=num_classes)
    enc["images"] = image
    return enc


def _make_batch(values):
    """grain's Batch: every leaf stacked on a new leading axis."""
    if len(values) == 1:
        return {k: np.expand_dims(v, 0) for k, v in values[0].items()}
    return {k: np.stack([v[k] for v in values]) for k in values[0]}


class _Spec:
    """What a loader (and each of its worker processes) needs to make a
    batch of its own: the pairs, the sampler, the record options. Holds
    only picklable values."""

    def __init__(self, pairs, sampler: _IndexSampler, batch_size: int,
                 augment_cfg, record_kw: dict):
        self.pairs = pairs
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.augment_cfg = augment_cfg
        self.record_kw = record_kw

    def record(self, index: int):
        pair = self.pairs[self.sampler.record_key(index)]
        if self.augment_cfg is None:
            return _prepare(pair, **self.record_kw)
        return _prepare(pair, augment_cfg=self.augment_cfg,
                        rng=self.sampler.rng(index), **self.record_kw)

    def batch(self, w: int, workers: int, local: int):
        """Batch of worker w (of ``workers``; 0 for in-process) from its
        local record ``local``: None where it would run past the end."""
        step = max(workers, 1)
        idx = [w + step * (local + j) for j in range(self.batch_size)]
        end = self.sampler.max_index
        if end is not None and idx[-1] >= end:
            return None
        return _make_batch([self.record(g) for g in idx])


def _put(out, item, stop) -> None:
    """Put item into a worker's queue unless the loader stops first."""
    while not stop.is_set():
        try:
            out.put(item, timeout=0.1)
            return
        except queue_mod.Full:
            continue


def _worker_main(spec: _Spec, w: int, workers: int, local: int,
                 out, stop) -> None:
    """A worker process: its batches, in order, into ``out`` (the local
    index after each), then None; a loader that stops it gets nothing
    more, and the process exits without waiting to flush the queue."""
    try:
        import torch

        torch.set_num_threads(1)
        while not stop.is_set():
            b = spec.batch(w, workers, local)
            if b is None:
                break
            local += spec.batch_size
            _put(out, (b, local), stop)
        _put(out, None, stop)
    except BaseException as e:  # surfaced in the parent's next()
        _put(out, ("error", f"{type(e).__name__}: {e}"), stop)
    finally:
        if stop.is_set():
            out.cancel_join_thread()


class _LoaderIterator:
    """A grain DataLoader iterator over a _Spec: batches, get_state and
    set_state (JSON bytes, grain's format and checks)."""

    def __init__(self, spec: _Spec, worker_count: int, source_repr: str):
        if worker_count < 0:
            raise ValueError("Worker count should be greater than or equal "
                             f"zero.Current worker_count is {worker_count}.")
        self._spec = spec
        self._workers = int(worker_count)
        self._source = source_repr
        self._next = [0] * max(self._workers, 1)   # local next index
        self._last_worker = -1
        self._procs = None

    # -- grain's state -----------------------------------------------------

    def get_state(self) -> bytes:
        n = max(self._workers, 1)
        state = {
            "version": 2,
            "last_seen_indices": {str(i): -n + i + self._next[i] * n
                                  for i in range(n)},
            "last_worker_index": self._last_worker,
            "worker_count": self._workers,
            "sampler": repr(self._spec.sampler),
            "data_source": self._source,
        }
        return json.dumps(state, indent=4).encode()

    def set_state(self, state: bytes) -> None:
        st = json.loads(state.decode())
        if st["worker_count"] != self._workers:
            raise ValueError(
                "Worker count in checkpoint does not match dataloader "
                f"worker count.\nworker count in checkpoint: "
                f"{st['worker_count']}\nworker count in dataloader: "
                f"{self._workers}")
        if st["sampler"] != repr(self._spec.sampler):
            raise ValueError(
                "Sampler in checkpoint does not match dataloader sampler.\n"
                f"sampler in checkpoint: {st['sampler']}\n"
                f"sampler in dataloader: {self._spec.sampler!r}")
        if st["data_source"] != self._source:
            raise ValueError(
                "DataSource in checkpoint does not match datasource in "
                f"dataloader.\ndata source in checkpoint: "
                f"{st['data_source']}\ndata source in dataloader: "
                f"{self._source}")
        self.close()
        n = max(self._workers, 1)
        seen = st["last_seen_indices"]
        self._next = [(seen[str(i)] + n - i) // n for i in range(n)]
        self._last_worker = st["last_worker_index"]

    # -- batches -------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._workers == 0:
            b = self._spec.batch(0, 0, self._next[0])
            if b is None:
                raise StopIteration
            self._next[0] += self._spec.batch_size
            return b
        if self._procs is None:
            self._start()
        w_count = self._workers
        w = (self._last_worker + 1) % w_count
        while len(self._done) < w_count:
            if w in self._done:
                w = (w + 1) % w_count
                continue
            item = self._get(w)
            if item is None:
                self._done.add(w)
                w = (w + 1) % w_count
                continue
            if isinstance(item, tuple) and item and item[0] == "error":
                self.close()
                raise RuntimeError(f"grain loader worker {w}: {item[1]}")
            batch, local = item
            self._next[w] = local
            self._last_worker = w
            return batch
        raise StopIteration

    def _get(self, w: int):
        while True:
            try:
                return self._queues[w].get(timeout=1.0)
            except queue_mod.Empty:
                if not self._procs[w].is_alive():
                    try:
                        return self._queues[w].get(timeout=1.0)
                    except queue_mod.Empty:
                        code = self._procs[w].exitcode
                        self.close()
                        raise RuntimeError(
                            f"grain loader worker {w} exited with code "
                            f"{code}") from None

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._stop = ctx.Event()
        self._queues = [ctx.Queue(maxsize=1) for _ in range(self._workers)]
        self._done = set()
        self._procs = []
        for w in range(self._workers):
            p = ctx.Process(target=_worker_main, daemon=True,
                            args=(self._spec, w, self._workers,
                                  self._next[w], self._queues[w],
                                  self._stop))
            p.start()
            self._procs.append(p)

    def close(self) -> None:
        """Stop the worker processes (they restart at the current
        position on the next pull)."""
        if self._procs is None:
            return
        self._stop.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except (queue_mod.Empty, OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in self._queues:
            q.cancel_join_thread()
            q.close()
        self._procs = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the checkpointable iterators (JAX's classes)


class CheckpointableGrainIterator:
    """Iterator over grain batches with checkpoint/resume support.

    Before every pull it records (pull_index, iterator_state);
    state_for_pull(k) returns the state that, restored with set_state,
    gives batch k onward. Behind a prefetcher, when the training loop
    has consumed n batches the loader has been pulled n + depth times:
    checkpointing state_for_pull(n) resumes right after the last trained
    batch."""

    def __init__(self, it, history: int = 16):
        self._it = it
        self._states = collections.deque(maxlen=history)
        self._pulls = 0
        # a DevicePrefetcher pulls from its thread while the training
        # loop checkpoints from the main thread
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            self._states.append((self._pulls, self._it.get_state()))
            self._pulls += 1
            return next(self._it)

    @property
    def pulls(self) -> int:
        return self._pulls

    def state_for_pull(self, k: int) -> bytes:
        """State that regenerates batch k onward (k = batches consumed
        since construction or the last set_state); only the last
        ``history`` pull states are kept."""
        with self._lock:
            if k == self._pulls:  # checkpoint at the exact frontier
                return self._it.get_state()
            return self._history_state_locked(k)

    def _history_state_locked(self, k: int) -> bytes:
        for i, s in self._states:
            if i == k:
                return s
        raise KeyError(
            f"no recorded state for pull {k} (have "
            f"{[i for i, _ in self._states]}; history too short or "
            f"batch already evicted)")

    def get_state(self) -> bytes:
        with self._lock:
            return self._it.get_state()

    def set_state(self, state: bytes) -> None:
        with self._lock:
            self._it.set_state(state)
            # pull counting restarts: state_for_pull(k) counts from the
            # last restore
            self._states.clear()
            self._pulls = 0

    def close(self) -> None:
        """Stop the loader's worker processes."""
        with self._lock:
            if self._it is not None:
                self._it.close()


class MultiScaleGrainIterator(CheckpointableGrainIterator):
    """Multi-scale training under grain: one loader per size bucket,
    sharing one sampler position carried across buckets through the
    loader state (which holds the data source and sampler, not the
    record options, so a state moves between buckets).

    ``size_at(absolute_batch_index) -> net size`` must be random-access
    deterministic (train.loop.pick_scale_indexed): on resume the train
    command restores the position with set_state and sets ``base`` to
    the resumed step, and the next pull builds that step's bucket. At
    most 4 buckets are kept (each may hold worker processes), least
    recently used first out; buckets are built at their first pull."""

    _MAX_CACHED = 4

    def __init__(self, make_iter, size_at, net_size=None, history=16):
        self._make = make_iter
        self._size_at = size_at
        self.base = 0            # absolute index of pull 0 (resume)
        self._net_size = net_size
        self._cache = collections.OrderedDict()
        self._size = None
        self._pending_state = None
        super().__init__(None, history)

    @property
    def current_size(self):
        return self._size

    def _bucket(self, size):
        key = _size_key(size)
        it = self._cache.get(key)
        if it is None:
            it = self._make(size)
            self._cache[key] = it
            if len(self._cache) > self._MAX_CACHED:
                _, old = self._cache.popitem(last=False)
                old.close()
        else:
            self._cache.move_to_end(key)
        return it

    def _ensure_locked(self, size=None):
        """Build the first bucket on demand (and apply a state restored
        before any pull)."""
        if self._it is not None:
            return
        if size is None:
            size = self._size_at(self.base)
            if size is None:
                size = self._net_size
        self._it = self._bucket(size)
        self._size = size
        if self._pending_state is not None:
            self._it.set_state(self._pending_state)
            self._pending_state = None

    def __next__(self):
        with self._lock:
            size = self._size_at(self.base + self._pulls)
            if size is None:
                size = (self._size if self._size is not None
                        else self._net_size)
            if self._it is None:
                self._ensure_locked(size)
            elif _size_key(size) != _size_key(self._size):
                st = self._it.get_state()
                nxt = self._bucket(size)
                nxt.set_state(st)       # position carries across
                self._it = nxt
                self._size = size
            self._states.append((self._pulls, self._it.get_state()))
            self._pulls += 1
            return next(self._it)

    def get_state(self) -> bytes:
        with self._lock:
            if self._it is None and self._pending_state is not None:
                return self._pending_state
            self._ensure_locked()
            return self._it.get_state()

    def set_state(self, state: bytes) -> None:
        with self._lock:
            if self._it is None:
                # applied when the first pull picks its bucket
                self._pending_state = state
            else:
                self._it.set_state(state)
            self._states.clear()
            self._pulls = 0

    def state_for_pull(self, k: int) -> bytes:
        with self._lock:
            if k == self._pulls:        # the exact frontier
                if self._it is None and self._pending_state is not None:
                    return self._pending_state
                self._ensure_locked()
                return self._it.get_state()
            return self._history_state_locked(k)

    def close(self) -> None:
        with self._lock:
            for it in self._cache.values():
                it.close()


def _size_key(size):
    """int and (h, w) sizes hash alike (416 == (416, 416))."""
    from yolo_tpu_torch.ops.letterbox import as_hw

    return as_hw(size)


def grain_train_batches(pairs: Sequence[Tuple[str, object]], *,
                        class_names, anchors, num_classes: int,
                        net_size, batch_size: int, seed: int = 0,
                        num_epochs: Optional[int] = 1,
                        worker_count: int = 0, model_cfg=None,
                        augment_cfg=None,
                        resize: str = "letterbox",
                        channels: int = 3,
                        size_for_batch=None
                        ) -> CheckpointableGrainIterator:
    """Train batches with the schema of pipeline.train_batches, the
    JAX package's grain loader's batches for the same pairs and seed.

    worker_count=0 runs in this process; > 0 spawns worker processes
    (the entry script must be importable: a file with an ``if __name__
    == "__main__"`` guard). num_epochs=None repeats forever.
    augment_cfg enables the darknet augmentations per record, mosaic and
    mixup through seeded partner draws (_prepare). size_for_batch
    (absolute batch index -> net size, random-access deterministic:
    train.loop.pick_scale_indexed) gives a MultiScaleGrainIterator."""
    sampler = _IndexSampler(len(pairs), num_epochs, seed)
    source = _source_repr(pairs)
    pairs = list(pairs)

    def build(size):
        kw = dict(class_names=class_names,
                  anchors=np.asarray(anchors, np.float32),
                  num_classes=num_classes, net_size=size,
                  model_cfg=model_cfg, resize=resize, channels=channels)
        if augment_cfg is not None and (augment_cfg.mosaic
                                        or augment_cfg.mixup):
            kw["all_pairs"] = pairs
        spec = _Spec(pairs, sampler, batch_size, augment_cfg, kw)
        return _LoaderIterator(spec, worker_count, source)

    if size_for_batch is not None:
        return MultiScaleGrainIterator(build, size_for_batch,
                                       net_size=net_size)
    return CheckpointableGrainIterator(build(net_size))
