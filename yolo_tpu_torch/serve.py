"""Serving endpoint for one device or a mesh of them: HTTP in, boxes or labels out (port
of yolo_tpu/serve.py).

POST /detect with an image body -> JSON detections (a detector); POST
/classify -> the top-5 classes (a classifier: resize_min + centre crop,
a tree classifier's leaf-masked absolute probabilities); GET /healthz for
liveness, GET /stats for counters (requests, batches, and the CUDA
kernels' launches in this process). Bodies are
  * ``Content-Type: application/x-npy``: a uint8 (H, W, C) array in .npy
    format, the form that needs no image decoder on the host;
  * anything else: image bytes (JPEG, PNG, BMP, PNM, TIFF, WebP),
    decoded by the host decoder that
    data.pipeline.set_decoder selects (the port's own by default,
    native/preproc.py; cv2 when asked for). A body that does not decode
    gets a 400.

Requests are micro-batched: a collector thread groups same-shape images
arriving within ``batch_window_ms`` (up to ``max_batch``) into one device
call; with a mesh (serve --dp) each call is split over its devices. The window adapts to load: queued backlog is drained without
waiting, and the timed wait engages only when the recent average batch
size (EWMA) says traffic is concurrent, so a lone client keeps batch-1
latency. PyTorch runs eagerly, so batches are not padded to compile
buckets.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NPY_CONTENT_TYPE = "application/x-npy"


class _Pending:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


def _decode_npy(data: bytes, channels: int) -> np.ndarray:
    """.npy body -> (H, W, channels) uint8; ValueError or EOFError on
    anything else (no pickles)."""
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != channels \
            or arr.shape[0] < 1 or arr.shape[1] < 1:
        raise ValueError(f"expected a uint8 (H, W, {channels}) array, got "
                         f"{arr.dtype} {arr.shape}")
    return arr


def _decode_image(data: bytes, gray: bool) -> Optional[np.ndarray]:
    """Image bytes (JPEG, PNG, BMP, PNM, TIFF, WebP) -> RGB (or gray)
    uint8 through the selected host decoder, as cv2.imdecode gives them;
    None when the bytes do not decode. Raises ImportError when
    the cv2 decoder is selected and cv2 is missing."""
    from yolo_tpu_torch.data import pipeline
    from yolo_tpu_torch.native.preproc import decode_image_bytes

    channels = 1 if gray else 3
    if pipeline.get_decoder() == "native":
        try:
            return decode_image_bytes(data, channels)
        except ValueError:
            return None
    cv2 = pipeline._cv2()
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    if img is None:
        return None
    return img[..., None] if gray else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _kernel_launches() -> Dict[str, int]:
    """The CUDA kernels' launch counts in this process (the wrappers'
    counters), for /stats."""
    from yolo_tpu_torch.ops.cuda import conv_kernel, entry_kernel, nms_kernel

    return {"nms": nms_kernel.launches, "conv": conv_kernel.launches,
            "entry": entry_kernel.launches}


def detections_to_json(out: Dict[str, torch.Tensor],
                       names) -> List[List[dict]]:
    """A detector's output -> the per-image result lists /detect returns."""
    # one device->host copy per output tensor
    valid_np = out["valid"].cpu().numpy()
    classes_np = out["classes"].cpu().numpy()
    scores_np = out["scores"].cpu().numpy()
    boxes_np = out["boxes"].cpu().numpy()
    return [[{
        "class": names[int(classes_np[bi][i])],
        "score": round(float(scores_np[bi][i]), 4),
        "box_xyxy": [round(float(v), 1) for v in boxes_np[bi][i]],
    } for i in np.nonzero(valid_np[bi])[0]] for bi in range(len(valid_np))]


class DetectionServer:
    def __init__(self, cfg, params, *, host: str = "127.0.0.1",
                 port: int = 8000, batch_window_ms: float = 5.0,
                 max_batch: int = 32, adaptive_window: bool = True,
                 conf_threshold: Optional[float] = None,
                 request_timeout: float = 120.0, mesh=None,
                 resize: str = "letterbox", use_tree_map: bool = False,
                 hier_thresh: Optional[float] = None):
        """``params``: the Darknet module (yolo_tpu_torch.load(...).params);
        the compute dtype is its own. use_tree_map / hier_thresh: a
        YOLO9000 tree detector's decode. mesh (parallel/sharding.py's
        make_mesh): each batch is split over the mesh's devices, one
        replica of the params on each; batches are padded to a multiple
        of the mesh size by repeating their last image, so that every
        shard is equal and non-empty, and max_batch is at least that
        size."""
        from yolo_tpu_torch.models.classify import make_classifier
        from yolo_tpu_torch.models.predict import make_detector
        from yolo_tpu_torch.parallel import sharding as shd

        if mesh is not None and not isinstance(mesh, shd.Mesh):
            raise TypeError(f"mesh must be a parallel.sharding.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        self.cfg = cfg
        self.mesh = mesh
        # batches are padded to a multiple of this (the mesh size)
        self._min_bucket = 1 if mesh is None else len(mesh)
        max_batch = max(max_batch, self._min_bucket)
        self.params = params if mesh is None else shd.replicate(mesh, params)
        self.host, self.port = host, port
        self.batch_window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.adaptive_window = adaptive_window
        self._ewma_batch = 1.0  # recent average batch size
        self.request_timeout = request_timeout
        self.is_classifier = cfg.head_kind == "softmax"
        det_kw = dict(conf_threshold=conf_threshold, resize=resize,
                      use_tree_map=use_tree_map, hier_thresh=hier_thresh)
        if self.is_classifier:
            self._classifier = (make_classifier(cfg) if mesh is None else
                                shd.make_dp_classifier(cfg, mesh))
        elif mesh is None:
            self._detector = make_detector(cfg, **det_kw)
        else:
            self._detector = shd.make_dp_detector(cfg, mesh, **det_kw)
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._stop = threading.Event()
        self._det_names = cfg.detection_names(use_tree_map)
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "max_batch_seen": 0, "window_skips": 0,
                      "ewma_batch": 1.0, "buckets": {}}

    # -- batching ----------------------------------------------------------

    def _window(self) -> float:
        """Collection wait for the current batch: wait only when recent
        traffic was concurrent."""
        if not self.adaptive_window:
            return self.batch_window
        return self.batch_window if self._ewma_batch >= 1.5 else 0.0

    def _collect(self) -> List[_Pending]:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        # greedy drain: queued backlog batches immediately, no timer
        while len(batch) < self.max_batch:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)
                return batch
            batch.append(item)

        window = self._window()
        if window > 0 and len(batch) < self.max_batch:
            deadline_t = time.monotonic() + window
            while len(batch) < self.max_batch:
                remaining = deadline_t - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._q.put(None)
                    break
                batch.append(item)
        elif window == 0:
            self.stats["window_skips"] += 1

        self._ewma_batch += 0.2 * (len(batch) - self._ewma_batch)
        self.stats["ewma_batch"] = round(self._ewma_batch, 3)
        return batch

    def _worker(self) -> None:
        try:
            self._worker_loop()
        finally:
            # fail any requests still queued when the worker exits
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item.error = "server shutting down"
                    item.event.set()

    def _run_batch(self, items: List[_Pending]) -> None:
        arrays = [i.image for i in items]
        # under a mesh: a multiple of its size, the last image repeated
        arrays += [arrays[-1]] * (-len(arrays) % self._min_bucket)
        bucket = str(len(arrays))
        self.stats["buckets"][bucket] = self.stats["buckets"].get(bucket,
                                                                  0) + 1
        images = torch.from_numpy(np.stack(arrays))
        if self.mesh is None:
            images = images.to(self.params.device)
        if self.is_classifier:
            from yolo_tpu_torch.models.classify import (hierarchy_leaf_probs,
                                                        top_k)

            with torch.no_grad():
                probs = self._classifier(self.params, images).cpu().numpy()
            probs = probs[:len(items)]
            if self.cfg.softmax_tree is not None:
                probs = hierarchy_leaf_probs(probs, self.cfg.softmax_tree)
            for item, p in zip(items, probs):
                item.result = [{"class": name, "prob": round(pr, 6)}
                               for name, pr in top_k(p, self.cfg.class_names)]
            return
        out = self._detector(self.params, images)
        for item, result in zip(items, detections_to_json(out,
                                                          self._det_names)):
            item.result = result

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                return
            # one device call per source-shape bucket
            buckets: Dict[Tuple[int, int], List[_Pending]] = {}
            for item in batch:
                buckets.setdefault(item.image.shape[:2], []).append(item)
            for items in buckets.values():
                self.stats["batches"] += 1
                self.stats["requests"] += len(items)
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], len(items))
                try:
                    self._run_batch(items)
                except Exception as e:  # surface to the waiting requests
                    self.stats["errors"] += len(items)
                    for item in items:
                        item.error = f"{type(e).__name__}: {e}"
                for item in items:
                    item.event.set()

    # -- http --------------------------------------------------------------

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "model": server.cfg.name})
                elif self.path == "/stats":
                    self._send(200, {**server.stats,
                                     "kernel_launches": _kernel_launches()})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                want = "/classify" if server.is_classifier else "/detect"
                if self.path != want:
                    if self.path in ("/detect", "/classify"):
                        self._send(400, {"error": f"{server.cfg.name} "
                                         f"serves {want}"})
                    else:
                        self._send(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._send(400, {"error": "bad Content-Length"})
                    return
                data = self.rfile.read(length)
                channels = server.cfg.in_channels
                ctype = self.headers.get("Content-Type", "")
                if ctype.split(";")[0].strip() == NPY_CONTENT_TYPE:
                    try:
                        rgb = _decode_npy(data, channels)
                    except (ValueError, EOFError) as e:
                        self._send(400, {"error": f"bad .npy body: {e}"})
                        return
                else:
                    try:
                        rgb = _decode_image(data, gray=channels == 1)
                    except ImportError:
                        self._send(415, {"error": "no image decoder on "
                                         f"this host; send {NPY_CONTENT_TYPE}"})
                        return
                    if rgb is None:
                        self._send(400, {"error": "cannot decode image"})
                        return
                if server.is_classifier:
                    from yolo_tpu_torch.models.classify import (
                        classifier_preprocess)

                    rgb = classifier_preprocess(rgb, server.cfg.input_hw)
                pending = _Pending(rgb)
                server._q.put(pending)
                # bounded wait: a dead/stopped worker must yield 503,
                # not a forever-blocked handler thread
                if not pending.event.wait(timeout=server.request_timeout):
                    self._send(503, {"error": "detection timed out"})
                elif pending.error is not None:
                    self._send(500, {"error": pending.error})
                elif server.is_classifier:
                    self._send(200, {"classes": pending.result})
                else:
                    self._send(200, {"detections": pending.result})

        return Handler

    def start(self) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler_class())
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._worker_thread = threading.Thread(target=self._worker,
                                               daemon=True)
        self._worker_thread.start()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._serve_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if getattr(self, "_worker_thread", None) is not None:
            self._worker_thread.join(timeout=self.request_timeout)

    def wait(self) -> None:
        """Block until the started server's HTTP loop ends."""
        self._serve_thread.join()

    def serve_forever(self) -> None:
        self.start()
        try:
            self.wait()
        except KeyboardInterrupt:
            self.stop()
