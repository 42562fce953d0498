"""yolo_tpu_torch — the PyTorch/CUDA port of yolo_tpu, for one NVIDIA
H100 (sm_90a).

The JAX package ``yolo_tpu`` stays the reference; this package imports
nothing of it (its configs and darknet weights I/O are ported under
``configs/`` and ``io/``) and never imports ``jax``. Plain tensor code is PyTorch; each Pallas kernel
of the JAX package on the ported path has a hand-written CUDA kernel
under ``csrc/``, built by ``ops/cuda/build.py`` at first use.

    import yolo_tpu_torch
    model = yolo_tpu_torch.load("yolov2.weights", "coco")   # device="cuda"
    model = yolo_tpu_torch.load("my.weights", cfg="my.cfg",
                                names="my.names")        # a darknet .cfg
    detections = model(images_u8)            # (B, H, W, 3) raw RGB
    clf = yolo_tpu_torch.load("darknet53.weights", "darknet53")
    labels = clf(images_u8)                  # top-5 (name, prob) an image
"""

__version__ = "0.1.0"


def load(*args, **kw):
    """See yolo_tpu_torch.api.load — weights file (with an optional
    darknet .cfg / .names, or a zoo:// entry) -> callable detector or
    classifier."""
    from yolo_tpu_torch.api import load as _load

    return _load(*args, **kw)


def load_classifier(*args, **kw):
    """See yolo_tpu_torch.api.load_classifier — classifier weights ->
    callable top-k model."""
    from yolo_tpu_torch.api import load_classifier as _load

    return _load(*args, **kw)
