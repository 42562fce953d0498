"""fp32 convolutions and products without TF32, as the JAX package's
fp32 path (Precision.HIGHEST). cuDNN runs fp32 convs in TF32 by default
and the flags are process-wide."""

from __future__ import annotations

import contextlib
import threading

import torch


class _NoTF32:
    """Keeps TF32 off in cuDNN and cuBLAS while any fp32 forward runs.
    The flags are process-wide, so overlapping forwards (the server's
    worker thread and a caller's) share one save/restore, counted under
    a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = (True, False)

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32) = self._saved


no_tf32 = _NoTF32()


def exact_for(dtype):
    """The precision context of a conv computing in ``dtype``: TF32 off
    for fp32; nothing for bf16, whose values TF32 holds exactly."""
    return no_tf32() if dtype == torch.float32 else contextlib.nullcontext()
