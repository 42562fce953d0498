"""Per-step metrics logging (port of yolo_tpu/utils/metrics.py): JSON
lines to a file and to stderr, each loss part on its own key."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Dict, Optional

import torch


def _host_values(metrics: Dict) -> Dict:
    """Tensors -> Python floats in one device-to-host copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return dict(metrics)
    values = torch.stack([metrics[k].detach().float().reshape(())
                          for k in keys]).cpu().tolist()
    return {**metrics, **dict(zip(keys, values))}


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stdout: bool = True,
                 every: int = 1):
        self._file: Optional[IO] = open(path, "a") if path else None
        self._stdout = stdout
        self._every = max(every, 1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict, force: bool = False,
            **extra) -> None:
        """force=True logs outside the every-N sampling (validation
        mAP)."""
        if step % self._every and not force:
            return
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in {**_host_values(metrics), **extra}.items():
            try:
                rec[k] = round(float(v), 6)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stdout:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
