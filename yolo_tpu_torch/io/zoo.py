"""Pretrained-weights zoo: manifest, exact-size and SHA-256 checks (port
of yolo_tpu/io/zoo.py).

``zoo://<name>`` names an entry of ``zoo_manifest.json`` (a copy of the
JAX package's): its file name, byte size, variant and public URL. The
file is looked up under ``$YOLO_TPU_WEIGHTS_DIR`` (default
``~/.cache/yolo_tpu``), as in the JAX package. Nothing is fetched: an
absent file raises FileNotFoundError with its path and the URL to fetch
it from by hand.

Two integrity layers:

* exact byte size, from the variant's layer topology
  (``expected_weights_bytes``);
* SHA-256, checked where the manifest pins one; ``record_sha`` pins it
  on first use (trust on first use).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Sequence

from yolo_tpu_torch.configs.specs import LayerSpec

_MANIFEST_PATH = os.path.join(os.path.dirname(__file__),
                              "zoo_manifest.json")


def expected_weights_bytes(layers: Sequence[LayerSpec],
                           input_channels: int = 3) -> int:
    """Exact .weights file size for a layer topology, with the 20-byte
    header (darknet parse.c layout: per conv, (4 BN terms | 1 bias) x oc
    + oc*ic/groups*k*k floats; per weighted shortcut its blend
    weights)."""
    from yolo_tpu_torch.io.darknet_weights import expected_bytes

    return expected_bytes(layers, input_channels)


def infer_variant(weights_path: str) -> Optional[str]:
    """The built-in variant whose topology gives the file's byte size
    (16- and 20-byte headers both accepted), else None (a custom class
    count, say); the first VARIANTS entry wins a tie."""
    from yolo_tpu_torch.configs.variants import VARIANTS

    actual = os.path.getsize(weights_path)
    for name, cfg in VARIANTS.items():
        want = expected_weights_bytes(cfg.layers, cfg.in_channels)
        if actual in (want, want - 4):
            return name
    return None


def load_manifest(path: Optional[str] = None) -> Dict[str, Dict]:
    with open(path or _MANIFEST_PATH) as f:
        return json.load(f)


def save_manifest(manifest: Dict[str, Dict],
                  path: Optional[str] = None) -> None:
    with open(path or _MANIFEST_PATH, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def weights_dir() -> str:
    return os.environ.get(
        "YOLO_TPU_WEIGHTS_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "yolo_tpu"))


def resolve(spec: str, manifest: Optional[Dict[str, Dict]] = None,
            manifest_path: Optional[str] = None) -> str:
    """``zoo://<name>`` -> verified local file path. Raises KeyError for
    an unknown name, FileNotFoundError (with the public URL) for an
    absent file and ValueError on any integrity failure."""
    name = spec[len("zoo://"):] if spec.startswith("zoo://") else spec
    manifest = manifest or load_manifest(manifest_path)
    if name not in manifest:
        raise KeyError(f"unknown zoo entry '{name}' "
                       f"(have: {', '.join(sorted(manifest))})")
    entry = manifest[name]
    path = os.path.join(weights_dir(), entry["filename"])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"weights file not found: {path}\n"
            f"download it first:  curl -o '{path}' '{entry['url']}'\n"
            f"(or set YOLO_TPU_WEIGHTS_DIR)")
    problems = verify_file(path, entry)
    if problems:
        raise ValueError(f"integrity check failed for {path}: "
                         + "; ".join(problems))
    return path


def verify_file(path: str, entry: Dict) -> list:
    """Problem strings, empty when the file is fine. The size is always
    checked (the 20-byte-header size, or 4 bytes less for a 16-byte
    header); the SHA-256 only where the entry pins one."""
    problems = []
    actual = os.path.getsize(path)
    if actual not in (entry["size_bytes"], entry["size_bytes"] - 4):
        problems.append(f"size {actual} != expected {entry['size_bytes']} "
                        f"(truncated or wrong file)")
        return problems  # don't bother hashing a wrong-sized file
    if entry.get("sha256"):
        got = sha256_file(path)
        if got != entry["sha256"]:
            problems.append(f"sha256 {got} != pinned {entry['sha256']}")
    return problems


def record_sha(name: str, path: str,
               manifest_path: Optional[str] = None) -> str:
    """Trust on first use: pin the file's SHA-256 into the manifest
    (refuses if the size check fails or a different hash is pinned)."""
    manifest = load_manifest(manifest_path)
    entry = manifest[name]
    problems = verify_file(path, {k: v for k, v in entry.items()
                                  if k != "sha256"})
    if problems:
        raise ValueError("; ".join(problems))
    got = sha256_file(path)
    if entry.get("sha256") and entry["sha256"] != got:
        raise ValueError(f"refusing to overwrite pinned sha256 for {name} "
                         f"({entry['sha256']} -> {got})")
    entry["sha256"] = got
    save_manifest(manifest, manifest_path)
    return got
