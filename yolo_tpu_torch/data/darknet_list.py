"""Darknet-NATIVE dataset format (port of yolo_tpu/data/darknet_list.py): image-path list files + per-image
YOLO-format label `.txt` files + `.data` metadata files (SURVEY.md
§2.1 'GT encoder' / §3.3 train data path — the format darknet itself
trains from, and what LabelImg/Roboflow-style tools export).

The three pieces, with their darknet sources:

* a LIST file (the `train = train.txt` entry of a `.data` file): one
  image path per line (data.c get_paths).
* one LABEL file per image: whitespace-separated
  ``<class_id> <cx> <cy> <w> <h>`` per object, coordinates normalized
  to [0, 1] (data.c read_boxes). The label path derives from the
  image path via the find_replace chain in AlexeyAB's
  replace_image_to_label: ``/images/`` -> ``/labels/`` then the
  pjreddie-era ``/JPEGImages/`` -> ``/labels/`` — applied
  SEQUENTIALLY, each on the previous result, first occurrence each
  (both can fire on one path) — then the image extension -> ``.txt``;
  when no directory component matches, the label is simply the
  sibling ``.txt`` (the chain changed nothing but the extension).
  Labels are a newline-AGNOSTIC token stream (read_boxes is a bare
  fscanf loop): boxes may share a line or wrap across lines.
* a `.data` file (option_list.c read_data_cfg): ``key = value`` lines
  (classes/train/valid/names/backup); ``#``/``;`` comment lines are
  skipped, the FIRST occurrence of a duplicated key wins
  (option_find walks the list front-to-back).

Deviations from darknet, all strictly more permissive:
* darknet's strip() deletes EVERY whitespace character from a .data
  line (a path with internal spaces cannot work there); we strip only
  the ends of key and value.
* darknet's find_replace swaps the FIRST occurrence of ``.jpg`` etc.
  anywhere in the path (mangling e.g. ``a.jpg.d/x.jpg``); we replace
  the path's final extension.
* a MISSING label file warns and trains the image as pure background
  (AlexeyAB logs the path to bad_label.list and continues; pjreddie's
  file_error exits).
* a malformed label token stops that file's read with a warning
  (read_boxes' fscanf loop stops silently at the first
  non-conforming token), and the id token accepts a float form like
  '1.0' (fscanf's %d would consume '1' and shift the stream); a non-``key = value`` .data line warns and
  is skipped (read_data_cfg prints 'Config file error line N' and
  continues).
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the extension set replace_image_to_label rewrites to .txt
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".tiff", ".tif",
              ".pgm", ".webp")


def parse_data_file(path: str) -> Dict[str, str]:
    """A darknet `.data` file -> {key: value} (read_data_cfg
    semantics: ``key = value`` lines, ``#``/``;``/empty lines skipped,
    first occurrence of a duplicate key wins, a non-``key = value``
    line warns and is skipped — darknet prints 'Config file error
    line N' and continues)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line[0] in "#;":
                continue
            if "=" not in line:
                print(f"WARNING: {path}:{lineno}: not 'key = value', "
                      f"ignored: {line}", file=sys.stderr)
                continue
            k, v = line.split("=", 1)
            out.setdefault(k.strip(), v.strip())
    return out


def label_path_for(image_path: str) -> str:
    """Image path -> YOLO label path (replace_image_to_label's
    find_replace chain; see module docstring).

    The patterns apply SEQUENTIALLY, each on the previous result
    (darknet chains find_replace calls, so a path like
    /data/images/JPEGImages/x.jpg becomes /data/labels/labels/x.txt —
    both substitutions fire, first occurrence each)."""
    p = image_path
    for src in ("/images/", "/JPEGImages/", "\\images\\",
                "\\JPEGImages\\"):
        if src in p:
            p = p.replace(src, src[0] + "labels" + src[0], 1)
    stem, ext = os.path.splitext(p)
    if ext.lower() in IMAGE_EXTS:
        return stem + ".txt"
    return p + ".txt"


def read_label_file(path: str, n_classes: int, *,
                    quiet: bool = False) -> Tuple[np.ndarray,
                                                  np.ndarray, int, bool]:
    """One YOLO label file -> (boxes (G, 4) normalized cxcywh f32,
    classes (G,) i32, n_dropped, missing). The content is a
    WHITESPACE-SEPARATED TOKEN STREAM of ``id cx cy w h`` 5-tuples —
    read_boxes is ``while (fscanf(file, "%d %f %f %f %f", ...) == 5)``,
    newline-agnostic: two boxes on one line are two boxes, one box
    wrapped over two lines is one box. Class ids outside [0, n_classes) drop with
    a count (AlexeyAB prints 'Wrong annotation: class id' and skips);
    a missing file yields zero boxes (trains as pure background); a
    non-numeric token or a trailing partial tuple stops the read at
    that point (fscanf returns != 5 and darknet stops silently — we
    warn). Documented permissive deviation: the id token accepts a
    float form like '1.0' (fscanf's %d would consume '1' and shift
    the stream). ``quiet`` suppresses the per-file MISSING warning
    (list_images aggregates those itself); malformed-token warnings
    always print."""
    empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32))
    if not os.path.exists(path):
        if not quiet:
            print(f"WARNING: label file missing: {path} — the image "
                  f"trains as pure background", file=sys.stderr)
        return empty[0], empty[1], 0, True
    boxes, classes, dropped = [], [], 0
    with open(path) as f:
        toks = f.read().split()
    for off in range(0, len(toks) - len(toks) % 5, 5):
        try:
            cid = int(float(toks[off]))
            vals = [float(x) for x in toks[off + 1:off + 5]]
        except ValueError:
            # always said, even under quiet — malformed labels are
            # rare and each deserves its file:offset
            print(f"WARNING: {path}: token {off + 1} is not part of "
                  f"an 'id cx cy w h' tuple — stopping this file's "
                  f"read (darknet's fscanf loop stops here silently): "
                  f"{' '.join(toks[off:off + 5])}", file=sys.stderr)
            return (np.asarray(boxes, np.float32).reshape(-1, 4),
                    np.asarray(classes, np.int32), dropped, False)
        if not 0 <= cid < n_classes:
            dropped += 1
            continue
        boxes.append(vals)
        classes.append(cid)
    if len(toks) % 5:
        print(f"WARNING: {path}: trailing partial box "
              f"({len(toks) % 5} token(s)) ignored (darknet's fscanf "
              f"stops there silently)", file=sys.stderr)
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32), dropped, False)


def _exif_orientation(payload: bytes) -> int:
    """EXIF orientation (1..8) from an APP1 payload, 0 when absent or
    unparseable. Bounds-checked TIFF IFD0 walk (the same tag the
    native decoder inspects, native/jpeg.c)."""
    if payload[:6] != b"Exif\x00\x00":
        return 0
    t = payload[6:]
    if len(t) < 8 or t[:2] not in (b"II", b"MM"):
        return 0
    bo = "<" if t[:2] == b"II" else ">"
    try:
        if struct.unpack(bo + "H", t[2:4])[0] != 42:
            return 0
        ifd = struct.unpack(bo + "I", t[4:8])[0]
        if ifd + 2 > len(t):
            return 0
        n = struct.unpack(bo + "H", t[ifd:ifd + 2])[0]
        for i in range(n):
            e = ifd + 2 + 12 * i
            if e + 12 > len(t):
                return 0
            tag, typ = struct.unpack(bo + "HH", t[e:e + 4])
            if tag == 0x0112 and typ == 3:  # orientation, SHORT
                return struct.unpack(bo + "H", t[e + 8:e + 10])[0]
    except struct.error:
        return 0
    return 0


def image_dims(path: str) -> Tuple[int, int]:
    """(width, height) of an image, by header sniff for JPEG/PNG — no
    full decode, even for EXIF-carrying phone JPEGs: the APP1
    orientation tag is parsed and orientations 5..8 swap the SOF dims,
    matching the decoders' auto-rotation (the pipeline's loader applies
    it, so its post-rotation view is the authoritative geometry); BMP by
    its header too. Other formats (PNM, TIFF, WebP) and unparseable
    headers fall back to a full decode through
    data.pipeline.load_image (the port's own decoder unless cv2 is
    selected), as the JAX package's falls back to cv2.imread."""
    with open(path, "rb") as f:
        head = f.read(26)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return int(w), int(h)
        if head[:2] == b"BM" and len(head) == 26:
            # BMP: its header holds the dims (BITMAPCOREHEADER: 16-bit;
            # later headers: 32-bit, a negative height for top-down rows)
            if struct.unpack("<I", head[14:18])[0] == 12:
                w, h = struct.unpack("<HH", head[18:22])
            else:
                w, h = struct.unpack("<ii", head[18:26])
            return int(abs(w)), int(abs(h))
        if head[:2] == b"\xff\xd8":  # JPEG: walk the marker stream
            f.seek(2)
            orient = 0
            while True:
                b = f.read(1)
                if not b:
                    break
                if b != b"\xff":
                    continue
                marker = f.read(1)
                while marker == b"\xff":  # fill bytes
                    marker = f.read(1)
                if not marker or marker in (b"\xd8", b"\x01") or \
                        b"\xd0" <= marker <= b"\xd7":
                    continue  # standalone markers, no length
                ln = f.read(2)
                if len(ln) < 2:
                    break
                seglen = struct.unpack(">H", ln)[0]
                if seglen < 2:
                    break  # corrupt length: full-decode fallback
                m = marker[0]
                if m == 0xE1:  # APP1: read the EXIF orientation
                    # keep the FIRST Exif APP1's value: phone JPEGs
                    # often carry a second APP1 (XMP) whose payload
                    # fails the Exif check and would reset orient to 0
                    # (cv2 and native/jpeg.c both honor the first
                    # Exif segment)
                    orient = orient or _exif_orientation(
                        f.read(seglen - 2))
                    continue
                if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                    sof = f.read(5)  # precision(1) H(2) W(2)
                    if len(sof) == 5:
                        h, w = struct.unpack(">HH", sof[1:5])
                        if orient >= 5:  # 90/270-degree rotations
                            w, h = h, w
                        return int(w), int(h)
                    break
                f.seek(seglen - 2, 1)
    from yolo_tpu_torch.data.pipeline import load_image

    try:
        img = load_image(path)
    except (OSError, ValueError) as e:
        raise ValueError(f"cannot read image dimensions: {path}: {e}") \
            from None
    return int(img.shape[1]), int(img.shape[0])


def list_images(list_file: str,
                class_names: Sequence[str]) -> List[Tuple[str, Dict]]:
    """A darknet list file -> (image_path, annotation_dict) samples in
    `voc.parse_annotation`'s schema (normalized cxcywh boxes, classes,
    width/height, difficult all 0 — YOLO labels carry no difficult
    flag). Relative image paths resolve against the CWD first
    (darknet's semantics: list entries are relative to where darknet
    runs) and fall back to the list file's own directory."""
    base = os.path.dirname(os.path.abspath(list_file))
    with open(list_file) as f:
        raw_paths = [line.strip() for line in f if line.strip()]
    if not raw_paths:
        raise ValueError(f"{list_file}: empty image list")
    samples: List[Tuple[str, Dict]] = []
    ncls = len(class_names)
    n_missing, first_missing = 0, None
    n_dropped, n_kept = 0, 0
    for rp in raw_paths:
        p = rp
        if not os.path.isabs(p) and not os.path.exists(p):
            alt = os.path.join(base, rp)
            if os.path.exists(alt):
                p = alt
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{list_file}: image not found: {rp} (tried CWD and "
                f"the list file's directory)")
        lp = label_path_for(p)
        boxes, classes, dropped, missing = read_label_file(
            lp, ncls, quiet=True)
        if missing:
            n_missing += 1
            first_missing = first_missing or lp
        n_dropped += dropped
        n_kept += len(classes)
        w, h = image_dims(p)
        samples.append((p, {
            "boxes": boxes, "classes": classes,
            "difficult": np.zeros((len(classes),), np.int32),
            "width": w, "height": h,
            "filename": os.path.basename(p),
            "n_unknown": dropped,
        }))
    if n_missing:
        print(f"WARNING: {n_missing}/{len(samples)} label files "
              f"missing (first: {first_missing}) — those images train "
              f"as pure background", file=sys.stderr)
    if n_dropped:
        # the wrong-class-count footgun tripwire (same spirit as the
        # VOC pipeline's wrong---names warning): AlexeyAB prints a
        # per-line 'Wrong annotation: class id' here
        level = ("EVERY label line was dropped — the model would "
                 "train on pure background. Wrong class count "
                 "(check the model's classes / --names / .data "
                 "classes=)?" if n_kept == 0 else
                 "check for stray class ids in the label files")
        print(f"WARNING: {n_dropped} label lines dropped (class id "
              f"outside [0, {ncls})); {level}", file=sys.stderr)
    return samples
