"""Seeded synthetic datasets for tests and on-card checks of the
training and evaluation paths, written without OpenCV:

  * VOC-style: PNG images (data/png.py's encoder) with VOC XML
    annotations (write_voc_scenes), or JPEG images (encode_jpeg);
  * COCO-style: JPEG images with an instances JSON in the COCO schema
    (write_coco_scenes);
  * video: an MJPG AVI of moving rectangles (write_video), its frames
    written by the port's JPEG writer (native.preproc.encode_jpeg);
  * gradient_frame: three ramps with seeded uniform noise, the image
    whose JPEG 2000 file is pinned by hash for the writer's cut path.

A VOC scene is a smooth background (a horizontal and a vertical ramp and
one flat channel) with 1-4 filled rectangles, each labelled with a VOC
class; with a palette, a rectangle takes its class's color, so that a
detector can learn the classes. A COCO scene adds ellipses, whose
segmentation area differs from their box's, and crowd regions.

encode_jpeg is a small baseline JPEG encoder in numpy (the tables of the
JPEG specification's Annex K): test and smoke data support, since the
card machine has no image encoder.
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from yolo_tpu_torch.configs import COCO_NAMES, VOC_NAMES
from yolo_tpu_torch.data.png import encode_png
from yolo_tpu_torch.native.preproc import encode_jpeg as encode_jpeg_native


def voc_xml(filename: str, w: int, h: int, objects) -> str:
    """A VOC annotation; objects: (name, x1, y1, x2, y2, difficult or
    None for no <difficult> tag), 1-based inclusive pixel boxes."""
    objs = []
    for name, x1, y1, x2, y2, diff in objects:
        d = "" if diff is None else f"<difficult>{diff}</difficult>"
        objs.append(f"<object><name>{name}</name>{d}<bndbox>"
                    f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
                    f"<ymax>{y2}</ymax></bndbox></object>")
    return (f"<annotation><filename>{filename}</filename><size><width>{w}"
            f"</width><height>{h}</height><depth>3</depth></size>"
            f"{''.join(objs)}</annotation>")


def _background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A horizontal and a vertical ramp and one flat channel."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     np.full((h, w), int(rng.integers(0, 256)))],
                    -1).astype(np.uint8)


def gradient_frame(h: int, w: int, noise: int, seed: int) -> np.ndarray:
    """(H, W, 3) uint8: a horizontal, a vertical and a diagonal ramp, plus
    uniform integer noise in [-noise, noise] from
    np.random.default_rng(seed), clipped (the same bytes on every host)."""
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                      (xx + yy) * 255 // max(w + h - 2, 1)], -1)
    rng = np.random.default_rng(seed)
    return np.clip(ramps + rng.integers(-noise, noise + 1, (h, w, 3)), 0,
                   255).astype(np.uint8)


def scene(rng: np.random.Generator, h: int, w: int, *,
          palette: Optional[np.ndarray] = None, difficult: float = 0.0):
    """(H, W, 3) uint8 image and its objects (voc_xml's form). Without a
    palette each rectangle takes a random color; ``difficult`` is the
    share of objects that carry a drawn <difficult> flag."""
    img = _background(rng, h, w)
    objects = []
    for _ in range(int(rng.integers(1, 5))):
        cls = int(rng.integers(0, len(VOC_NAMES)))
        bw = int(rng.integers(w // 8, w // 2))
        bh = int(rng.integers(h // 8, h // 2))
        x1 = int(rng.integers(1, w - bw))
        y1 = int(rng.integers(1, h - bh))
        img[y1 - 1:y1 - 1 + bh, x1 - 1:x1 - 1 + bw] = (
            rng.integers(0, 256, 3) if palette is None else palette[cls])
        diff = (int(rng.integers(0, 2))
                if difficult and rng.uniform() < difficult else None)
        objects.append((VOC_NAMES[cls], x1, y1, x1 + bw - 1, y1 + bh - 1,
                        diff))
    return img, objects


def write_voc_scenes(root: str, sizes: Sequence[Tuple[int, int]],
                     rng: np.random.Generator, *,
                     palette: Optional[np.ndarray] = None,
                     filters=(0, 1, 2), difficult: float = 0.0,
                     jpeg_quality: Optional[int] = None
                     ) -> List[Tuple[str, str]]:
    """One scene per (h, w) in sizes under root, as NNN.png (rows in the
    given PNG filters) or, with jpeg_quality, NNN.jpg (4:2:0) + NNN.xml
    -> [(image path, annotation path)]."""
    pairs = []
    ext = "png" if jpeg_quality is None else "jpg"
    for i, (h, w) in enumerate(sizes):
        img, objects = scene(rng, h, w, palette=palette, difficult=difficult)
        image = os.path.join(root, f"{i:03d}.{ext}")
        ann = os.path.join(root, f"{i:03d}.xml")
        with open(image, "wb") as f:
            f.write(encode_png(img, filters) if jpeg_quality is None
                    else encode_jpeg(img, jpeg_quality))
        with open(ann, "w") as f:
            f.write(voc_xml(f"{i:03d}.{ext}", w, h, objects))
        pairs.append((image, ann))
    return pairs


# --- baseline JPEG encoder -----------------------------------------------------

_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])   # zigzag index -> row-major index
# Annex K.1 quantization tables, row-major
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# Annex K.3 Huffman tables: (code counts of lengths 1-16, symbols)
_AC_SYMBOLS_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_SYMBOLS_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_HUFFMAN = {  # (class, table): (counts, symbols)
    ("dc", 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("dc", 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("ac", 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                _AC_SYMBOLS_LUMA),
    ("ac", 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                _AC_SYMBOLS_CHROMA),
}
_SAMPLING = {"420": (2, 2), "422": (2, 1), "444": (1, 1), "gray": (1, 1)}


def _codes(counts, symbols):
    """Canonical Huffman codes -> (code of symbol, length of symbol)."""
    code_of = np.zeros(256, np.uint64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    u, x = np.mgrid[0:8, 0:8]
    d = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    d[0] /= np.sqrt(2)
    return d


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8R, 8C) -> (R, C, 8, 8)."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(r, 8, c, 8).transpose(0, 2, 1, 3)


def _size(v: np.ndarray) -> np.ndarray:
    """JPEG magnitude category: bits of |v|."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    while (a > 0).any():
        out += a > 0
        a = a >> 1
    return out


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << size) - 1).astype(np.uint64)


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Bit strings (values, lengths), MSB first -> bytes, the last one
    padded with 1-bits, every 0xFF followed by a stuffed 0x00."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    pad = -total % 8
    values = np.append(values, np.uint64((1 << pad) - 1))
    lengths = np.append(lengths, pad)
    start = np.cumsum(lengths) - lengths
    rep = np.repeat(np.arange(len(values)), lengths)
    shift = (lengths[rep] - 1 - (np.arange(total + pad) - start[rep]))
    bits = (values[rep] >> shift.astype(np.uint64)) & np.uint64(1)
    out = np.packbits(bits.astype(np.uint8))
    return np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _exif(orientation: int) -> bytes:
    """APP1 body: a big-endian TIFF header and IFD0 holding only the
    orientation tag (0x0112, SHORT, 1 value)."""
    return (b"Exif\0\0MM\0\x2a\0\0\0\x08" + struct.pack(
        ">HHHIHHI", 1, 0x0112, 3, 1, orientation, 0, 0))


def encode_jpeg(img, quality: int = 90, sampling: str = "420",
                restart_interval: int = 0,
                orientation: Optional[int] = None) -> bytes:
    """(H, W, 3) RGB or (H, W[, 1]) gray uint8 -> baseline JPEG bytes
    (JFIF, the Annex K tables scaled to quality as libjpeg scales them).
    sampling: "420", "422", "444" or "gray" (one component; an RGB image
    is converted to its luma). restart_interval: MCUs between RST
    markers (0: none). orientation: an EXIF orientation tag (1-8) in an
    APP1 segment; the pixels are stored as given."""
    if sampling not in _SAMPLING:
        raise ValueError(f"sampling {sampling!r} (420 | 422 | 444 | gray)")
    if not 1 <= quality <= 100:
        raise ValueError(f"quality {quality} (1-100)")
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    f = img.astype(np.float64)
    if c == 3:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
    elif c == 1 and sampling == "gray":
        planes = [f[..., 0]]
    else:
        raise ValueError(f"encode_jpeg: a {c}-channel image at sampling "
                         f"{sampling}")
    gray = sampling == "gray"
    planes = planes[:1] if gray else planes
    hs, vs = _SAMPLING[sampling]
    mh, mv = 8 * hs, 8 * vs
    mcux, mcuy = -(-w // mh), -(-h // mv)
    planes = [np.pad(p, ((0, mcuy * mv - h), (0, mcux * mh - w)), "edge")
              for p in planes]
    if not gray:   # chroma: the mean of each hs x vs cell
        planes[1:] = [p.reshape(mcuy * 8, vs, mcux * 8, hs).mean((1, 3))
                      for p in planes[1:]]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((q * scale + 50) // 100, 1, 255)
           for q in (_Q_LUMA, _Q_CHROMA)]
    d = _dct_matrix()
    coef = []
    for i, p in enumerate(planes):
        blk = _blocks(np.round(p) - 128)
        dct = d @ blk @ d.T
        q = qts[min(i, 1)].reshape(8, 8)
        coef.append(np.round(dct / q).astype(np.int64).reshape(
            blk.shape[0], blk.shape[1], 64)[..., _NATURAL])
    # blocks in scan order: (component, block row, block col) per MCU
    if gray:
        rows, cols = -(-h // 8), -(-w // 8)
        zz = coef[0][:rows, :cols].reshape(-1, 64)
        comp = np.zeros(len(zz), np.int64)
        mcu = np.arange(len(zz))
    else:
        my, mx = np.mgrid[0:mcuy, 0:mcux]
        parts, comps = [], []
        for i, (ch, cv) in enumerate(((hs, vs), (1, 1), (1, 1))):
            for v in range(cv):
                for u in range(ch):
                    parts.append(coef[i][my * cv + v, mx * ch + u])
                    comps.append(i)
        zz = np.stack(parts, 2).reshape(-1, 64)
        comp = np.tile(comps, mcuy * mcux)
        mcu = np.repeat(np.arange(mcuy * mcux), len(comps))
    zz[:, 1:] = np.clip(zz[:, 1:], -1023, 1023)
    segment = mcu // restart_interval if restart_interval else 0 * mcu
    table = np.minimum(comp, 1)
    dc_code, dc_len, ac_code, ac_len = [], [], [], []
    for t in (0, 1):
        cd, ld = _codes(*_HUFFMAN[("dc", t)])
        ca, la = _codes(*_HUFFMAN[("ac", t)])
        dc_code.append(cd)
        dc_len.append(ld)
        ac_code.append(ca)
        ac_len.append(la)
    dc_code, dc_len = np.stack(dc_code), np.stack(dc_len)
    ac_code, ac_len = np.stack(ac_code), np.stack(ac_len)
    # DC differences per component, the predictor reset at each restart
    diff = np.zeros(len(zz), np.int64)
    for i in np.unique(comp):
        idx = np.nonzero(comp == i)[0]
        dc = zz[idx, 0]
        prev = np.concatenate([[0], dc[:-1]])
        first = np.concatenate([[True], segment[idx][1:] != segment[idx][:-1]])
        diff[idx] = dc - np.where(first, 0, prev)
    n = len(zz)
    items = []   # (block, order key, code, length)
    s = _size(diff)
    items.append((np.arange(n), np.zeros(n, np.int64),
                  (dc_code[table, s] << s.astype(np.uint64))
                  | _amplitude(diff, s), dc_len[table, s] + s))
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    prev_k = np.where(np.concatenate([[True], blk[1:] != blk[:-1]]), 0,
                      np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    zrl = run // 16
    s = _size(v)
    sym = (run % 16) * 16 + s
    tb = table[blk]
    zb = np.repeat(blk, zrl)
    items.append((zb, np.repeat(2 * k - 1, zrl), ac_code[table[zb], 0xF0],
                  ac_len[table[zb], 0xF0]))
    items.append((blk, 2 * k, (ac_code[tb, sym] << s.astype(np.uint64))
                  | _amplitude(v, s), ac_len[tb, sym] + s))
    last = np.zeros(n, np.int64)
    last[blk] = k   # the largest nonzero index of each block
    eob = np.nonzero(last < 63)[0]
    items.append((eob, np.full(len(eob), 200), ac_code[table[eob], 0],
                  ac_len[table[eob], 0]))
    b_all = np.concatenate([it[0] for it in items])
    key = np.concatenate([it[1] for it in items])
    order = np.lexsort((key, b_all))
    values = np.concatenate([it[2] for it in items]).astype(np.uint64)[order]
    lengths = np.concatenate([it[3] for it in items])[order]
    seg_of = segment[b_all[order]]
    bounds = np.nonzero(np.diff(seg_of))[0] + 1
    scan = b""
    for j, (vals, lens) in enumerate(zip(np.split(values, bounds),
                                         np.split(lengths, bounds))):
        if j:
            scan += bytes((0xFF, 0xD0 + (j - 1) % 8))
        scan += _pack(vals, lens)

    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if orientation is not None:
        out += _segment(0xE1, _exif(orientation))
    for t, q in enumerate(qts[:1] if gray else qts):
        out += _segment(0xDB, bytes([t]) + bytes(
            q.astype(np.uint8)[_NATURAL].tolist()))
    ids = (1,) if gray else (1, 2, 3)
    sof = struct.pack(">BHHB", 8, h, w, len(ids))
    for i, cid in enumerate(ids):
        sof += bytes((cid, (hs << 4 | vs) if i == 0 else 0x11, min(i, 1)))
    out += _segment(0xC0, sof)
    for t in ((0,) if gray else (0, 1)):
        for cls, tc in (("dc", 0), ("ac", 1)):
            counts, symbols = _HUFFMAN[(cls, t)]
            out += _segment(0xC4, bytes([tc << 4 | t]) + bytes(counts)
                            + symbols)
    if restart_interval:
        out += _segment(0xDD, struct.pack(">H", restart_interval))
    sos = bytes([len(ids)])
    for i, cid in enumerate(ids):
        sos += bytes((cid, min(i, 1) * 0x11))
    out += _segment(0xDA, sos + b"\x00\x3f\x00")
    return out + scan + b"\xff\xd9"


# --- COCO-style scenes ---------------------------------------------------------

# COCO's category ids of its 80 detection classes (1-90 with gaps), in
# the order of COCO_NAMES
COCO_CATEGORY_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90)


def coco_scene(rng: np.random.Generator, h: int, w: int, *,
               crowd: float = 0.05):
    """(H, W, 3) uint8 image and its COCO annotations (COCO_NAMES class,
    [x, y, w, h] pixels, area, iscrowd): 1-6 objects, each a filled
    rectangle (area w * h) or ellipse (its pixel count, below its box's
    area), sized from a twentieth of the image to a half, so that every
    COCO area range has objects; ``crowd`` is the share of crowd
    regions."""
    img = _background(rng, h, w)
    anns = []
    for _ in range(int(rng.integers(1, 7))):
        cls = int(rng.integers(0, len(COCO_NAMES)))
        bw = int(rng.integers(max(w // 20, 2), max(w // 2, 3)))
        bh = int(rng.integers(max(h // 20, 2), max(h // 2, 3)))
        x0 = int(rng.integers(0, max(w - bw, 1)))
        y0 = int(rng.integers(0, max(h - bh, 1)))
        bw, bh = min(bw, w - x0), min(bh, h - y0)
        color = rng.integers(0, 256, 3)
        if rng.uniform() < 0.5:
            img[y0:y0 + bh, x0:x0 + bw] = color
            area = float(bw * bh)
        else:
            cy, cx = (bh - 1) / 2, (bw - 1) / 2
            ey, ex = np.mgrid[0:bh, 0:bw]
            inside = (((ey - cy) / (bh / 2)) ** 2
                      + ((ex - cx) / (bw / 2)) ** 2) <= 1
            img[y0:y0 + bh, x0:x0 + bw][inside] = color
            area = float(inside.sum())
        anns.append((cls, [x0, y0, bw, bh], area,
                     int(rng.uniform() < crowd)))
    return img, anns


def write_coco_scenes(root: str, sizes: Sequence[Tuple[int, int]],
                      seed: int, *, crowd: float = 0.05) -> str:
    """One coco_scene per (h, w) in sizes under root as NNN.jpg
    (encode_jpeg, 4:2:0 q90), and root/instances.json in the COCO schema
    (images, annotations with bbox, area and iscrowd, the COCO-80
    categories with COCO's ids) -> the JSON's path."""
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i, (h, w) in enumerate(sizes):
        img, anns = coco_scene(rng, h, w, crowd=crowd)
        name = f"{i:03d}.jpg"
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_jpeg(img, 90))
        images.append({"id": 1000 + i, "file_name": name, "width": w,
                       "height": h})
        for cls, bbox, area, iscrowd in anns:
            annotations.append({"id": len(annotations) + 1,
                                "image_id": 1000 + i,
                                "category_id": COCO_CATEGORY_IDS[cls],
                                "bbox": bbox,
                                "area": area, "iscrowd": iscrowd})
    doc = {"images": images, "annotations": annotations,
           "categories": [{"id": cid, "name": n} for cid, n in
                          zip(COCO_CATEGORY_IDS, COCO_NAMES)]}
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# --- YOLO9000 trees -----------------------------------------------------------

def synth_tree_parents(n_nodes: int, seed: int = 0) -> List[int]:
    """Parent indices of a generated hierarchy with the shape of
    darknet's 9k.tree: one root, breadth-first levels, each node given
    2-6 children (seeded), parents before children, each node's children
    one contiguous run (benchmarks/tree_bench.py::synth_tree's
    generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    parents = [-1]
    frontier = [0]
    while frontier and len(parents) < n_nodes:
        nxt = []
        for node in frontier:
            for _ in range(int(rng.integers(2, 7))):
                if len(parents) >= n_nodes:
                    break
                parents.append(node)
                nxt.append(len(parents) - 1)
        frontier = nxt
    return parents


def write_tree(path: str, n_nodes: int, seed: int = 0) -> str:
    """A generated ``.tree`` file (synth_tree_parents, node i named
    ``n{i}``); returns the path."""
    with open(path, "w") as f:
        f.write("".join(f"n{i} {p}\n" for i, p in
                        enumerate(synth_tree_parents(n_nodes, seed))))
    return path


def write_map(path: str, tree, n: int = 80, seed: int = 0) -> Tuple[int, ...]:
    """A ``.map`` file of ``n`` distinct leaves of ``tree``
    (configs.tree.SoftmaxTree), drawn with the seed in a seeded order,
    as darknet's coco9k.map projects COCO's 80 classes onto 9k.tree
    nodes; returns the node indices."""
    leaves = [i for i in range(tree.n_nodes) if tree.leaf(i)]
    nodes = tuple(int(v) for v in np.random.default_rng(seed).choice(
        leaves, n, replace=False))
    with open(path, "w") as f:
        f.write("".join(f"{v}\n" for v in nodes))
    return nodes


def video_frames(n: int, height: int, width: int,
                 seed: int = 0) -> np.ndarray:
    """(n, height, width, 3) uint8 RGB frames of a seeded scene: a smooth
    background and 3-5 filled rectangles of VOC palette colors, each
    moving on a straight line."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base = np.stack([xx * 200 // max(width - 1, 1),
                     yy * 200 // max(height - 1, 1),
                     np.full_like(xx, int(rng.integers(40, 200)))], -1)
    objs = []
    for _ in range(int(rng.integers(3, 6))):
        bw = int(rng.integers(width // 8, width // 3))
        bh = int(rng.integers(height // 8, height // 3))
        objs.append((rng.uniform(0, width - bw), rng.uniform(0, height - bh),
                     rng.uniform(-4, 4), rng.uniform(-4, 4), bw, bh,
                     rng.integers(0, 256, 3)))
    out = np.empty((n, height, width, 3), np.uint8)
    for t in range(n):
        img = base.copy()
        for x0, y0, vx, vy, bw, bh, color in objs:
            x = int(np.clip(x0 + vx * t, 0, width - bw))
            y = int(np.clip(y0 + vy * t, 0, height - bh))
            img[y:y + bh, x:x + bw] = color
        out[t] = img
    return out


def write_video(path: str, n_frames: int = 48, height: int = 480,
                width: int = 640, fps: float = 30.0, seed: int = 0,
                quality: int = 90) -> np.ndarray:
    """Write video_frames(n_frames, height, width, seed) as an MJPG AVI
    (data.video.AviWriter) and return the frames."""
    from yolo_tpu_torch.data.video import AviWriter

    frames = video_frames(n_frames, height, width, seed)
    writer = AviWriter(path, fps, width, height)
    try:
        for frame in frames:
            writer.write_jpeg(encode_jpeg_native(frame, quality))
    finally:
        writer.close()
    return frames
