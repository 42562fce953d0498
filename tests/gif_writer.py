"""A GIF writer for the decoder tests: what OpenCV 5's grfmt_gif.cpp is
handed beside the files cv2 and PIL write: frames smaller than the
canvas, local colour tables only, interlaced rows, transparency and
disposal in the graphic control extension, short tables, codes that
start at any width, the table left full (no clear code: the
``deferred clear``) and streams without an end code.

write_gif(width, height, frames, ...): each frame is a dict with
``idx`` ((h, w) colour indices) and optional ``x``, ``y``, ``palette``
(a local table, (n, 3) RGB), ``interlace``, ``transparent`` (an index),
``disposal`` and ``delay``.
"""

import struct

import numpy as np


def _table(palette):
    """(n, 3) RGB -> (the packed table padded to a power of two >= 2,
    its size field)."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    out = np.zeros((1 << bits, 3), np.uint8)
    out[:len(pal)] = pal
    return out.tobytes(), bits - 1


def lzw_encode(indices, min_code_size, clear_every=None, defer_clear=False,
               end_code=True) -> bytes:
    """The GIF LZW stream of a flat sequence of indices: a clear code
    first, the width growing once a code past 1 << width has been added
    (to 12 bits; no early change), a clear code when the table fills
    (or, with defer_clear, none: the table stays full), optionally a
    clear every clear_every codes, the end code last unless end_code is
    False."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    width = min_code_size + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        nonlocal width, nxt, table
        table = {(i,): i for i in range(clear)}
        width, nxt = min_code_size + 1, eoi + 1

    table, nxt = {}, 0
    reset()
    put(clear)
    seq, emitted = (), 0
    for v in (int(i) for i in np.asarray(indices).ravel()):
        cand = seq + (v,)
        if cand in table:
            seq = cand
            continue
        put(table[seq])
        emitted += 1
        if nxt < 4096:
            table[cand] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        seq = (v,)
        if (nxt == 4096 and not defer_clear) or (
                clear_every and emitted % clear_every == 0):
            put(clear)
            reset()
    if seq:
        put(table[seq])
    if end_code:
        put(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out += bytes([len(part)]) + part
    return bytes(out) + b"\x00"


def _interlaced(idx):
    h = idx.shape[0]
    order = (list(range(0, h, 8)) + list(range(4, h, 8))
             + list(range(2, h, 4)) + list(range(1, h, 2)))
    return idx[order]


def write_gif(width, height, frames, palette=None, background=0,
              version=b"89a", min_code_size=None, trailer=True,
              **lzw) -> bytes:
    """A GIF file of the given canvas, global table (None: none) and
    frames; lzw: keyword arguments of lzw_encode for every frame."""
    flags = 0
    gtab = b""
    if palette is not None:
        gtab, size = _table(palette)
        flags = 0x80 | 0x70 | size
    out = bytearray(b"GIF" + version + struct.pack("<HHBBB", width, height,
                                                   flags, background, 0))
    out += gtab
    for fr in frames:
        idx = np.asarray(fr["idx"])
        h, w = idx.shape
        if "transparent" in fr or "disposal" in fr or "delay" in fr:
            t = fr.get("transparent")
            packed = (fr.get("disposal", 0) << 2) | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack(
                "<BHB", packed, fr.get("delay", 0), t or 0) + b"\x00"
        lflags, ltab = 0, b""
        if fr.get("palette") is not None:
            ltab, size = _table(fr["palette"])
            lflags = 0x80 | size
        if fr.get("interlace"):
            lflags |= 0x40
            idx = _interlaced(idx)
        out += b"\x2c" + struct.pack("<HHHHB", fr.get("x", 0), fr.get("y", 0),
                                     w, h, lflags) + ltab
        mcs = min_code_size or max(2, int(idx.max()).bit_length())
        out += bytes([mcs]) + _sub_blocks(lzw_encode(idx, mcs, **lzw))
    if trailer:
        out += b"\x3b"
    return bytes(out)
