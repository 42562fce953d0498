"""A TIFF writer for the decoder tests: the layouts PIL does not write
(tiles, planar configuration, big-endian "MM" files, BigTIFF, 2- and
4-bit gray, min-is-white, 16-bit colour maps, the horizontal predictor
on 16-bit samples, FillOrder 2), from numpy arrays.

write_tiff(samples, ...): samples is (h, w, spp) of uint8 or uint16 (or
(h, w) for one sample), the values as the file stores them (bits < 8:
values below 2**bits).
"""

import struct
import zlib

import numpy as np

NONE, LZW, DEFLATE, PACKBITS = 1, 5, 8, 32773


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, the width growing one
    code early, a clear code first and before the table fills."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
        if nxt >= 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([b])
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([(257 - run) & 0xFF, data[i]])
            i += run
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and \
                not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _pack_rows(s: np.ndarray, bits: int, bo: str) -> bytes:
    """(rows, n) samples -> bytes of whole-byte rows."""
    if bits == 16:
        return s.astype(bo + "u2").tobytes()
    if bits == 8:
        return s.astype(np.uint8).tobytes()
    rows, n = s.shape
    bitmat = np.zeros((rows, -(-n * bits // 8) * 8), np.uint8)
    for k in range(bits):
        bitmat[:, np.arange(n) * bits + k] = (s >> (bits - 1 - k)) & 1
    return np.packbits(bitmat, axis=1).tobytes()


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == LZW:
        return lzw_encode(raw)
    if compression == DEFLATE:
        return zlib.compress(raw)
    if compression == PACKBITS:
        return packbits_encode(raw)
    return raw


def _difference(s: np.ndarray, per: int) -> np.ndarray:
    rows, n = s.shape
    a = s.reshape(rows, n // per, per).astype(np.int64)
    d = a.copy()
    d[:, 1:] = a[:, 1:] - a[:, :-1]
    mod = 1 << (16 if s.dtype == np.uint16 else 8)
    return (d % mod).astype(s.dtype).reshape(rows, n)


def write_tiff(samples, photometric, bits=8, compression=NONE,
               byte_order="<", bigtiff=False, tile=None, rows_per_strip=None,
               planar=1, predictor=1, colormap=None, extra_samples=None,
               orientation=None, fill_order=1):
    """A one-page TIFF. tile: (tile_w, tile_h), multiples of 16;
    colormap: (3, 2**bits) uint16 entries; fill_order 2 reverses the
    bits of each stored byte."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, spp = s.shape
    bo = byte_order
    per = 1 if planar == 2 else spp
    planes = [s[..., k:k + 1] for k in range(spp)] if planar == 2 else [s]
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = -(-w // tw), -(-h // th)
    chunks = []
    for plane in planes:
        for ty in range(down):
            for tx in range(across):
                if tile:
                    block = np.zeros((th, tw, per), s.dtype)
                    part = plane[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                    block[:part.shape[0], :part.shape[1]] = part
                else:
                    block = plane[ty * th:(ty + 1) * th]
                rows = block.reshape(block.shape[0], -1)
                if predictor == 2:
                    rows = _difference(rows, per)
                data = _compress(_pack_rows(rows, bits, bo), compression)
                if fill_order == 2:
                    data = bytes(int(f"{b:08b}"[::-1], 2) for b in data)
                chunks.append(data)
    # layout: header, chunks, out-of-line values, IFD
    head_len = 16 if bigtiff else 8
    data = bytearray(head_len)
    offsets, counts = [], []
    for c in chunks:
        offsets.append(len(data))
        counts.append(len(c))
        data += c
        if len(data) & 1:
            data += b"\0"
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [planar])]
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap).ravel())))
    if extra_samples is not None:
        entries.append((338, 3, list(extra_samples)))
    if tile:
        entries += [(322, 4, [tw]), (323, 4, [th]), (324, 4, offsets),
                    (325, 4, counts)]
    else:
        entries += [(273, 4, offsets), (278, 4, [th]), (279, 4, counts)]
    entries.sort()
    fmt = {3: "H", 4: "I", 16: "Q"}
    size = {3: 2, 4: 4, 16: 8}
    inline = 8 if bigtiff else 4
    packed = []
    for tag, typ, vals in entries:
        if bigtiff and typ == 4 and tag in (273, 279, 324, 325):
            typ = 16
        body = struct.pack(f"{bo}{len(vals)}{fmt[typ]}", *vals)
        if len(body) > inline:
            off = len(data)
            data += body + (b"\0" if len(body) & 1 else b"")
            value = struct.pack(bo + ("Q" if bigtiff else "I"), off)
        else:
            value = body + bytes(inline - len(body))
        packed.append((tag, typ, len(vals), value))
    ifd = len(data)
    if bigtiff:
        data += struct.pack(bo + "Q", len(packed))
        for tag, typ, n, value in packed:
            data += struct.pack(bo + "HHQ", tag, typ, n) + value
        data += struct.pack(bo + "Q", 0)
        magic = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HHHQ",
                                                              43, 8, 0, ifd)
    else:
        data += struct.pack(bo + "H", len(packed))
        for tag, typ, n, value in packed:
            data += struct.pack(bo + "HHI", tag, typ, n) + value
        data += struct.pack(bo + "I", 0)
        magic = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42,
                                                              ifd)
    data[:len(magic)] = magic
    return bytes(data)
