"""Rewrites of a JPEG 2000 codestream that PIL wrote, for the kinds no
encoder here writes, and JP2 boxes around a codestream.

The codestream is parsed into its main header, its tile-parts and, for
streams of default precincts, layer-resolution progressions and the
default code-block style, its packets (each header's length found by
reading it as tier 2 reads it: tag trees, passes, Lblock). From those:

  * restate_poc: a POC marker per resolution restating an RLCP order, the
    volumes alternating LRCP and RLCP (the same packet order);
  * packed_headers: the packet headers moved into the main header's PPM
    markers or into each tile-part's PPT markers (two per tile-part,
    Zppt 0 and 1);
  * with_eph: an EPH marker after every packet header (Scod bit 2);
  * tile_parts: each tile split at packet boundaries into n parts,
    optionally interleaved across the tiles (T0P0 T1P0 ... T0P1 ...);
  * with_markers: a main-header RGN (maxshift), COC / QCC restating
    COD / QCD, a TLM and a CRG, and a COD restated in the first
    tile-part's header;
  * set_precision: SIZ's precision (and sign) rewritten;
  * jp2: a JP2 file (signature, ftyp, jp2h with ihdr, colr, optional
    pclr / cmap / cdef, then jp2c) around a codestream;
  * encode: a reversible codestream written here whole (forward 5/3,
    tier 1 with every code-block style, tier 2, SOP / EPH, an ROI by
    maxshift), for what PIL 12's writer does not set (its cblk_style
    and sop are not read); cv2 reads its output back to the input.
"""

from __future__ import annotations

import struct

SIZ, COD, QCD, SOT, SOD, EOC = (0xFF51, 0xFF52, 0xFF5C, 0xFF90, 0xFF93,
                                0xFFD9)


def _u16(v):
    return struct.pack(">H", v)


def parse(cs: bytes) -> dict:
    """-> {"main": [(marker, body)], "parts": [(isot, tpsot, tnsot,
    [(marker, body)], data)]} for a codestream of whole tile-parts."""
    assert cs[:4] == b"\xff\x4f\xff\x51"
    pos, main = 2, []
    while True:
        (m,) = struct.unpack_from(">H", cs, pos)
        if m == SOT:
            break
        (ln,) = struct.unpack_from(">H", cs, pos + 2)
        main.append((m, cs[pos + 4:pos + 2 + ln]))
        pos += 2 + ln
    parts = []
    while True:
        (m,) = struct.unpack_from(">H", cs, pos)
        if m == EOC:
            break
        assert m == SOT
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", cs, pos + 4)
        start, p, hdr = pos, pos + 12, []
        while True:
            (m,) = struct.unpack_from(">H", cs, p)
            if m == SOD:
                p += 2
                break
            (ln,) = struct.unpack_from(">H", cs, p + 2)
            hdr.append((m, cs[p + 4:p + 2 + ln]))
            p += 2 + ln
        end = start + psot if psot else len(cs) - 2
        parts.append((isot, tpsot, tnsot, hdr, cs[p:end]))
        pos = end
    return {"main": main, "parts": parts}


def _seg(m, body):
    return _u16(m) + _u16(len(body) + 2) + body


def build(main, parts) -> bytes:
    """parse()'s form -> a codestream: each Psot computed, each TNsot the
    tile's count of parts where a part's tnsot is None, else as given."""
    out = bytearray(b"\xff\x4f")
    for m, b in main:
        out += _seg(m, b)
    counts = {}
    for isot, *_ in parts:
        counts[isot] = counts.get(isot, 0) + 1
    for isot, tpsot, tnsot, hdr, data in parts:
        h = b"".join(_seg(m, b) for m, b in hdr)
        psot = 12 + len(h) + 2 + len(data)
        tn = counts[isot] if tnsot is None else tnsot
        out += struct.pack(">HHHIBB", SOT, 10, isot, psot, tpsot, tn)
        out += h + b"\xff\x93" + data
    return bytes(out + b"\xff\xd9")


# --- packets -------------------------------------------------------------


class _Bio:
    """OpenJPEG's opj_bio reader."""

    def __init__(self, data, pos):
        self.d, self.bp, self.buf, self.ct = data, pos, 0, 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < len(self.d):
            self.buf |= self.d[self.bp]
            self.bp += 1

    def read(self, n):
        v = 0
        for _ in range(n):
            if self.ct == 0:
                self._bytein()
            self.ct -= 1
            v = (v << 1) | ((self.buf >> self.ct) & 1)
        return v

    def inalign(self):
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0
        return self.bp


class _TagTree:
    def __init__(self, w, h):
        self.parent, self.value, self.low = [], [], []
        dims, n = [(w, h)], w * h
        while n > 1:
            w, h = (w + 1) // 2, (h + 1) // 2
            dims.append((w, h))
            n = w * h
        base = 0
        for lv, (w, h) in enumerate(dims):
            nxt = base + w * h
            for y in range(h):
                for x in range(w):
                    if lv + 1 < len(dims):
                        nw = dims[lv + 1][0]
                        self.parent.append(nxt + (y // 2) * nw + x // 2)
                    else:
                        self.parent.append(-1)
            base = nxt
        self.value = [999] * len(self.parent)
        self.low = [0] * len(self.parent)

    def decode(self, bio, leaf, threshold):
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return self.value[node] < threshold


def _ceildiv(a, b):
    return -((-a) // b)


def _params(main):
    siz = dict(main)[SIZ]
    (_, x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc) = struct.unpack_from(
        ">HIIIIIIIIH", siz)
    cod = dict(main)[COD]
    scod, prg, layers, _mct, nl, cbw, cbh, style = struct.unpack_from(
        ">BBHBBBBB", cod)
    return dict(x0=x0, y0=y0, x1=x1, y1=y1, tdx=tdx, tdy=tdy, tx0=tx0,
                ty0=ty0, nc=nc, prg=prg, layers=layers, numres=nl + 1,
                cbw=cbw + 2, cbh=cbh + 2, scod=scod, style=style)


def _bands(p, tileno):
    """Per (comp, res): [(w, h) code-block grid of each non-empty band]."""
    tw = _ceildiv(p["x1"] - p["tx0"], p["tdx"])
    i, j = tileno % tw, tileno // tw
    tx0 = max(p["tx0"] + i * p["tdx"], p["x0"])
    ty0 = max(p["ty0"] + j * p["tdy"], p["y0"])
    tx1 = min(p["tx0"] + (i + 1) * p["tdx"], p["x1"])
    ty1 = min(p["ty0"] + (j + 1) * p["tdy"], p["y1"])
    out = {}
    for r in range(p["numres"]):
        lv = p["numres"] - 1 - r
        res = [_ceildiv(v, 1 << lv) for v in (tx0, ty0, tx1, ty1)]
        if res[0] == res[2] or res[1] == res[3]:
            continue      # an empty resolution has no packets
        kinds = [(0, 0)] if r == 0 else [(1, 0), (0, 1), (1, 1)]
        grids = []
        for xb, yb in kinds:
            if r == 0:
                b = [_ceildiv(v, 1 << lv) for v in (tx0, ty0, tx1, ty1)]
            else:
                s = 1 << (lv + 1)
                b = [_ceildiv(tx0 - (xb << lv), s), _ceildiv(ty0 - (yb << lv), s),
                     _ceildiv(tx1 - (xb << lv), s), _ceildiv(ty1 - (yb << lv), s)]
            if b[2] == b[0] or b[3] == b[1]:
                continue
            cw, ch = 1 << p["cbw"], 1 << p["cbh"]
            grids.append((_ceildiv(b[2], cw) - b[0] // cw,
                          _ceildiv(b[3], ch) - b[1] // ch))
        for c in range(p["nc"]):
            out[c, r] = grids
    return out


def packets(main, data: bytes, tileno: int, state=None):
    """The packets of a tile's data in its progression (LRCP or RLCP) ->
    [(header bytes, body bytes)]; state carries the tag trees across a
    tile's parts."""
    p = _params(main)
    assert p["scod"] & 1 == 0 and p["style"] == 0, \
        "default precincts and code-block style"
    bands = _bands(p, tileno)
    order = [(l, r) for l in range(p["layers"]) for r in range(p["numres"])]
    if p["prg"] == 1:
        order = [(l, r) for r in range(p["numres"]) for l in range(p["layers"])]
    else:
        assert p["prg"] == 0, "LRCP or RLCP"
    trees = {}
    out, pos = [], 0
    for layer, r in order:
        for c in range(p["nc"]):
            if (c, r) not in bands:
                continue
            if (c, r) not in trees:
                trees[c, r] = [(_TagTree(w, h), _TagTree(w, h), [None] * (w * h))
                               for w, h in bands[c, r]]
            bio = _Bio(data, pos)
            lengths = 0
            if bio.read(1):
                for incl, imsb, st in trees[c, r]:
                    for k in range(len(st)):
                        if st[k] is None:
                            inc = incl.decode(bio, k, layer + 1)
                        else:
                            inc = bio.read(1)
                        if not inc:
                            continue
                        if st[k] is None:
                            i = 0
                            while not imsb.decode(bio, k, i):
                                i += 1
                            st[k] = 3
                        if not bio.read(1):
                            n = 1
                        elif not bio.read(1):
                            n = 2
                        else:
                            n = bio.read(2)
                            if n != 3:
                                n += 3
                            else:
                                n = bio.read(5)
                                n = n + 6 if n != 31 else 37 + bio.read(7)
                        while bio.read(1):
                            st[k] += 1
                        lengths += bio.read(st[k] + n.bit_length() - 1)
            hend = bio.inalign()
            out.append((data[pos:hend], data[hend:hend + lengths]))
            pos = hend + lengths
    assert pos == len(data), "the packets fill the tile's data"
    return out


# --- rewrites ---------------------------------------------------------------


def restate_poc(cs: bytes) -> bytes:
    """An RLCP codestream -> the same with a main-header POC of one volume
    per resolution, alternating LRCP and RLCP (the packet order is
    unchanged)."""
    s = parse(cs)
    p = _params(s["main"])
    assert p["prg"] == 1
    body = b"".join(struct.pack(">BBHBBB", r, 0, p["layers"], r + 1, p["nc"],
                                r % 2) for r in range(p["numres"]))
    main = s["main"] + [(0xFF5F, body)]
    return build(main, [(i, t, None, h, d) for i, t, _, h, d in s["parts"]])


def with_eph(cs: bytes) -> bytes:
    """An EPH marker after every packet header."""
    s = parse(cs)
    main = [(m, (bytes([b[0] | 4]) + b[1:]) if m == COD else b)
            for m, b in s["main"]]
    parts = []
    for i, t, _, h, d in s["parts"]:
        pk = packets(s["main"], d, i)
        parts.append((i, t, None, h,
                      b"".join(hh + b"\xff\x92" + bb for hh, bb in pk)))
    return build(main, parts)


def _part_packets(s):
    """Each tile-part's packets, the tiles' tag-tree state carried across
    their parts (split at packet boundaries)."""
    by_tile = {}
    for k, (i, *_rest) in enumerate(s["parts"]):
        by_tile.setdefault(i, []).append(k)
    out = [None] * len(s["parts"])
    for i, ks in by_tile.items():
        pk = packets(s["main"], b"".join(s["parts"][k][4] for k in ks), i)
        pos = 0
        for k in ks:
            n, take = len(s["parts"][k][4]), 0
            while take < n:
                take += len(pk[pos][0]) + len(pk[pos][1])
                pos += 1
                out[k] = (out[k] or []) + [pk[pos - 1]]
            assert take == n, "tile-parts split at packet boundaries"
            out[k] = out[k] or []
    return out


def packed_headers(cs: bytes, where: str) -> bytes:
    """The packet headers moved to PPM (main header, one Nppm per
    tile-part, split across two markers) or PPT (two markers in each
    tile-part's header)."""
    s = parse(cs)
    parts, ppm = [], b""
    for (i, t, _, h, _d), pk in zip(s["parts"], _part_packets(s)):
        heads = b"".join(hh for hh, _ in pk)
        bodies = b"".join(bb for _, bb in pk)
        if where == "ppm":
            ppm += struct.pack(">I", len(heads)) + heads
            parts.append((i, t, None, h, bodies))
        else:
            half = len(heads) // 2
            ppt = [(0xFF61, b"\x00" + heads[:half]),
                   (0xFF61, b"\x01" + heads[half:])]
            parts.append((i, t, None, h + ppt, bodies))
    main = list(s["main"])
    if where == "ppm":
        half = len(ppm) // 2
        main += [(0xFF60, b"\x00" + ppm[:half]),
                 (0xFF60, b"\x01" + ppm[half:])]
    return build(main, parts)


def tile_parts(cs: bytes, n: int, interleave: bool) -> bytes:
    """Each tile's data split at packet boundaries into n tile-parts;
    interleaved: the tiles' k-th parts together, in tile order."""
    s = parse(cs)
    split = []
    for i, _t, _, h, d in s["parts"]:
        pk = packets(s["main"], d, i)
        cut = [len(pk) * k // n for k in range(n + 1)]
        chunks = [b"".join(a + b for a, b in pk[cut[k]:cut[k + 1]])
                  for k in range(n)]
        split.append([(i, k, None, h if k == 0 else [], chunks[k])
                      for k in range(n)])
    if interleave:
        parts = [tp[k] for k in range(n) for tp in split]
    else:
        parts = [p for tp in split for p in tp]
    return build(s["main"], parts)


def with_markers(cs: bytes, roishift: int = 0) -> bytes:
    """Markers that restate or add nothing the decode changes: COC and QCC
    for component 0 (COD's and QCD's values), TLM, CRG, COM, COD again in
    the first tile-part; and an RGN of roishift on component 0."""
    s = parse(cs)
    main = dict(s["main"])
    cod, qcd = main[COD], main[QCD]
    nc = _params(s["main"])["nc"]
    cbytes = 2 if nc >= 257 else 1
    comp0 = b"\x00" * cbytes
    extra = [(0xFF53, comp0 + bytes([cod[0] & 1]) + cod[5:]),
             (0xFF5D, comp0 + qcd),
             (0xFF63, b"".join(struct.pack(">HH", 0, 0) for _ in range(nc))),
             (0xFF64, b"\x00\x01written by tests/j2k_writer.py")]
    if roishift:
        extra.append((0xFF5E, comp0 + bytes([0, roishift])))
    parts = [(i, t, None, (h + [(COD, cod)]) if k == 0 else h, d)
             for k, (i, t, _, h, d) in enumerate(s["parts"])]
    # TLM: each tile-part's index and length (Stlm: 8-bit Ttlm, 32-bit
    # Ptlm), as the rewritten stream has them
    lengths = [12 + sum(4 + len(b) for _, b in h) + 2 + len(d)
               for _, _, _, h, d in parts]
    tlm = (0xFF55, b"\x00\x50" + b"".join(
        struct.pack(">BI", i, n) for (i, *_), n in zip(parts, lengths)))
    return build(s["main"] + extra + [tlm], parts)


def set_precision(cs: bytes, prec: int, signed: bool = False) -> bytes:
    """SIZ's Ssiz of every component set to prec bits (and the sign)."""
    s = parse(cs)
    main = []
    for m, b in s["main"]:
        if m == SIZ:
            nc = struct.unpack_from(">H", b, 34)[0]
            b = bytearray(b)
            for c in range(nc):
                b[36 + 3 * c] = (prec - 1) | (0x80 if signed else 0)
            b = bytes(b)
        main.append((m, b))
    return build(main, [(i, t, None, h, d) for i, t, _, h, d in s["parts"]])


# --- JP2 ----------------------------------------------------------------------


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2(cs: bytes, enumcs=16, icc: bytes = None, pclr=None, cmap=None,
        cdef=None, extra_colr=None) -> bytes:
    """A JP2 file around cs: colr by enumerated colour space (or an ICC
    profile, method 2), optional pclr (entries: [[...]] rows, bits: column
    precisions), cmap ([(cmp, mtyp, pcol)]), cdef ([(cn, typ, asoc)]);
    extra_colr: a second colr box's enumcs (ignored by readers)."""
    s = parse(cs)
    p = _params(s["main"])
    siz = dict(s["main"])[SIZ]
    bpc = siz[36]
    ihdr = struct.pack(">IIHBBBB", p["y1"] - p["y0"], p["x1"] - p["x0"],
                       p["nc"], bpc, 7, 0, 0)
    colr = (b"\x02\x00\x00" + icc) if icc is not None else \
        struct.pack(">BBBI", 1, 0, 0, enumcs)
    h = _box(b"ihdr", ihdr) + _box(b"colr", colr)
    if extra_colr is not None:
        h += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, extra_colr))
    if pclr is not None:
        entries, bits = pclr
        body = struct.pack(">HB", len(entries), len(bits)) + bytes(
            b - 1 for b in bits)
        for row in entries:
            for v, b in zip(row, bits):
                body += int(v).to_bytes((b + 7) // 8, "big")
        h += _box(b"pclr", body)
    if cmap is not None:
        h += _box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in cmap))
    if cdef is not None:
        h += _box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *e) for e in cdef))
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n"
            + _box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + _box(b"jp2h", h) + _box(b"res ", _box(b"resc", bytes(10)))
            + _box(b"jp2c", cs))


# --- an encoder, for what PIL's writer does not set --------------------------

# T.800 Table C.2, as the decoder's (native/j2k_t1.c)
_QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0)]
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
_AGG, _UNI = 17, 18


class _MQ:
    """The MQ coder's encoder (Annex C), its contexts kept across
    segments; flush() ends a segment as OpenJPEG's opj_mqc_flush does."""

    def __init__(self):
        self.reset()
        self.start()

    def reset(self):
        self.idx, self.mps = [0] * 19, [0] * 19
        self.idx[_UNI], self.idx[_AGG], self.idx[0] = 46, 3, 4

    def start(self):
        self.a, self.c, self.ct, self.buf, self.bp = 0x8000, 0, 12, \
            bytearray(1), 0

    def _put(self, v):
        v &= 0xFF       # the byte register: the carry went to the last one
        self.bp += 1
        if self.bp == len(self.buf):
            self.buf.append(v)
        else:
            self.buf[self.bp] = v

    def _byteout(self):
        if self.buf[self.bp] == 0xFF:
            self._put(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self._put(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.buf[self.bp] += 1
            if self.buf[self.bp] == 0xFF:
                self.c &= 0x7FFFFFF
                self._put(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self._put(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d, cx):
        qe, nmps, nlps, sw = _QE[self.idx[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.idx[cx] = nmps
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                self.mps[cx] = 1 - self.mps[cx]
            self.idx[cx] = nlps
        self._renorm()

    def flush(self) -> bytes:
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        end = self.bp + (self.buf[self.bp] != 0xFF)
        out = bytes(self.buf[1:end])
        self.start()
        return out


class _Raw:
    """BYPASS passes' raw bits, 7 to a byte after a 0xFF."""

    def __init__(self):
        self.out, self.cur, self.n, self.limit = bytearray(), 0, 0, 8

    def bit(self, b):
        self.cur = (self.cur << 1) | b
        self.n += 1
        if self.n == self.limit:
            self.out.append(self.cur)
            self.limit = 7 if self.cur == 0xFF else 8
            self.cur = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.out.append(self.cur << (self.limit - self.n))
        out = bytes(self.out)
        if out[-1:] == b"\xff":       # read back the same from the end marker
            out = out[:-1]
        self.__init__()
        return out


def _zc(h, v, d, orient):
    if orient == 3:
        hv = h + v
        if d == 0:
            return min(hv, 2)
        if d == 1:
            return 3 + min(hv, 2)
        if d == 2:
            return 6 if hv == 0 else 7
        return 8
    if orient == 1:
        h, v = v, h
    if h == 0:
        return min(d, 2) if v == 0 else (3 if v == 1 else 4)
    if h == 1:
        return (5 if d == 0 else 6) if v == 0 else 7
    return 8


def _cblk_passes(mag, neg, orient, style, roishift):
    """One code-block's coefficients (magnitudes, signs) -> (number of
    bit-planes P, [(segment bytes, passes)]): every pass down to bit-plane
    0, the segments and their raw / MQ coding as the decoder reads them
    (OpenJPEG's opj_t2_init_seg and opj_t1_decode_cblk)."""
    h, w = mag.shape
    big = int(mag.max()) if mag.size else 0
    p_top = big.bit_length()
    sig = [[0] * (w + 2) for _ in range(h + 2)]
    negs = [[0] * (w + 2) for _ in range(h + 2)]
    visit = [[0] * w for _ in range(h)]
    refined = [[0] * w for _ in range(h)]
    vsc = style & VSC

    def s(y, x):   # significance seen from (y - 1)'s stripe row 3 etc.
        return sig[y + 1][x + 1]

    def nbrs(y, x):
        hide = vsc and y % 4 == 3
        hh = s(y, x - 1) + s(y, x + 1)
        vv = s(y - 1, x) + (0 if hide else s(y + 1, x))
        dd = s(y - 1, x - 1) + s(y - 1, x + 1) + (
            0 if hide else s(y + 1, x - 1) + s(y + 1, x + 1))
        return hh, vv, dd

    def contrib(y, x):
        return (1 - 2 * negs[y + 1][x + 1]) if sig[y + 1][x + 1] else 0

    def sign_ctx(y, x):
        hide = vsc and y % 4 == 3
        hc = max(-1, min(1, contrib(y, x - 1) + contrib(y, x + 1)))
        vc = max(-1, min(1, contrib(y - 1, x) + (0 if hide else
                                                 contrib(y + 1, x))))
        table = {(1, 1): 13, (1, 0): 12, (1, -1): 11, (0, 1): 10,
                 (0, 0): 9, (0, -1): 10, (-1, 1): 11, (-1, 0): 12,
                 (-1, -1): 13}
        return table[hc, vc], int(hc < 0 or (hc == 0 and vc < 0))

    mq, raw = _MQ(), _Raw()

    def make_sig(y, x, enc):
        sig[y + 1][x + 1] = 1
        negs[y + 1][x + 1] = int(neg[y, x])
        if enc is raw:
            raw.bit(int(neg[y, x]))
        else:
            cx, flip = sign_ctx(y, x)
            mq.encode(int(neg[y, x]) ^ flip, cx)

    def stripes():
        for k in range(0, h, 4):
            for x in range(w):
                yield k, x, range(k, min(k + 4, h))

    def sigpass(p, enc):
        for _, x, ys in stripes():
            for y in ys:
                if sig[y + 1][x + 1] or visit[y][x] or not any(nbrs(y, x)):
                    continue
                b = (int(mag[y, x]) >> p) & 1
                if enc is raw:
                    raw.bit(b)
                else:
                    mq.encode(b, _zc(*nbrs(y, x), orient))
                if b:
                    make_sig(y, x, enc)
                visit[y][x] = 1

    def refpass(p, enc):
        for _, x, ys in stripes():
            for y in ys:
                if not sig[y + 1][x + 1] or visit[y][x]:
                    continue
                b = (int(mag[y, x]) >> p) & 1
                if enc is raw:
                    raw.bit(b)
                else:
                    cx = 16 if refined[y][x] else 15 if any(nbrs(y, x)) \
                        else 14
                    mq.encode(b, cx)
                refined[y][x] = 1

    def clnpass(p):
        for k, x, ys in stripes():
            ys = list(ys)
            start = 0
            if len(ys) == 4 and not any(
                    sig[y + 1][x + 1] or visit[y][x] or any(nbrs(y, x))
                    for y in ys):
                bits = [(int(mag[y, x]) >> p) & 1 for y in ys]
                if not any(bits):
                    mq.encode(0, _AGG)
                    continue
                mq.encode(1, _AGG)
                r = bits.index(1)
                mq.encode(r >> 1, _UNI)
                mq.encode(r & 1, _UNI)
                make_sig(k + r, x, mq)
                start = r + 1
            for y in ys[start:]:
                if sig[y + 1][x + 1] or visit[y][x]:
                    continue
                b = (int(mag[y, x]) >> p) & 1
                mq.encode(b, _zc(*nbrs(y, x), orient))
                if b:
                    make_sig(y, x, mq)
            for y in ys:
                visit[y][x] = 0
        if style & SEGSYM:
            for b in (1, 0, 1, 0):
                mq.encode(b, _UNI)

    npass = max(0, 3 * p_top - 2)
    # segments: (passes, maxpasses) as opj_t2_init_seg cuts them
    segs, left = [], npass
    while left > 0:
        if style & TERMALL:
            mx = 1
        elif style & LAZY:
            mx = 10 if not segs else (2 if segs[-1] in (1, 10) else 1)
        else:
            mx = 109
        segs.append(mx)
        left -= mx
    out, passtype, bpno = [], 2, p_top      # bpno: bit-plane + 1
    numbps = p_top - roishift
    done = 0
    for mx in segs:
        n = min(mx, npass - done)
        is_raw = (style & LAZY) and passtype < 2 and bpno <= numbps - 4
        enc = raw if is_raw else mq
        for _ in range(n):
            if passtype == 0:
                sigpass(bpno - 1, enc)
            elif passtype == 1:
                refpass(bpno - 1, enc)
            else:
                clnpass(bpno - 1)
            if (style & RESET) and not is_raw:
                mq.reset()
            passtype += 1
            if passtype == 3:
                passtype, bpno = 0, bpno - 1
        done += n
        out.append((enc.flush(), n))
    return p_top, out


class _TagEnc:
    """A tag tree's encoder (opj_tgt_encode) over given leaf values."""

    def __init__(self, w, h, values):
        self.parent, dims = [], [(w, h)]
        while dims[-1][0] * dims[-1][1] > 1:
            dims.append(((dims[-1][0] + 1) // 2, (dims[-1][1] + 1) // 2))
        base = 0
        for lv, (ww, hh) in enumerate(dims):
            nxt = base + ww * hh
            for y in range(hh):
                for x in range(ww):
                    self.parent.append(nxt + (y // 2) * dims[lv + 1][0]
                                       + x // 2 if lv + 1 < len(dims) else -1)
            base = nxt
        self.value = [999] * len(self.parent)
        self.value[:w * h] = values
        for i in range(len(self.parent)):
            if self.parent[i] >= 0:
                self.value[self.parent[i]] = min(self.value[self.parent[i]],
                                                 self.value[i])
        self.low = [0] * len(self.parent)
        self.known = [False] * len(self.parent)

    def encode(self, bits, leaf, threshold):
        path, node = [], leaf
        while node >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        for node in reversed(path):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.append(1)
                        self.known[node] = True
                    break
                bits.append(0)
                low += 1
            self.low[node] = low


def _header_bytes(bits) -> bytes:
    """Packet-header bits -> bytes, 7 bits after a 0xFF, and a 0x00 after
    a final 0xFF (what opj_bio_inalign reads past)."""
    out, cur, n, limit = bytearray(), 0, 0, 8
    for b in bits:
        cur = (cur << 1) | b
        n += 1
        if n == limit:
            out.append(cur)
            limit = 7 if cur == 0xFF else 8
            cur = n = 0
    if n:
        out.append(cur << (limit - n))
    if out[-1:] == b"\xff":
        out.append(0)
    return bytes(out)


def _fdwt53_1d(x):
    """The forward 5/3 of a signal starting at an even index (F.4.8)."""
    n = len(x)
    if n == 1:
        return list(x)
    y = list(x)
    for i in range(1, n, 2):
        r = y[i + 1] if i + 1 < n else y[i - 1]
        y[i] = x[i] - ((x[i - 1] + r) >> 1)
    for i in range(0, n, 2):
        left = y[i - 1] if i > 0 else y[1]
        right = y[i + 1] if i + 1 < n else y[i - 1]
        y[i] = x[i] + ((left + right + 2) >> 2)
    return y[0::2] + y[1::2]


def encode(img, levels=2, cblk=(4, 4), style=0, sop=False, eph=False,
           roi=None) -> bytes:
    """A reversible 5/3 codestream of img ((h, w, c) uint8, c components,
    no MCT), one tile, one layer (every pass), LRCP, the default
    precincts: code-blocks of 2^cblk[0] x 2^cblk[1] in the given
    code-block style (LAZY | RESET | TERMALL | VSC | PTERM | SEGSYM), SOP
    and EPH markers as asked; roi=(y0, y1, x0, x1) shifts component 0's
    coefficients whose band position falls in that fraction of its band
    up by the smallest maxshift (RGN)."""
    import numpy as np

    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    guard = 2
    comps = []
    for c in range(nc):
        a = img[..., c].astype(np.int64) - 128
        rh, rw = h, w
        for _ in range(levels):
            sub = a[:rh, :rw]
            sub = np.array([_fdwt53_1d(list(col)) for col in sub.T]).T
            sub = np.array([_fdwt53_1d(list(row)) for row in sub])
            a[:rh, :rw] = sub
            rh, rw = (rh + 1) // 2, (rw + 1) // 2
        comps.append(a)
    # bands of each resolution: (orient, gain, y0, y1, x0, x1) in a
    res_bands = []
    sizes = [(h, w)]
    for _ in range(levels):
        sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
    lh, lw = sizes[levels]
    res_bands.append([(0, 0, 0, lh, 0, lw)])
    for lv in range(levels, 0, -1):
        fh, fw = sizes[lv - 1]
        sh, sw = sizes[lv]
        res_bands.append([(1, 1, 0, sh, sw, fw), (2, 1, sh, fh, 0, sw),
                          (3, 2, sh, fh, sw, fw)])
    roishift = 0
    if roi is not None:
        mask = np.zeros((h, w), bool)
        for bands in res_bands:
            for _, _, y0, y1, x0, x1 in bands:
                bh, bw = y1 - y0, x1 - x0
                mask[y0 + int(bh * roi[0]):y0 + int(bh * roi[1]),
                     x0 + int(bw * roi[2]):x0 + int(bw * roi[3])] = True
        bg = np.abs(comps[0][~mask]).max() if (~mask).any() else 0
        roishift = int(bg).bit_length()
        comps[0] = np.where(mask, comps[0] * (1 << roishift), comps[0])
    cw, ch = 1 << cblk[0], 1 << cblk[1]
    body, nsop = bytearray(), 0
    for bands in res_bands:
        for c in range(nc):
            bits, data = [1], bytearray()
            any_in = False
            for orient, gain, y0, y1, x0, x1 in bands:
                if y1 == y0 or x1 == x0:
                    continue
                band = comps[c][y0:y1, x0:x1]
                gw, gh = -(-(x1 - x0) // cw), -(-(y1 - y0) // ch)
                mb = 8 + gain + guard - 1        # expn + guard - 1
                shift = roishift if c == 0 else 0
                blocks = []
                for j in range(gh):
                    for i in range(gw):
                        blk = band[j * ch:(j + 1) * ch, i * cw:(i + 1) * cw]
                        p, segs = _cblk_passes(np.abs(blk), blk < 0, orient,
                                               style, shift)
                        blocks.append((p, segs))
                incl = _TagEnc(gw, gh, [0 if p else 1 for p, _ in blocks])
                zbp = _TagEnc(gw, gh, [max(0, mb + shift - p)
                                       for p, _ in blocks])
                for k, (p, segs) in enumerate(blocks):
                    incl.encode(bits, k, 1)
                    if not p:
                        continue
                    any_in = True
                    zbp.encode(bits, k, mb + shift - p + 1)
                    n = sum(np_ for _, np_ in segs)
                    if n == 1:
                        bits += [0]
                    elif n == 2:
                        bits += [1, 0]
                    elif n <= 5:
                        bits += [1, 1] + [(n - 3) >> 1 & 1, (n - 3) & 1]
                    elif n <= 36:
                        bits += [1, 1, 1, 1] + [(n - 6) >> i & 1
                                                for i in range(4, -1, -1)]
                    else:
                        bits += [1] * 9 + [(n - 37) >> i & 1
                                           for i in range(6, -1, -1)]
                    need = max(len(sb).bit_length() - (np_.bit_length() - 1)
                               for sb, np_ in segs)
                    inc = max(0, need - 3)
                    bits += [1] * inc + [0]
                    for sb, np_ in segs:
                        nb = 3 + inc + np_.bit_length() - 1
                        bits += [len(sb) >> i & 1 for i in range(nb - 1, -1,
                                                                   -1)]
                        data += sb
            if not any_in:
                bits = [0]
            head = _header_bytes(bits)
            if sop:
                body += struct.pack(">HHH", 0xFF91, 4, nsop & 0xFFFF)
            nsop += 1
            body += head + (b"\xff\x92" if eph else b"") + data
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + \
        b"".join(struct.pack(">BBB", 7, 1, 1) for _ in range(nc))
    cod = struct.pack(">BBHBBBBBB", (2 if sop else 0) | (4 if eph else 0),
                      0, 1, 0, levels, cblk[0] - 2, cblk[1] - 2, style, 1)
    qcd = bytes([guard << 5]) + bytes([(8 << 3)]) + b"".join(
        bytes([(9 << 3), (9 << 3), (10 << 3)]) for _ in range(levels))
    main = [(SIZ, siz), (COD, cod), (QCD, qcd)]
    if roishift:
        main.append((0xFF5E, bytes([0, 0, roishift])))
    return build(main, [(0, 0, None, [], bytes(body))])
