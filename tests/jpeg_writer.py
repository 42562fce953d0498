"""A JPEG writer for the decoder's tests: files that neither cv2 nor PIL
writes, made from quantized DCT coefficient blocks (or, for lossless
frames, from samples) that a test draws from a seeded generator.

    coefs = random_coefficients(rng, frame)
    data = write_jpeg(frame, coefs, scans=progressive_script(frame))

What it writes:

- sequential frames (SOF0/SOF1) with the components split over scans
  any way, interleaved scans coding their MCUs' padding blocks and
  single-component scans coding only the component's own blocks;
- progressive frames (SOF2) with any scan script: DC first and refine
  scans, AC first scans with EOB runs, AC refine scans with their
  correction bits, each as libjpeg's jcphuff.c codes them;
- arithmetic-coded frames (SOF9 sequential, SOF10 progressive) with
  jcarith.c's QM coder, optional DAC conditioning;
- 1 to 4 components with any sampling factors, a JFIF or an Adobe
  (transform 0, 1 or 2) marker or none, restart intervals that change
  between scans, DHT and DQT segments between scans;
- lossless frames (SOF3) and 12-bit frames, to probe what cv2 reads.

Huffman tables are each scan's optimal tables (jcphuff.c's
jpeg_gen_optimal_table), written before the scan. Test data only.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence

import numpy as np

# zigzag index -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
QE_TABLE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]


@dataclasses.dataclass
class Frame:
    """What a SOF segment says, and the tables the frame uses.
    sampling: (h, v) per component; qt: 64-entry tables in natural
    order, qt_of: each component's table; ids: component ids."""

    width: int
    height: int
    sampling: Sequence = ((1, 1),)
    qt: Sequence = ()
    qt_of: Sequence = ()
    ids: Optional[Sequence] = None
    precision: int = 8

    @property
    def ncomp(self) -> int:
        return len(self.sampling)

    @property
    def max_h(self) -> int:
        return max(h for h, _ in self.sampling)

    @property
    def max_v(self) -> int:
        return max(v for _, v in self.sampling)

    def mcus(self):
        """(MCUs across, MCUs down) of an interleaved scan."""
        return (-(-self.width // (8 * self.max_h)),
                -(-self.height // (8 * self.max_v)))

    def blocks(self, ci):
        """(blocks across, blocks down) of component ci's own samples."""
        h, v = self.sampling[ci]
        dw = -(-self.width * h // self.max_h)
        dh = -(-self.height * v // self.max_v)
        return -(-dw // 8), -(-dh // 8)

    def padded(self, ci):
        """(rows, cols) of component ci's blocks, padded to whole MCUs."""
        mx, my = self.mcus()
        h, v = self.sampling[ci]
        return my * v, mx * h


@dataclasses.dataclass
class Scan:
    comps: Sequence
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0
    restart: int = 0          # DRI written before this scan


def sequential_script(frame: Frame, groups=None, restart=0) -> List[Scan]:
    """One sequential scan per group of components (default: all in
    one scan)."""
    groups = groups or [list(range(frame.ncomp))]
    return [Scan(list(g), restart=restart) for g in groups]


def progressive_script(frame: Frame, restart=0, al=1) -> List[Scan]:
    """libjpeg's jpeg_simple_progression, at successive-approximation
    depth al: DC first at al (interleaved), AC 1-5 and 6-63 first at al
    per component, then the refinements down to bit 0."""
    n = frame.ncomp
    s = [Scan(list(range(n)), 0, 0, 0, al, restart)]
    for ci in range(n):
        s.append(Scan([ci], 1, 5, 0, al, restart))
    for ci in range(n):
        s.append(Scan([ci], 6, 63, 0, al, restart))
    for bit in range(al, 0, -1):
        s.append(Scan(list(range(n)), 0, 0, bit, bit - 1, restart))
        for ci in range(n):
            s.append(Scan([ci], 1, 63, bit, bit - 1, restart))
    return s


def random_coefficients(rng, frame: Frame, ac_scale=1.0, dc_range=60):
    """Quantized coefficient blocks per component, shaped (rows, cols,
    64) in natural order and padded to whole MCUs: a smooth DC field
    and AC values whose size and density fall with frequency."""
    out = []
    lim = 2047 if frame.precision == 8 else 32767
    for ci in range(frame.ncomp):
        rows, cols = frame.padded(ci)
        yy, xx = np.mgrid[0:rows, 0:cols]
        dc = (dc_range * np.sin(xx / 3.0 + ci) * np.cos(yy / 4.0)
              + rng.integers(-8, 9, (rows, cols)))
        if frame.precision == 12:
            dc = dc * 16
        blk = np.zeros((rows, cols, 64), np.int64)
        blk[..., 0] = np.round(dc)
        zz = np.arange(1, 64)
        keep = rng.random((rows, cols, 63)) < 0.6 * np.exp(-zz / 14.0)
        mag = np.ceil(rng.exponential(ac_scale * 6.0 * np.exp(-zz / 10.0),
                                      (rows, cols, 63)))
        sign = rng.choice([-1, 1], (rows, cols, 63))
        blk[..., NATURAL[1:]] = keep * mag * sign
        out.append(np.clip(blk, -lim, lim))
    return out


def default_qt(frame: Frame):
    qt = [np.array([max(1, 2 + (i // 8 + i % 8)) for i in range(64)]),
          np.array([max(1, 3 + 2 * (i // 8 + i % 8)) for i in range(64)])]
    return qt


# --------------------------------------------------------------- segments

def _seg(marker: int, body: bytes) -> bytes:
    return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body


def _dqt(qt, precision) -> bytes:
    body = b""
    for i, t in enumerate(qt):
        t = np.asarray(t)[NATURAL]
        if precision == 8 and t.max() < 256:
            body += bytes((i,)) + bytes(int(v) for v in t)
        else:
            body += bytes((0x10 | i,)) + b"".join(
                struct.pack(">H", int(v)) for v in t)
    return _seg(0xDB, body)


def _sof(marker, frame: Frame) -> bytes:
    ids = frame.ids or list(range(1, frame.ncomp + 1))
    body = struct.pack(">BHHB", frame.precision, frame.height, frame.width,
                       frame.ncomp)
    for ci, (h, v) in enumerate(frame.sampling):
        body += bytes((ids[ci], h << 4 | v,
                       frame.qt_of[ci] if frame.qt_of else 0))
    return _seg(marker, body)


def _app_markers(jfif, adobe) -> bytes:
    out = b""
    if jfif:
        out += _seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        out += _seg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes((adobe,)))
    return out


# ------------------------------------------------------------- bit output

class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = 0
                self.n = 0

    def flush(self) -> None:
        if self.n:
            self.bits((1 << (8 - self.n)) - 1, 8 - self.n)

    def marker(self, m: int) -> None:
        self.flush()
        self.out += bytes((0xFF, m))


def optimal_table(freq):
    """jpeg_gen_optimal_table: (bits[1..16], huffval) for 256 symbol
    counts, with the reserved all-ones code point."""
    freq = list(freq) + [1]
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1, v = -1, 10 ** 12
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        c2, v = -1, 10 ** 12
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [s for n in range(1, 33) for s in range(256) if codesize[s] == n]
    return bits[1:17], vals


def _codes(bits, vals):
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            codes[vals[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return codes


def _category(v: int) -> int:
    return abs(v).bit_length()


def _bits_of(v: int, n: int) -> int:
    return v if v >= 0 else (v - 1) & ((1 << n) - 1)


# ------------------------------------------------- scan MCU / block order

def _scan_blocks(frame: Frame, scan: Scan):
    """Per MCU, the (component, row, col) of each block it codes."""
    if len(scan.comps) == 1:
        ci = scan.comps[0]
        bw, bh = frame.blocks(ci)
        return [[(ci, r, c)] for r in range(bh) for c in range(bw)]
    mx, my = frame.mcus()
    mcus = []
    for r in range(my):
        for c in range(mx):
            m = []
            for ci in scan.comps:
                h, v = frame.sampling[ci]
                m += [(ci, r * v + y, c * h + x) for y in range(v)
                      for x in range(h)]
            mcus.append(m)
    return mcus


# ------------------------------------------------------ Huffman encoding

class _HuffScan:
    """Collects a scan's symbols and raw bits, then writes them with the
    scan's optimal tables (jcphuff.c's two passes)."""

    def __init__(self):
        self.events = []
        self.freq = {}
        self.eobrun = 0
        self.be = []          # correction bits waiting for the EOB run

    def sym(self, cls, tbl, s):
        self.events.append(("s", (cls, tbl), s))
        f = self.freq.setdefault((cls, tbl), [0] * 256)
        f[s] += 1

    def raw(self, v, n):
        if n:
            self.events.append(("b", v, n))

    def emit_eobrun(self, tbl):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.sym(1, tbl, n << 4)
            self.raw(self.eobrun & ((1 << n) - 1), n)
            self.eobrun = 0
            for b in self.be:
                self.raw(b, 1)
            self.be = []

    def restart(self, tbl, k):
        self.emit_eobrun(tbl)
        self.events.append(("r", k))

    def write(self, tables_first=True) -> bytes:
        tables = {key: optimal_table(f) for key, f in self.freq.items()}
        dht = b""
        for (cls, tbl), (bits, vals) in sorted(tables.items()):
            dht += bytes((cls << 4 | tbl,)) + bytes(bits) + bytes(vals)
        codes = {key: _codes(*t) for key, t in tables.items()}
        w = BitWriter()
        for e in self.events:
            if e[0] == "s":
                code, n = codes[e[1]][e[2]]
                w.bits(code, n)
            elif e[0] == "b":
                w.bits(e[1], e[2])
            else:
                w.marker(0xD0 + e[1])
        w.flush()
        return (_seg(0xC4, dht) if dht else b""), bytes(w.out)


def _huff_scan(frame, coefs, scan: Scan, progressive: bool):
    hs = _HuffScan()
    dc_tbl = {ci: min(ci, 1) for ci in scan.comps}
    ac_tbl = dc_tbl
    last = {ci: 0 for ci in scan.comps}
    mcus = _scan_blocks(frame, scan)
    ac_t = ac_tbl[scan.comps[0]]
    for m, blocks in enumerate(mcus):
        if scan.restart and m and m % scan.restart == 0:
            hs.restart(ac_t, (m // scan.restart - 1) & 7)
            last = {ci: 0 for ci in scan.comps}
        for ci, r, c in blocks:
            blk = [int(v) for v in coefs[ci][r, c]]
            zz = [blk[NATURAL[k]] for k in range(64)]
            if not progressive or (scan.ss == 0 and scan.ah == 0):
                dc = zz[0] >> scan.al if progressive else zz[0]
                diff = dc - last[ci]
                last[ci] = dc
                n = _category(diff)
                hs.sym(0, dc_tbl[ci], n)
                hs.raw(_bits_of(diff, n), n)
                if progressive:
                    continue
                run = 0
                for k in range(1, 64):
                    v = zz[k]
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        hs.sym(1, ac_tbl[ci], 0xF0)
                        run -= 16
                    n = _category(v)
                    hs.sym(1, ac_tbl[ci], run << 4 | n)
                    hs.raw(_bits_of(v, n), n)
                    run = 0
                if run:
                    hs.sym(1, ac_tbl[ci], 0)
            elif scan.ss == 0:
                hs.raw((zz[0] >> scan.al) & 1, 1)
            elif scan.ah == 0:
                _ac_first(hs, ac_tbl[ci], zz, scan)
            else:
                _ac_refine(hs, ac_tbl[ci], zz, scan)
    hs.emit_eobrun(ac_t)
    return hs.write()


def _ac_first(hs, tbl, zz, scan):
    run = 0
    for k in range(scan.ss, scan.se + 1):
        v = zz[k]
        t = abs(v) >> scan.al
        if t == 0:
            run += 1
            continue
        hs.emit_eobrun(tbl)
        while run > 15:
            hs.sym(1, tbl, 0xF0)
            run -= 16
        n = t.bit_length()
        hs.sym(1, tbl, run << 4 | n)
        hs.raw(t if v >= 0 else (~t) & ((1 << n) - 1), n)
        run = 0
    if run:
        hs.eobrun += 1
        if hs.eobrun == 0x7FFF:
            hs.emit_eobrun(tbl)


def _ac_refine(hs, tbl, zz, scan):
    absv = {k: abs(zz[k]) >> scan.al for k in range(scan.ss, scan.se + 1)}
    eob = 0
    for k, t in absv.items():
        if t == 1:
            eob = k
    run, br = 0, []
    for k in range(scan.ss, scan.se + 1):
        t = absv[k]
        if t == 0:
            run += 1
            continue
        while run > 15 and k <= eob:
            hs.emit_eobrun(tbl)
            hs.sym(1, tbl, 0xF0)
            run -= 16
            for b in br:
                hs.raw(b, 1)
            br = []
        if t > 1:
            br.append(t & 1)
            continue
        hs.emit_eobrun(tbl)
        hs.sym(1, tbl, run << 4 | 1)
        hs.raw(0 if zz[k] < 0 else 1, 1)
        for b in br:
            hs.raw(b, 1)
        br = []
        run = 0
    if run or br:
        hs.eobrun += 1
        hs.be += br
        if hs.eobrun == 0x7FFF or len(hs.be) > 1000 - 64 + 1:
            hs.emit_eobrun(tbl)


# --------------------------------------------------- arithmetic encoding

class _QM:
    """jcarith.c's encoder: registers, byte stacking, termination."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        self.zc = 0


def _arith_scan(frame, coefs, scan: Scan, progressive: bool, dac):
    L, U, K = dac
    qm = _QM()
    fixed = [113]
    tbl = {ci: min(ci, 1) for ci in scan.comps}

    def fresh():
        return ({t: [0] * 64 for t in set(tbl.values())},
                {t: [0] * 256 for t in set(tbl.values())},
                {ci: 0 for ci in scan.comps}, {ci: 0 for ci in scan.comps})

    dc_stats, ac_stats, last, ctx = fresh()

    def magnitude(st, i, v, stats, x1):
        """Figures F.8 and F.9 from bin st[i]; v is |value| - 1."""
        m = 0
        if v:
            qm.encode(st, i, 1)
            m = 1
            v2 = v
            st, i = stats, x1
            while True:
                v2 >>= 1
                if not v2:
                    break
                qm.encode(st, i, 1)
                m <<= 1
                i += 1
        qm.encode(st, i, 0)
        return m, st, i

    def dc(ci, value):
        t = tbl[ci]
        st, i = dc_stats[t], ctx[ci]
        v = value - last[ci]
        if v == 0:
            qm.encode(st, i, 0)
            ctx[ci] = 0
            return
        last[ci] = value
        qm.encode(st, i, 1)
        if v > 0:
            qm.encode(st, i + 1, 0)
            i += 2
            ctx[ci] = 4
        else:
            v = -v
            qm.encode(st, i + 1, 1)
            i += 3
            ctx[ci] = 8
        v -= 1
        m, st, i = magnitude(st, i, v, dc_stats[t], 20)
        if m < (1 << L[t]) >> 1:
            ctx[ci] = 0
        elif m > (1 << U[t]) >> 1:
            ctx[ci] += 8
        i += 14
        while True:
            m >>= 1
            if not m:
                break
            qm.encode(st, i, 1 if m & v else 0)

    def ac_value(st, i, v, t, k):
        """Sign, magnitude category and bits of a nonzero v at bin i."""
        qm.encode(fixed, 0, 0 if v > 0 else 1)
        v = abs(v) - 1
        i += 2
        m = 0
        if v:
            qm.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                qm.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= K[t] else 217
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    qm.encode(st, i, 1)
                    m <<= 1
                    i += 1
        qm.encode(st, i, 0)
        i += 14
        while True:
            m >>= 1
            if not m:
                break
            qm.encode(st, i, 1 if m & v else 0)

    def ac(ci, zz, ss, se, al):
        t = tbl[ci]
        st = ac_stats[t]
        vals = [0] * 64
        for k in range(ss, se + 1):
            a = abs(zz[k]) >> al
            vals[k] = a if zz[k] >= 0 else -a
        ke = se
        while ke > 0 and vals[ke] == 0:
            ke -= 1
        k = ss - 1
        while k < ke:
            i = 3 * k
            qm.encode(st, i, 0)
            while True:
                k += 1
                if vals[k]:
                    qm.encode(st, i + 1, 1)
                    break
                qm.encode(st, i + 1, 0)
                i += 3
            ac_value(st, i, vals[k], t, k)
        if k < se:
            qm.encode(st, 3 * k, 1)

    def ac_refine(ci, zz, ss, se, ah, al):
        t = tbl[ci]
        st = ac_stats[t]
        absal = [abs(v) >> al for v in zz]
        ke = se
        while ke > 0 and not absal[ke]:
            ke -= 1
        kex = ke
        while kex > 0 and not (abs(zz[kex]) >> ah):
            kex -= 1
        k = ss - 1
        while k < ke:
            i = 3 * k
            if k >= kex:
                qm.encode(st, i, 0)
            while True:
                k += 1
                v = absal[k]
                if v:
                    if v >> 1:
                        qm.encode(st, i + 2, v & 1)
                    else:
                        qm.encode(st, i + 1, 1)
                        qm.encode(fixed, 0, 0 if zz[k] > 0 else 1)
                    break
                qm.encode(st, i + 1, 0)
                i += 3
        if k < se:
            qm.encode(st, 3 * k, 1)

    mcus = _scan_blocks(frame, scan)
    for m, blocks in enumerate(mcus):
        if scan.restart and m and m % scan.restart == 0:
            qm.finish()
            qm.out += bytes((0xFF, 0xD0 + ((m // scan.restart - 1) & 7)))
            qm.reset()
            dc_stats, ac_stats, last, ctx = fresh()
            fixed = [113]
        for ci, r, c in blocks:
            blk = [int(v) for v in coefs[ci][r, c]]
            zz = [blk[NATURAL[k]] for k in range(64)]
            if not progressive:
                dc(ci, zz[0])
                ac(ci, zz, 1, 63, 0)
            elif scan.ss == 0 and scan.ah == 0:
                dc(ci, zz[0] >> scan.al)
            elif scan.ss == 0:
                qm.encode(fixed, 0, (zz[0] >> scan.al) & 1)
            elif scan.ah == 0:
                ac(ci, zz, scan.ss, scan.se, scan.al)
            else:
                ac_refine(ci, zz, scan.ss, scan.se, scan.ah, scan.al)
    qm.finish()
    return b"", bytes(qm.out)


# ------------------------------------------------------------------ file

def write_jpeg(frame: Frame, coefs, scans: Optional[List[Scan]] = None, *,
               progressive=False, arithmetic=False, jfif=True, adobe=None,
               dac=None, extended=None, app=b"", late_dqt=False) -> bytes:
    """A JPEG file of frame's coefficient blocks (random_coefficients'
    layout) coded by scans. dac: {table: (L, U, K)} written as a DAC
    segment (arithmetic only); extended: SOF1 rather than SOF0 for a
    Huffman sequential frame (default: when precision is 12); late_dqt:
    each quantization table but the first written just before the first
    scan of a component that uses it."""
    if not frame.qt:
        frame.qt = default_qt(frame)
        frame.qt_of = [min(ci, 1) for ci in range(frame.ncomp)]
    if scans is None:
        scans = (progressive_script(frame) if progressive
                 else sequential_script(frame))
    if arithmetic:
        marker = 0xCA if progressive else 0xC9
    elif progressive:
        marker = 0xC2
    else:
        ext = frame.precision != 8 if extended is None else extended
        marker = 0xC1 if ext else 0xC0
    L, U, K = [0] * 16, [1] * 16, [5] * 16
    out = b"\xff\xd8" + _app_markers(jfif, adobe) + app
    pending = list(range(1, len(frame.qt))) if late_dqt else []
    tables = frame.qt[:1] if late_dqt else frame.qt
    out += _dqt(tables, frame.precision)
    out += _sof(marker, frame)
    if dac:
        body = b""
        for t, (lo, up, k) in sorted(dac.items()):
            body += bytes((t, up << 4 | lo, 16 + t, k))
            L[t], U[t], K[t] = lo, up, k
        out += _seg(0xCC, body)
    ids = frame.ids or list(range(1, frame.ncomp + 1))
    restart = 0
    for scan in scans:
        for t in sorted({frame.qt_of[ci] for ci in scan.comps}):
            if t in pending:
                body = _dqt([frame.qt[t]], frame.precision)
                out += body[:4] + bytes((body[4] | t,)) + body[5:]
                pending.remove(t)
        if scan.restart != restart:
            out += _seg(0xDD, struct.pack(">H", scan.restart))
            restart = scan.restart
        if arithmetic:
            dht, data = _arith_scan(frame, coefs, scan, progressive,
                                    (L, U, K))
        else:
            dht, data = _huff_scan(frame, coefs, scan, progressive)
        sos = bytes((len(scan.comps),))
        for ci in scan.comps:
            t = min(ci, 1)
            sos += bytes((ids[ci], t << 4 | t))
        sos += bytes((scan.ss, scan.se, scan.ah << 4 | scan.al))
        out += dht + _seg(0xDA, sos) + data
    return out + b"\xff\xd9"


def _lossless_predict(s, r, first, predictor, init):
    """The predictions of row r of plane s: jdpred.c's first-row
    predictor (init, then the left sample) or predictor 1-7, whose first
    column takes the sample above."""
    row = s[r]
    if first:
        return np.concatenate(([init], row[:-1]))
    up = s[r - 1]
    if len(row) == 1:
        return up.copy()
    a, b, c = row[:-1], up[1:], up[:-1]
    p = {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
         6: b + ((a - c) >> 1), 7: (a + b) >> 1}[predictor]
    return np.concatenate(([up[0]], p))


def _lossless_scan(planes, frame: Frame, comps, predictor, pt, restart):
    """One lossless scan as jddiffct.c decodes it: MCU rows grouped in
    iMCU rows (one MCU row if interleaved, else v sample rows of the
    component); a restart every restart / MCUs-per-row MCU rows resets
    the predictors, which take effect at the first row the iMCU row
    undifferences; samples past a plane's edge in an MCU code 0."""
    s = {ci: np.asarray(planes[ci], np.int64) >> pt for ci in comps}
    init = 1 << (frame.precision - pt - 1)
    if len(comps) > 1:
        across, down = (-(-frame.width // frame.max_h),
                        -(-frame.height // frame.max_v))
        imcu = [[r] for r in range(down)]
    else:
        dh, across = s[comps[0]].shape
        v = frame.sampling[comps[0]][1]
        imcu = [list(range(r, min(r + v, dh))) for r in range(0, dh, v)]
    hs = _HuffScan()
    first = set(comps)
    per = restart // across if restart else 0
    to_go, rst = per, 0
    for mrows in imcu:
        marks = []
        for k in range(len(mrows)):
            if per and to_go == 0:
                marks.append(k)
                first = set(comps)
                to_go = per
            to_go -= 1 if per else 0
        diffs = {}
        for ci in comps:
            v = frame.sampling[ci][1] if len(comps) > 1 else 1
            rows = range(mrows[0] * v, min(mrows[0] * v + v * len(mrows),
                                           s[ci].shape[0]))
            for r in rows:
                p = _lossless_predict(s[ci], r, ci in first, predictor, init)
                first.discard(ci)
                diffs[ci, r] = (s[ci][r] - p) & 0xFFFF
        for k, mr in enumerate(mrows):
            if k in marks:
                hs.restart(0, rst)
                rst = (rst + 1) & 7
            for mc in range(across):
                for ci in comps:
                    h, v = (frame.sampling[ci] if len(comps) > 1
                            else (1, 1))
                    for y in range(mr * v, mr * v + v):
                        for x in range(mc * h, mc * h + h):
                            d = 0
                            if (ci, y) in diffs and x < s[ci].shape[1]:
                                d = int(diffs[ci, y][x])
                                d = d - 0x10000 if d >= 0x8000 else d
                            n = _category(d)
                            hs.sym(0, 0, n)
                            if n < 16:
                                hs.raw(_bits_of(d, n), n)
    return hs.write()


def write_lossless(samples, precision=8, predictor=1, pt=0,
                   sampling=None, scans=None, restart=0,
                   adobe=None) -> bytes:
    """A lossless (SOF3) file, Huffman coded with predictor 1-7 and
    point transform pt. samples: (H, W, C) full-size components, or a
    list of 2-D planes, one a component, each of its downsampled size
    (ceil(W h / max_h) x ceil(H v / max_v)); sampling: (h, v) of each
    component; scans: the component groups, one scan each (default: all
    in one interleaved scan); restart: the restart interval in MCUs, or
    one a scan; adobe: an Adobe marker's transform in place of the JFIF
    marker."""
    if isinstance(samples, np.ndarray):
        planes = [samples[..., ci] for ci in range(samples.shape[2])]
    else:
        planes = list(samples)
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    mh = max(hh for hh, _ in sampling)
    mv = max(vv for _, vv in sampling)
    w = max(np.shape(p)[1] for p, (hh, _) in zip(planes, sampling)
            if hh == mh)
    h = max(np.shape(p)[0] for p, (_, vv) in zip(planes, sampling)
            if vv == mv)
    frame = Frame(w, h, sampling, qt=[np.ones(64, np.int64)],
                  qt_of=[0] * nc, precision=precision)
    out = (b"\xff\xd8" + _app_markers(adobe is None, adobe)
           + _sof(0xC3, frame))
    scans = scans or [list(range(nc))]
    if np.ndim(restart) == 0:
        restart = [restart] * len(scans)
    last = 0
    for comps, ri in zip(scans, restart):
        dht, data = _lossless_scan(planes, frame, list(comps), predictor,
                                   pt, ri)
        if ri != last:
            out += _seg(0xDD, struct.pack(">H", ri))
            last = ri
        sos = bytes((len(comps),)) + b"".join(bytes((ci + 1, 0))
                                              for ci in comps)
        sos += bytes((predictor, 0, pt))
        out += dht + _seg(0xDA, sos) + data
    return out + b"\xff\xd9"
