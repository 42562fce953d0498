#!/usr/bin/env python3
"""Write yolo_tpu_torch/native/av1_tables.h: the constant tables of AV1's
intra decoding (default CDFs, quantizer lookups and matrices, scans,
coefficient contexts, intra and CDEF taps, transform constants), as
libaom 3.14.1 holds them, for the port's own AVIF decoder.

    python3 tools/av1_tables.py [--libaom PATH] [--dav1d PATH] [--check]

Needs the libaom shared library that opencv-python bundles (its symbol
table names each table) and, for the cross-check, a libdav1d; neither is
needed to build or run the decoder, which reads the committed header.
Each table is taken by its symbol and checked against its opening values
and length; the few CDFs that libaom keeps only as immediates in code
are read from the frame context av1_init_mode_probs fills, found by their
opening values. libaom keeps a coefficient's index column by column
(index = col * height + row); the header keeps it row by row, as the
decoder (and the AV1 specification) index it. Every CDF row of two or
more values that libdav1d also holds (inverted as libaom holds them) is
looked for there, and the count printed. --check compares the header on
disk with what this run would write.

libaom and libdav1d are BSD-2-Clause.
"""

import argparse
import ctypes
import ctypes.util
import glob
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "yolo_tpu_torch", "native", "av1_tables.h")

# TX_SIZES_ALL in libaom's order: (width, height)
TX_DIMS = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
           (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
           (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]


def adjusted(w, h):
    return min(w, 32), min(h, 32)


class Lib:
    """A shared library's bytes, symbols (by name: [(vaddr, size)]) and
    load segments."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        self.syms = {}
        out = subprocess.run(["nm", "-S", path], capture_output=True,
                             text=True, check=True).stdout
        for line in out.splitlines():
            p = line.split()
            if len(p) == 4:
                self.syms.setdefault(p[3], []).append(
                    (int(p[0], 16), int(p[1], 16)))
        hdr = subprocess.run(["readelf", "-lW", path], capture_output=True,
                             text=True, check=True).stdout
        self.loads = []
        for line in hdr.splitlines():
            f = line.split()
            if f and f[0] == "LOAD":
                self.loads.append((int(f[1], 16), int(f[2], 16),
                                   int(f[4], 16)))

    def offset(self, va):
        for off, v, size in self.loads:
            if v <= va < v + size:
                return va - v + off
        raise KeyError(hex(va))

    def get(self, name, dtype, count=None, index=0):
        va, size = self.syms[name][index]
        dt = np.dtype(dtype)
        n = size // dt.itemsize if count is None else count
        if n * dt.itemsize > size:
            raise ValueError(f"{name}: {size} bytes, want {n} x {dtype}")
        o = self.offset(va)
        return np.frombuffer(self.data[o:o + n * dt.itemsize], dt).copy()


def frame_context(lib: Lib) -> np.ndarray:
    """The uint16 image of the FRAME_CONTEXT av1_init_mode_probs fills
    (the mode CDFs libaom keeps as immediates in its code)."""
    so = ctypes.CDLL(lib.path)
    exported = ctypes.cast(so.aom_codec_av1_dx, ctypes.c_void_p).value
    base = exported - lib.syms["aom_codec_av1_dx"][0][0]
    # the symbol table's 't' entries carry no size in nm -S's 4-field
    # form for every function; read the address from nm's plain listing
    out = subprocess.run(["nm", lib.path], capture_output=True, text=True,
                         check=True).stdout
    addr = next(int(line.split()[0], 16) for line in out.splitlines()
                if line.endswith(" av1_init_mode_probs"))
    buf = (ctypes.c_uint16 * 65536)()
    ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + addr)(
        ctypes.addressof(buf))
    return np.array(buf, np.uint16), so, base


def find(hay: np.ndarray, opening) -> int:
    v = np.asarray(opening, hay.dtype)
    hits = [i for i in np.nonzero(hay == v[0])[0]
            if i + len(v) <= len(hay) and (hay[i:i + len(v)] == v).all()]
    if len(hits) != 1:
        raise SystemExit(f"opening {list(opening)[:6]}: {len(hits)} hits")
    return int(hits[0])


def check_cdf(name, arr, nsym):
    """Each row: nsym - 1 or fewer decreasing probabilities, then zeros
    (the terminal ICDF(32768), the counter, padding)."""
    rows = arr.reshape(-1, arr.shape[-1])
    for r in rows:
        nz = np.nonzero(r)[0]
        k = len(nz)
        if k and (nz[-1] != k - 1 or k > nsym - 1
                  or not (np.diff(r[:k].astype(int)) < 0).all()):
            raise SystemExit(f"{name}: malformed CDF row {list(r)}")


def col_to_row(a: np.ndarray, w: int, h: int) -> np.ndarray:
    """A per-coefficient table indexed col * h + row -> row * w + col."""
    return a.reshape(w, h).T.reshape(-1)


def scan_to_row(scan: np.ndarray, w: int, h: int) -> np.ndarray:
    """libaom's scan (positions col * h + row) in row-major positions."""
    col, row = scan // h, scan % h
    return row * w + col


def tables(lib: Lib):
    """[(C declaration, numpy array, dav1d-checkable CDF rows)]"""
    fc, so, base = frame_context(lib)
    out = []

    def add(decl, arr, cdf_rows=False):
        dims = [int(v) for v in decl.replace("]", "").split("[")[1:]]
        out.append((decl, np.asarray(arr).reshape(dims), cdf_rows))

    def named_cdf(sym, shape, nsym, opening):
        a = lib.get(sym, np.uint16)
        if a.size != int(np.prod(shape)):
            raise SystemExit(f"{sym}: {a.size} values, want {shape}")
        if list(a[:len(opening)]) != list(opening):
            raise SystemExit(f"{sym}: opens {list(a[:8])}")
        a = a.reshape(shape)
        check_cdf(sym, a, nsym)
        return a

    def fc_cdf(shape, nsym, opening, at=None):
        i = find(fc, opening) if at is None else at
        a = fc[i:i + int(np.prod(shape))].reshape(shape)
        check_cdf(f"frame context @{i}", a, nsym)
        return a, i

    q = 4
    add("uint16_t av1_kf_y_mode_cdf[5][5][14]", named_cdf(
        "default_kf_y_mode_cdf", (5, 5, 14), 13, [17180, 15741, 13430]), 1)
    add("uint16_t av1_uv_mode_cdf[2][13][15]", named_cdf(
        "default_uv_mode_cdf", (2, 13, 15), 14, [10137, 8616, 7390]), 1)
    add("uint16_t av1_partition_cdf[20][11]", named_cdf(
        "default_partition_cdf", (20, 11), 10, [13636, 7258, 2376]), 1)
    for p in ("y", "uv"):
        add(f"uint16_t av1_palette_{p}_color_cdf[7][5][9]", named_cdf(
            f"default_palette_{p}_color_index_cdf", (7, 5, 9), 8,
            [4058, 0, 0] if p == "y" else [3679, 0, 0]), 1)
    add("uint16_t av1_inter_ext_tx_cdf[4][4][17]", named_cdf(
        "default_inter_ext_tx_cdf", (4, 4, 17), 16, [0] * 17), 1)
    # the MV context (joints; per component: classes, class0_fp, fp, sign,
    # class0_hp, hp, class0, bits), which intra block copy's DVs start from
    nmv = lib.get("default_nmv_context", np.uint16)
    if nmv.size != 143 or list(nmv[:5]) != [28672, 21504, 13440, 0, 0]:
        raise SystemExit("default_nmv_context")
    for lo, hi, n in ((0, 5, 4), (5, 17, 11), (74, 86, 11)):
        check_cdf("default_nmv_context", nmv[lo:hi], n)
    add("uint16_t av1_nmv_cdf[143]", nmv)
    add("uint16_t av1_intra_ext_tx_cdf[3][4][13][17]", named_cdf(
        "default_intra_ext_tx_cdf", (3, 4, 13, 17), 16, [0] * 17), 1)
    add("uint16_t av1_txb_skip_cdf[4][5][13][3]", named_cdf(
        "av1_default_txb_skip_cdfs", (q, 5, 13, 3), 2, [919, 0, 0, 26876]), 1)
    add("uint16_t av1_eob_extra_cdf[4][5][2][9][3]", named_cdf(
        "av1_default_eob_extra_cdfs", (q, 5, 2, 9, 3), 2, [15807, 0, 0, 15545]), 1)
    add("uint16_t av1_dc_sign_cdf[4][2][3][3]", named_cdf(
        "av1_default_dc_sign_cdfs", (q, 2, 3, 3), 2, [16768, 0, 0, 19712]), 1)
    for n, (shape, opening) in {
            16: ((q, 2, 2, 6), [31928, 31729]), 32: ((q, 2, 2, 7), [32368, 32248]),
            64: ((q, 2, 2, 8), [32439, 32270]), 128: ((q, 2, 2, 9), [32549, 32286]),
            256: ((q, 2, 2, 10), [32458, 32184]), 512: ((q, 2, 2, 11), [32127, 31785]),
            1024: ((q, 2, 2, 12), [32375, 32347])}.items():
        dims = "".join(f"[{d}]" for d in shape)
        add(f"uint16_t av1_eob_multi{n}_cdf{dims}", named_cdf(
            f"av1_default_eob_multi{n}_cdfs", shape, shape[-1] - 1,
            opening), 1)
    add("uint16_t av1_coeff_base_eob_cdf[4][5][2][4][4]", named_cdf(
        "av1_default_coeff_base_eob_multi_cdfs", (q, 5, 2, 4, 4), 3,
        [14931, 3713, 0, 0]), 1)
    add("uint16_t av1_coeff_base_cdf[4][5][2][42][5]", named_cdf(
        "av1_default_coeff_base_multi_cdfs", (q, 5, 2, 42, 5), 4,
        [28734, 23838, 20041, 0, 0]), 1)
    add("uint16_t av1_coeff_br_cdf[4][5][2][21][5]", named_cdf(
        "av1_default_coeff_lps_multi_cdfs", (q, 5, 2, 21, 5), 4,
        [18470, 12050, 8594, 0, 0]), 1)

    skip, _ = fc_cdf((3, 3), 2, [1097, 0, 0, 16253, 0, 0, 28192, 0, 0])
    add("uint16_t av1_skip_cdf[3][3]", skip, 1)
    fim, at = fc_cdf((6,), 5, [23819, 19992, 15557, 3210, 0, 0])
    add("uint16_t av1_filter_intra_mode_cdf[6]", fim, 1)
    # filter_intra_cdfs[BLOCK_SIZES_ALL] sits just before it in the struct
    fi, _ = fc_cdf((22, 3), 2, None, at=at - 66)
    if fi[0, 0] != 28147:
        raise SystemExit(f"filter_intra_cdfs open {list(fi[0])}")
    add("uint16_t av1_filter_intra_cdf[22][3]", fi, 1)
    ad, _ = fc_cdf((8, 8), 7, [30588, 27736, 25201, 9992, 5779, 2551, 0, 0])
    add("uint16_t av1_angle_delta_cdf[8][8]", ad, 1)
    tx, at = fc_cdf((4, 3, 4), 3, [12800, 0, 0, 0, 12800, 0, 0, 0, 8448])
    add("uint16_t av1_tx_size_cdf[4][3][4]", tx, 1)
    # delta_q_cdf follows tx_size_cdf (delta_lf's copies of it after)
    dq, _ = fc_cdf((5,), 4, None, at=at + 48)
    if list(dq) != [4608, 648, 91, 0, 0]:
        raise SystemExit(f"delta_q_cdf {list(dq)}")
    add("uint16_t av1_delta_q_cdf[5]", dq, 1)
    ibc, _ = fc_cdf((3,), 2, [2237, 0, 0])
    add("uint16_t av1_intrabc_cdf[3]", ibc, 1)
    txp, _ = fc_cdf((21, 3), 2, [4187, 0, 0, 8922, 0, 0])
    add("uint16_t av1_txfm_partition_cdf[21][3]", txp, 1)
    ps, _ = fc_cdf((7, 8), 7, [24816, 19768, 14619, 11290, 7241, 3527, 0, 0])
    add("uint16_t av1_palette_y_size_cdf[7][8]", ps, 1)
    ps, _ = fc_cdf((7, 8), 7, [24055, 12789, 5640, 3159, 1437, 496, 0, 0])
    add("uint16_t av1_palette_uv_size_cdf[7][8]", ps, 1)
    pm, _ = fc_cdf((7, 3, 3), 2, [1092, 0, 0, 29349, 0, 0, 31507, 0, 0])
    add("uint16_t av1_palette_y_mode_cdf[7][3][3]", pm, 1)
    pm, _ = fc_cdf((2, 3), 2, [307, 0, 0, 11280, 0, 0])
    add("uint16_t av1_palette_uv_mode_cdf[2][3]", pm, 1)
    cs, at = fc_cdf((9,), 8, [31350, 30645, 19428, 14363, 5796, 4425, 474])
    add("uint16_t av1_cfl_sign_cdf[9]", cs, 1)
    ca, _ = fc_cdf((6, 17), 16, None, at=at + 9)
    if list(ca[0, :3]) != [25131, 12049, 1367]:
        raise SystemExit(f"cfl_alpha opens {list(ca[0, :4])}")
    add("uint16_t av1_cfl_alpha_cdf[6][17]", ca, 1)

    dcq = lib.get("dc_qlookup_QTX", np.int16)
    acq = lib.get("ac_qlookup_QTX", np.int16)
    if list(dcq[:6]) != [4, 8, 8, 9, 10, 11] or dcq.size != 256:
        raise SystemExit("dc_qlookup_QTX")
    if list(acq[:6]) != [4, 8, 9, 10, 11, 12] or acq.size != 256:
        raise SystemExit("ac_qlookup_QTX")
    add("int16_t av1_dc_qlookup[256]", dcq)
    add("int16_t av1_ac_qlookup[256]", acq)

    # quantizer matrices: [level][luma, chroma][3344] in TX_SIZES_ALL order
    # without the 64-point sizes, each converted to row-major
    iwt = lib.get("iwt_matrix_ref", np.uint8).reshape(15, 2, 3344)
    qm = np.empty_like(iwt)
    offsets = [0] * len(TX_DIMS)
    cur = 0
    for t, (w, h) in enumerate(TX_DIMS):
        if adjusted(w, h) != (w, h):
            continue
        offsets[t] = cur
        for lv in range(15):
            for c in range(2):
                qm[lv, c, cur:cur + w * h] = col_to_row(
                    iwt[lv, c, cur:cur + w * h], w, h)
        cur += w * h
    for t, (w, h) in enumerate(TX_DIMS):
        offsets[t] = offsets[TX_DIMS.index(adjusted(w, h))]
    if cur != 3344 or qm[0, 0, 0] != 32:
        raise SystemExit("iwt_matrix_ref")
    add("uint8_t av1_qm[15][2][3344]", qm)
    add("uint16_t av1_qm_offset[19]", np.array(offsets, np.uint16))

    # scans (row-major positions) for the sizes up to 32 x 32, by tx size;
    # the 64-point sizes use their adjusted size's
    def tx_name(w, h):
        return f"{w}x{h}"

    scans = {}
    for kind in ("default", "mrow", "mcol"):
        for t, (w, h) in enumerate(TX_DIMS):
            if adjusted(w, h) != (w, h):
                continue
            s = lib.get(f"{kind}_scan_{tx_name(w, h)}", np.int16)
            if s.size != w * h or sorted(s) != list(range(w * h)):
                raise SystemExit(f"{kind}_scan_{tx_name(w, h)}")
            scans[kind, t] = scan_to_row(s.astype(np.int64), w, h)
    if list(scans["default", 0]) != [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10,
                                     7, 11, 14, 15]:
        raise SystemExit("default_scan_4x4")
    flat, soff = [], []
    for kind in ("default", "mrow", "mcol"):
        row = []
        for t, (w, h) in enumerate(TX_DIMS):
            key = (kind, TX_DIMS.index(adjusted(w, h)))
            if key[1] == t:
                row.append(sum(len(f) for f in flat))
                flat.append(scans[key])
            else:
                row.append(None)
        soff.append(row)
    for row in soff:
        for t, (w, h) in enumerate(TX_DIMS):
            if row[t] is None:
                row[t] = row[TX_DIMS.index(adjusted(w, h))]
    add(f"uint16_t av1_scans[{sum(len(f) for f in flat)}]",
        np.concatenate(flat).astype(np.uint16))
    add("uint16_t av1_scan_offset[3][19]", np.array(soff, np.uint16))

    # coefficient base context offsets by tx size (row-major positions of
    # the adjusted size), resolved through libaom's pointer table
    ptr_va = lib.syms["av1_nz_map_ctx_offset"][0][0]
    ptrs = (ctypes.c_uint64 * 19).from_address(base + ptr_va)
    by_addr = {base + va: n for n, lst in lib.syms.items()
               if n.startswith("av1_nz_map_ctx_offset_") for va, _ in lst}
    nz = np.zeros((19, 1024), np.uint8)
    for t, (w, h) in enumerate(TX_DIMS):
        aw, ah = adjusted(w, h)
        name = by_addr[ptrs[t]]
        a = lib.get(name, np.int8, aw * ah).astype(np.uint8)
        nz[t, :aw * ah] = col_to_row(a, aw, ah)
    if list(nz[5, :4]) != [0, 11, 11, 11]:
        raise SystemExit("av1_nz_map_ctx_offset_4x8")
    add("uint8_t av1_nz_map_ctx_offset[19][1024]", nz)
    off1d = lib.get("nz_map_ctx_offset_1d", np.int32, 32)
    if list(off1d[:4]) != [26, 31, 36, 36]:
        raise SystemExit(f"nz_map_ctx_offset_1d opens {list(off1d[:4])}")
    add("uint8_t av1_nz_map_ctx_offset_1d[32]", off1d.astype(np.uint8))

    def small(sym, dtype, n, decl, opening):
        a = lib.get(sym, dtype, n)
        if list(a[:len(opening)]) != list(opening):
            raise SystemExit(f"{sym}: opens {list(a[:8])}")
        add(decl, a)

    small("av1_palette_color_index_context_lookup", np.int32, 9,
          "int32_t av1_palette_color_context[9]", [-1, -1, 0, -1, -1, 4])
    small("dr_intra_derivative", np.int16, 90,
          "int16_t av1_dr_intra_derivative[90]", [0, 0, 0, 1023, 0, 0, 547])
    small("smooth_weights", np.uint8, 124, "uint8_t av1_smooth_weights[124]",
          [255, 149, 85, 64, 255, 197])
    small("av1_filter_intra_taps", np.int8, 320,
          "int8_t av1_filter_intra_taps[5][8][8]", [-6, 10, 0, 0, 0, 12])
    small("mode_to_angle_map", np.uint8, 13,
          "uint8_t av1_mode_to_angle[13]", [0, 90, 180, 45, 135, 113])
    small("intra_mode_context", np.int32, 13,
          "int32_t av1_intra_mode_context[13]", [0, 1, 2, 3, 4, 4, 4, 4, 3])
    small("fimode_to_intradir", np.uint8, 5,
          "uint8_t av1_fimode_to_intradir[5]", [0, 1, 2, 6, 0])
    small("_intra_mode_to_tx_type.1", np.uint8, 13,
          "uint8_t av1_mode_to_tx_type[13]", [0, 1, 2, 0, 3, 1, 2, 2, 1, 3])
    small("av1_ext_tx_inv", np.int32, 96, "int32_t av1_ext_tx_inv[6][16]",
          [0] * 16 + [9])
    small("av1_ext_tx_used", np.int32, 96, "int32_t av1_ext_tx_used[6][16]",
          [1] + [0] * 15 + [1])
    small("av1_num_ext_tx_set", np.int32, 6,
          "int32_t av1_num_ext_tx_set[6]", [1, 2, 5, 7, 12, 16])
    small("ext_tx_set_index", np.int32, 12,
          "int32_t av1_ext_tx_set_index[2][6]", [0, -1, 2, 1, -1, -1])
    small("vitx_1d_tab", np.uint8, 16, "uint8_t av1_vtx_1d[16]",
          [0, 1, 0, 1, 1, 0, 1, 1, 1, 2])
    small("hitx_1d_tab", np.uint8, 16, "uint8_t av1_htx_1d[16]",
          [0, 0, 1, 1, 0, 1, 1, 1, 1, 2])
    cos = lib.get("av1_cospi_arr_data", np.int32, 256).reshape(4, 64)[2]
    sin = lib.get("av1_sinpi_arr_data", np.int32, 20).reshape(4, 5)[2]
    if list(cos[:4]) != [4096, 4095, 4091, 4085] or list(sin) != [
            0, 1321, 2482, 3344, 3803]:
        raise SystemExit("cospi / sinpi")
    add("int32_t av1_cospi[64]", cos)
    add("int32_t av1_sinpi[5]", sin)
    shifts = []
    for w, h in TX_DIMS:
        shifts.append(-lib.get(f"inv_shift_{w}x{h}", np.int8, 2)[0])
    add("uint8_t av1_inv_row_shift[19]", np.array(shifts, np.uint8))
    # CDEF: libaom's offsets in a 144-wide buffer -> (row, col) steps
    d = lib.get("cdef_directions_padded", np.int32, 24).reshape(12, 2)[2:10]
    dirs = np.zeros((8, 2, 2), np.int8)
    for i in range(8):
        for k in range(2):
            v = int(d[i, k])
            dy = (v + 2 * 144 + 2) // 144 - 2
            dirs[i, k] = (dy, v - dy * 144)
    if dirs[0].tolist() != [[-1, 1], [-2, 2]]:
        raise SystemExit(f"cdef directions {dirs[0]}")
    add("int8_t av1_cdef_directions[8][2][2]", dirs)
    small("cdef_pri_taps", np.int32, 4, "int32_t av1_cdef_pri_taps[2][2]",
          [4, 2, 3, 3])
    small("cdef_sec_taps", np.int32, 2, "int32_t av1_cdef_sec_taps[2]",
          [2, 1])
    del so
    return out


def library_file(name: str) -> str:
    """The file of a shared library given by path or soname: loaded, then
    found in this process's memory map."""
    if os.path.exists(name):
        return name
    ctypes.CDLL(name)
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith(name):
                return path
    raise SystemExit(f"{name} is loaded but not mapped from a file")


def cross_check(rows_tables, dav1d_path):
    """(rows found, rows looked for) of every CDF row of >= 2 values."""
    with open(dav1d_path, "rb") as f:
        blob = f.read()
    found = total = 0
    for decl, arr, is_cdf in rows_tables:
        if not is_cdf:
            continue
        for r in arr.reshape(-1, arr.shape[-1]):
            k = int(np.count_nonzero(r))
            if k < 2:
                continue
            total += 1
            found += r[:k].astype("<u2").tobytes() in blob
    return found, total


def nested(a: np.ndarray, depth: int) -> list:
    """C initializer lines of a, one brace level per dimension."""
    pad = "  " * depth
    if a.ndim == 1:
        vals = [str(int(v)) for v in a]
        rows = [", ".join(vals[i:i + 16]) for i in range(0, len(vals), 16)]
        if len(rows) == 1:
            return [f"{pad}{{ {rows[0]} }}"]
        return [pad + "{"] + [f"{pad}  {r}," for r in rows] + [pad + "}"]
    out = [pad + "{"]
    for i, sub in enumerate(a):
        part = nested(sub, depth + 1)
        if i + 1 < len(a):
            part[-1] += ","
        out.extend(part)
    out.append(pad + "}")
    return out


def render(items, lib_path) -> str:
    lines = [
        "/* AV1's constant tables for the port's AVIF decoder (native/av1*.c),",
        " * as libaom 3.14.1 holds them (its symbols default_*_cdf,",
        " * av1_default_*_cdfs, dc_/ac_qlookup_QTX, iwt_matrix_ref, *_scan_*,",
        " * av1_nz_map_ctx_offset_*, dr_intra_derivative, smooth_weights,",
        " * av1_filter_intra_taps, cdef_*, av1_cospi/sinpi_arr_data, and the",
        " * frame context av1_init_mode_probs fills). libaom is BSD-2-Clause:",
        " * Copyright (c) 2016, Alliance for Open Media. All rights reserved.",
        " * Written by tools/av1_tables.py; do not edit.",
        " *",
        " * CDFs are inverted (32768 - cdf) with a trailing zero and an",
        " * adaptation counter, as libaom keeps them; per-coefficient tables",
        " * (scans, context offsets, quantizer matrices) are row-major. */",
        "#ifndef YOLO_AV1_TABLES_H",
        "#define YOLO_AV1_TABLES_H",
        "#include <stdint.h>",
        ""]
    for decl, arr, _ in items:
        lines.append(f"static const {decl} =")
        lines.extend(nested(np.asarray(arr), 0))
        lines[-1] += ";"
    lines.append("#endif")
    return "\n".join(lines) + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    libs = glob.glob(os.path.join(os.path.dirname(np.__file__), "..",
                                  "opencv_python.libs", "libaom-*.so.3.14.1"))
    ap.add_argument("--libaom", default=libs[0] if libs else None)
    ap.add_argument("--dav1d", default=ctypes.util.find_library("dav1d"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not args.libaom:
        raise SystemExit("no libaom 3.14.1 found; pass --libaom")
    lib = Lib(os.path.realpath(args.libaom))
    items = tables(lib)
    text = render(items, args.libaom)
    if args.dav1d:
        found, total = cross_check(items, library_file(args.dav1d))
        print(f"libdav1d holds {found} of {total} CDF rows of >= 2 values")
    if args.check:
        with open(OUT) as f:
            same = f.read() == text
        print("av1_tables.h matches" if same else "av1_tables.h DIFFERS")
        return 0 if same else 1
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT}: {len(items)} tables")
    return 0


if __name__ == "__main__":
    sys.exit(main())
