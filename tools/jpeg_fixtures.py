#!/usr/bin/env python3
"""Write the image parity fixtures of tests/data/torch_jpeg/ and the
hashes of what OpenCV decodes from them.

    python3 tools/jpeg_fixtures.py [--out tests/data/torch_jpeg]

Needs OpenCV and Pillow (the encoders; the card machine has neither).
Each fixture is encoded from a seeded image by cv2.imencode or PIL, or
from seeded coefficient blocks by the tests' own writers
(tests/jpeg_writer.py: multi-scan, smoothed progressive, YCCK and
arithmetic-coded JPEGs; tests/png_writer.py: an interlaced PNG), and
hashes.json records, for each file, the sha256 and shape of
cv2.imread(IMREAD_COLOR) after COLOR_BGR2RGB ("rgb") and of
cv2.imread(IMREAD_GRAYSCALE) ("gray"), null where cv2 gives no image of
those channels (a PFM read at the other channel count: the port raises
there). tests/test_torch_decode.py and chip_smoke.py hold the port's
decoder to those hashes; PROGRESSIVE_FRAME, TIFF_FRAME, WEBP_FRAME,
WEBP_LOSSLESS_FRAME, GIF_FRAME and HDR_FRAME are the 480x640 files
whose decode rates chip_smoke.py's phase 14 (c) reads.
The BMP, PNM, TIFF and
WebP files (tests/bmp_writer.py and PIL write the ones cv2 does not),
two damaged JPEGs and one whose coefficients overflow the IDCT come
from format_kinds; the GIF, Sun raster, PFM and Radiance HDR files
(tests/gif_writer.py and tests/sunras_writer.py write the ones cv2 and
PIL do not) from decoder_kinds; the JPEG 2000 files (PIL's writer;
tests/j2k_writer.py's rewrites of it for POC, EPH, PPM / PPT,
tile-parts, RGN, palettes, channel definitions and colour spaces; its
encoder for the code-block styles, SOP and a real ROI, which PIL 12's
writer does not set) from jp2_kinds, with JP2_FRAME (cv2.imwrite's default, 9/7) and
JP2_LOSSLESS_FRAME (5/3), the 480x640 frames of phase 14 (c); the AVIF
files (cv2's and PIL's writers at their defaults: odd sizes, both
transform modes, past 64 a side, PIL's palettes, intra block copy, two
tile columns and 128x128 superblocks) from avif_kinds, with AVIF_FRAME, the 480x640 frame
of phase 14 (c). Files named *_refused_* are ones cv2 gives no image
for (null hashes). --kinds writes only the named steps' files and
replaces only their entries in hashes.json.
"""

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests import j2k_writer as j2w  # noqa: E402
from tests import jpeg_writer as jw  # noqa: E402
from tests.bmp_writer import rle_encode, write_bmp  # noqa: E402
from tests.gif_writer import write_gif  # noqa: E402
from tests.png_writer import write_png  # noqa: E402
from tests.sunras_writer import RT_OLD, write_sunras  # noqa: E402

SEED = 7
PROGRESSIVE_FRAME = "prog_420_q85_480x640.jpg"
# the 480x640 frames of the other formats' decode rates (phase 14 (c))
TIFF_FRAME = "frame_lzw_pred_480x640.tif"
WEBP_FRAME = "frame_webp_q80_480x640.webp"
WEBP_LOSSLESS_FRAME = "frame_webp_lossless_480x640.webp"
# the 480x640 GIF and HDR frames whose decode rates phase 14 (c) reads
GIF_FRAME = "frame_gif_480x640.gif"
HDR_FRAME = "frame_hdr_480x640.hdr"
# the 480x640 JPEG 2000 frames whose decode rates phase 14 (c) reads
JP2_FRAME = "frame_jp2_97_480x640.jp2"
JP2_LOSSLESS_FRAME = "frame_jp2_53_480x640.jp2"
# the 480x640 AVIF frame whose decode rates phase 14 (c) reads
AVIF_FRAME = "frame_avif_480x640.avif"


def picture(rng, h, w):
    """Ramps, a few filled shapes and mild noise: an image with edges
    and smooth regions, so that every coefficient range is used."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx + yy) * 127 // max(w + h - 2, 1)], -1).astype(np.int64)
    for _ in range(4):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + max(h // 3, 1), x0:x0 + max(w // 3, 1)] = rng.integers(
            0, 256, 3)
    img += rng.integers(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_jpeg(img, quality, sampling=None, restart=0, optimize=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, {
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sampling]]
    src = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg", src, params)
    assert ok
    return buf.tobytes()


def cv2_progressive(img, quality, sampling, restart=0):
    flag = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}[sampling]
    ok, buf = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def writer_kinds(rng):
    """The files neither cv2 nor PIL writes, from coefficient blocks."""
    f422 = jw.Frame(43, 29, [(2, 1), (1, 1), (1, 1)])
    scans = jw.sequential_script(f422, [[2], [0], [1]])
    scans[1].restart = 2
    f420 = jw.Frame(45, 37, [(2, 2), (1, 1), (1, 1)])
    smoothed = [jw.Scan([0, 1, 2], 0, 0, 0, 0)] + [
        jw.Scan([i], 1, 5, 0, 1) for i in range(3)]
    ycck = jw.Frame(41, 23, [(2, 2), (1, 1), (1, 1), (2, 2)])
    arith = jw.Frame(53, 31, [(2, 2), (1, 1), (1, 1)])
    f444 = jw.Frame(37, 29, [(1, 1)] * 3)
    return {
        "multiscan_422_29x43.jpg": jw.write_jpeg(
            f422, jw.random_coefficients(rng, f422), scans, late_dqt=True),
        "prog_smoothed_420_37x45.jpg": jw.write_jpeg(
            f420, jw.random_coefficients(rng, f420, ac_scale=0.6), smoothed,
            progressive=True),
        "ycck_adobe2_2211_23x41.jpg": jw.write_jpeg(
            ycck, jw.random_coefficients(rng, ycck, dc_range=120),
            jfif=False, adobe=2),
        "arith_420_rst2_31x53.jpg": jw.write_jpeg(
            arith, jw.random_coefficients(rng, arith),
            jw.sequential_script(arith, restart=2), arithmetic=True),
        "arith_prog_444_29x37.jpg": jw.write_jpeg(
            f444, jw.random_coefficients(rng, f444),
            jw.progressive_script(f444, restart=3, al=2),
            progressive=True, arithmetic=True),
    }


def pil_jpeg(img, quality, subsampling, orientation=None):
    b = io.BytesIO()
    kw = {}
    if orientation is not None:
        exif = Image.Exif()
        exif[0x0112] = orientation
        kw["exif"] = exif.tobytes()
    Image.fromarray(img).save(b, "JPEG", quality=quality,
                              subsampling=subsampling, **kw)
    return b.getvalue()


def fixtures():
    rng = np.random.default_rng(SEED)
    noise = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    return {
        "444_q75_333x517.jpg": cv2_jpeg(picture(rng, 333, 517), 75, "444"),
        "422_q90_7x13.jpg": cv2_jpeg(picture(rng, 7, 13), 90, "422"),
        "420_q95_333x517.jpg": cv2_jpeg(picture(rng, 333, 517), 95, "420"),
        "440_q85_17x33.jpg": cv2_jpeg(picture(rng, 17, 33), 85, "440"),
        "411_q80_61x97.jpg": cv2_jpeg(picture(rng, 61, 97), 80, "411"),
        "420_q90_1x1.jpg": cv2_jpeg(picture(rng, 1, 1), 90, "420"),
        "gray_q90_121x160.jpg": cv2_jpeg(picture(rng, 121, 160)[..., 0], 90),
        "420_q70_rst3_optimize_121x160.jpg": cv2_jpeg(
            picture(rng, 121, 160), 70, "420", restart=3, optimize=1),
        "444_q100_noise_64x64.jpg": cv2_jpeg(noise, 100, "444"),
        "420_q100_noise_64x64.jpg": cv2_jpeg(noise, 100, "420"),
        "pil_420_q90_exif6_40x64.jpg": pil_jpeg(picture(rng, 40, 64), 90, 2,
                                                orientation=6),
        "pil_444_q60_exif5_33x21.jpg": pil_jpeg(picture(rng, 33, 21), 60, 0,
                                                orientation=5),
    }


def new_kinds():
    """The kinds the decoder reads since the buffered path: progressive
    (cv2's script, with restarts, and a 480x640 frame), CMYK (PIL),
    the writers' files, an interlaced PNG and a gamma PNG."""
    rng = np.random.default_rng(SEED + 1)
    b = io.BytesIO()
    Image.fromarray(picture(rng, 24, 40)).convert("CMYK").save(
        b, "JPEG", quality=90)
    out = {
        "prog_420_q85_61x97.jpg": cv2_progressive(picture(rng, 61, 97), 85,
                                                  "420"),
        "prog_444_q80_rst2_40x64.jpg": cv2_progressive(
            picture(rng, 40, 64), 80, "444", restart=2),
        PROGRESSIVE_FRAME: cv2_progressive(picture(rng, 480, 640), 85,
                                           "420"),
        "cmyk_pil_q90_24x40.jpg": b.getvalue(),
        **writer_kinds(rng),
    }
    pix = picture(rng, 33, 47).astype(np.int64)
    out["adam7_rgb_33x47.png"] = write_png(pix, 8, 2, (0, 1, 2, 3, 4),
                                           interlace=True)
    out["srgb_rgb16_33x47.png"] = write_png(
        pix * 257 + rng.integers(0, 257, pix.shape), 16, 2, (4,),
        chunks=[(b"sRGB", b"\0"), (b"gAMA", struct.pack(">I", 45455))])
    return out


def smooth_frame(rng, h, w, noisy_rows):
    """Ramps and filled shapes, noise of +-2 in the first noisy_rows
    rows only: a 480x640 LZW TIFF of the noisy picture() would weigh
    800 KB, this one 200."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                    (xx + yy) * 127 // (w + h - 2)], -1).astype(np.int64)
    for _ in range(12):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + h // 5, x0:x0 + w // 5] = rng.integers(0, 256, 3)
    img[:noisy_rows] += rng.integers(-2, 3, img[:noisy_rows].shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def damaged_jpegs(rng):
    """Files libjpeg decodes with a warning, and the IDCT's overflow."""
    base = cv2_jpeg(picture(rng, 48, 64), 90, "420", restart=1)
    cut = cv2_jpeg(picture(rng, 48, 64), 90, "420")
    sos = cut.index(b"\xff\xda") + 12
    f = jw.Frame(32, 32)
    coefs = [np.clip(c * 40, -1023, 1023)
             for c in jw.random_coefficients(np.random.default_rng(3), f)]
    return {
        "damaged_missing_rst_48x64.jpg": base.replace(b"\xff\xd2",
                                                      b"\xff\xd4", 1),
        "damaged_cut_by_marker_48x64.jpg": cut[:sos + (len(cut) - sos) // 2]
        + b"\xff\xd9",
        "overflow_gray_32x32.jpg": jw.write_jpeg(f, coefs),
    }


def format_kinds():
    """BMP, PNM, TIFF and WebP files (and the damaged and overflowing
    JPEGs) that the port's other decoders read, and the 480x640 TIFF and
    WebP frames of phase 14 (c)."""
    rng = np.random.default_rng(SEED + 2)
    runs = np.repeat(rng.integers(0, 256, (29, 15)), 3, 1)[:, :43]
    pal = rng.integers(0, 256, (256, 3))
    out = {
        "bmp_rle8_escapes_29x43.bmp": write_bmp(
            runs, 8, palette=pal, rle=rle_encode(runs, 8, rng)),
        "bmp_565_bitfields_21x37.bmp": write_bmp(
            rng.integers(0, 65536, (21, 37)), 16,
            masks=(0xF800, 0x7E0, 0x1F)),
        "pgm_maxval100_17x23.pgm": b"P5\n# maxval 100, kept raw\n23 17\n100\n"
        + rng.integers(0, 101, (17, 23)).astype(np.uint8).tobytes(),
        "ppm_16bit_19x27.ppm": b"P6 27 19 65535\n" + rng.integers(
            0, 65536, (19, 27, 3)).astype(">u2").tobytes(),
    }
    b = io.BytesIO()
    Image.fromarray(picture(rng, 31, 45)).save(
        b, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    out["tiff_lzw_pred_31x45.tif"] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(picture(rng, 40, 56)).save(b, "TIFF", compression="jpeg",
                                               quality=85)
    out["tiff_jpeg_ycbcr_40x56.tif"] = b.getvalue()
    rgba = np.concatenate([picture(rng, 30, 41),
                           rng.integers(0, 256, (30, 41, 1), np.uint8)], 2)
    b = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(b, "WEBP", quality=80)
    out["webp_lossy_alpha_30x41.webp"] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(picture(rng, 37, 53)).save(b, "WEBP", lossless=True)
    out["webp_lossless_37x53.webp"] = b.getvalue()
    exif = Image.Exif()
    exif[0x0112] = 6
    b = io.BytesIO()
    Image.fromarray(picture(rng, 24, 40)).save(b, "WEBP", quality=90,
                                               exif=exif.tobytes())
    out["webp_exif6_24x40.webp"] = b.getvalue()
    out.update(damaged_jpegs(rng))
    b = io.BytesIO()
    Image.fromarray(smooth_frame(rng, 480, 640, 160)).save(
        b, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    out[TIFF_FRAME] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(picture(rng, 480, 640)).save(b, "WEBP", quality=80)
    out[WEBP_FRAME] = b.getvalue()
    b = io.BytesIO()
    Image.fromarray(smooth_frame(rng, 480, 640, 80)).save(b, "WEBP",
                                                          lossless=True)
    out[WEBP_LOSSLESS_FRAME] = b.getvalue()
    return out


def pil_gif(frames, **kw) -> bytes:
    """A PIL GIF of palette frames ((idx, (n, 3) palette) pairs)."""
    ims = []
    for idx, pal in frames:
        im = Image.fromarray(idx.astype(np.uint8), "P")
        im.putpalette(np.asarray(pal, np.uint8).ravel().tolist())
        ims.append(im)
    b = io.BytesIO()
    ims[0].save(b, "GIF", save_all=len(ims) > 1, append_images=ims[1:], **kw)
    return b.getvalue()


def pfm(values: np.ndarray, scale: float) -> bytes:
    """A PFM of float values ((h, w, 3) RGB or (h, w) gray), rows
    bottom-up, little-endian for a negative scale."""
    tag = b"PF" if values.ndim == 3 else b"Pf"
    h, w = values.shape[:2]
    return tag + f"\n{w} {h}\n{scale}\n".encode() + np.ascontiguousarray(
        values[::-1]).astype("<f4" if scale < 0 else ">f4").tobytes()


def rgbe_rows(rgbe: np.ndarray) -> bytes:
    """(h, w, 4) RGBE bytes -> a Radiance header and flat pixels."""
    h, w = rgbe.shape[:2]
    return (f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
            .encode() + rgbe.astype(np.uint8).tobytes())


def decoder_kinds():
    """GIF, Sun raster, PFM and Radiance HDR files (cv2's, PIL's and the
    tests' writers'), and the 480x640 GIF and HDR frames of phase 14
    (c)."""
    rng = np.random.default_rng(SEED + 3)
    pal = rng.integers(0, 256, (16, 3))
    idx = [rng.integers(0, 16, (24, 32)) for _ in range(3)]
    out = {
        "gif_pil_interlaced_23x37.gif": pil_gif(
            [(rng.integers(0, 16, (23, 37)), pal)], interlace=True),
        "gif_pil_transparent_21x30.gif": pil_gif(
            [(rng.integers(0, 16, (21, 30)), pal)], transparency=5),
        "gif_anim3_disposal_24x32.gif": pil_gif(
            [(i, pal) for i in idx], duration=100, disposal=2, loop=0),
        "gif_local_palette_26x34.gif": write_gif(34, 26, [
            {"idx": rng.integers(0, 16, (26, 34)),
             "palette": rng.integers(0, 256, (16, 3))}], palette=pal,
            background=3),
        "gif_small_frame_30x40.gif": write_gif(40, 30, [
            {"idx": rng.integers(0, 16, (12, 17)), "x": 9, "y": 7,
             "transparent": 2, "disposal": 2, "interlace": True},
            {"idx": rng.integers(0, 16, (30, 40))}], palette=pal,
            background=6),
        "sunras_cmap8_19x27.ras": write_sunras(
            rng.integers(0, 256, (19, 27)), 8,
            colormap=rng.integers(0, 256, (200, 3))),
        "sunras_1bit_13x21.ras": write_sunras(
            rng.integers(0, 2, (13, 21)), 1),
        "sunras_1bit_cmap_old_11x17.ras": write_sunras(
            rng.integers(0, 2, (11, 17)), 1, typ=RT_OLD,
            colormap=rng.integers(0, 256, (2, 3))),
        "sunras_32bit_15x22.ras": write_sunras(
            rng.integers(0, 256, (15, 22, 4)), 32),
        "pfm_rgb_le_13x17.pfm": pfm(rng.normal(120, 90, (13, 17, 3)), -1.0),
        "pfm_rgb_be_scale2_11x19.pfm": pfm(
            rng.normal(200, 150, (11, 19, 3)), 2.0),
        "pfm_gray_15x21.pfm": pfm(rng.normal(100, 80, (15, 21)), -1.0),
        "hdr_flat_7x9.hdr": rgbe_rows(np.concatenate(
            [rng.integers(0, 256, (7, 9, 3)),
             rng.integers(120, 136, (7, 9, 1))], 2)),
        "hdr_old_rle_12x16.hdr": rgbe_rows(np.where(
            rng.random((12, 16, 1)) < 0.2, [1, 1, 1, 3], np.concatenate(
                [rng.integers(0, 256, (12, 16, 3)),
                 rng.integers(125, 131, (12, 16, 1))], 2))),
    }
    img = picture(rng, 20, 28)
    for name, ext in (("gif_cv2_20x28.gif", ".gif"),
                      ("sunras_cv2_20x28.ras", ".ras"),
                      ("hdr_cv2_rle_20x28.hdr", ".hdr")):
        ok, buf = cv2.imencode(ext, img[..., ::-1])
        assert ok
        out[name] = buf.tobytes()
    frame = Image.fromarray(smooth_frame(rng, 480, 640, 40)).quantize(256)
    b = io.BytesIO()
    frame.save(b, "GIF")
    out[GIF_FRAME] = b.getvalue()
    ok, buf = cv2.imencode(".hdr", smooth_frame(rng, 480, 640, 0)[..., ::-1])
    assert ok
    out[HDR_FRAME] = buf.tobytes()
    return out


def pil_j2k(img, mode=None, **kw) -> bytes:
    """PIL's JPEG 2000 writer (OpenJPEG): a JP2 file, or a raw codestream
    with no_jp2=True; mode I;16 takes a uint16 array."""
    if mode == "I;16":
        im = Image.frombytes("I;16", img.shape[::-1],
                             img.astype("<u2").tobytes())
    else:
        im = Image.fromarray(img, mode)
    b = io.BytesIO()
    im.save(b, "JPEG2000", **kw)
    return b.getvalue()


def jp2_kinds():
    """JPEG 2000 files: PIL's options (progression orders, 5/3 and 9/7
    with and without MCT, odd tiles, PLT, one resolution, precincts and
    layers, a raw codestream, the L, LA, RGBA and I;16 modes),
    tests/j2k_writer.py's rewrites and its encoder (each code-block
    style, SOP with EPH, an ROI), the two kinds cv2 refuses (an image
    origin, signed samples), a damaged codestream, and the 480x640
    frames of phase 14 (c)."""
    rng = np.random.default_rng(SEED + 4)
    img = picture(rng, 40, 56)
    odd = picture(rng, 45, 67)
    rgba = np.concatenate([img, rng.integers(0, 256, (40, 56, 1), np.uint8)],
                          2)
    layers = dict(quality_layers=[30, 10], quality_mode="rates")
    out = {}
    for prg in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"jp2_prog_{prg.lower()}_40x56.jp2"] = pil_j2k(
            img, progression=prg, precinct_size=(32, 32), num_resolutions=4,
            **layers)
    for style, bit in (("bypass", j2w.LAZY), ("reset", j2w.RESET),
                       ("termall", j2w.TERMALL), ("vertical", j2w.VSC),
                       ("predictable", j2w.PTERM), ("segmark", j2w.SEGSYM)):
        out[f"jp2_cblk_{style}_40x56.jp2"] = j2w.jp2(j2w.encode(
            img, levels=3, cblk=(3, 4), style=bit))
    for irr in (False, True):
        for mct in (1, 0):
            out[f"jp2_{'97' if irr else '53'}_mct{mct}_40x56.jp2"] = pil_j2k(
                img, irreversible=irr, mct=mct)
        out[f"jp2_tiles_odd_{'97' if irr else '53'}_45x67.jp2"] = pil_j2k(
            odd, tile_size=(17, 29), irreversible=irr)
    out["jp2_plt_40x56.jp2"] = pil_j2k(img, plt=True)
    out["j2k_sop_eph_all_styles_40x56.j2k"] = j2w.encode(
        img, cblk=(4, 3), style=0x3F, sop=True, eph=True)
    out["jp2_roi_maxshift_40x56.jp2"] = j2w.jp2(j2w.encode(
        img, roi=(0.25, 0.75, 0.2, 0.6)))
    out["jp2_one_resolution_40x56.jp2"] = pil_j2k(img, num_resolutions=1)
    out["jp2_precincts_layers_45x67.jp2"] = pil_j2k(
        odd, precinct_size=(16, 16), codeblock_size=(8, 8),
        quality_layers=[40, 15, 5], quality_mode="rates")
    out["j2k_raw_codestream_45x67.j2k"] = pil_j2k(odd, no_jp2=True,
                                                  irreversible=True)
    out["jp2_mode_l_40x56.jp2"] = pil_j2k(img[..., 0])
    out["jp2_mode_la_40x56.jp2"] = pil_j2k(rgba[..., :2], "LA")
    out["jp2_mode_rgba_40x56.jp2"] = pil_j2k(rgba, "RGBA", irreversible=True)
    out["jp2_mode_i16_40x56.jp2"] = pil_j2k(
        img[..., 0].astype(np.uint16) * 257 + rng.integers(0, 257, (40, 56)),
        "I;16")
    out["jp2_refused_origin_40x56.jp2"] = pil_j2k(
        img, offset=(3, 5), tile_offset=(0, 0), tile_size=(32, 32))
    out["jp2_refused_signed_40x56.jp2"] = pil_j2k(img, signed=True)
    # the rewrites (tests/j2k_writer.py) of codestreams PIL wrote
    tiled = pil_j2k(odd, no_jp2=True, tile_size=(32, 32), **layers)
    tiled97 = pil_j2k(odd, no_jp2=True, tile_size=(32, 40), irreversible=True)
    gray = pil_j2k(img[..., 0] // 16, no_jp2=True)
    out["jp2_poc_45x67.jp2"] = j2w.jp2(j2w.restate_poc(pil_j2k(
        odd, no_jp2=True, progression="RLCP", **layers)))
    out["jp2_eph_45x67.jp2"] = j2w.jp2(j2w.with_eph(tiled))
    out["jp2_ppm_tileparts_45x67.jp2"] = j2w.jp2(j2w.packed_headers(
        j2w.tile_parts(tiled, 2, False), "ppm"))
    out["jp2_ppt_45x67.jp2"] = j2w.jp2(j2w.packed_headers(tiled97, "ppt"))
    out["j2k_tileparts_interleaved_45x67.j2k"] = j2w.tile_parts(tiled97, 3,
                                                                True)
    out["jp2_markers_rgn_45x67.jp2"] = j2w.jp2(j2w.with_markers(tiled97, 5))
    pal = rng.integers(0, 256, (16, 3))
    out["jp2_palette_40x56.jp2"] = j2w.jp2(
        gray, pclr=(pal.tolist(), [8, 8, 8]),
        cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    out["jp2_cdef_swap_40x56.jp2"] = j2w.jp2(
        pil_j2k(img, no_jp2=True), cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)])
    out["jp2_sycc_40x56.jp2"] = j2w.jp2(pil_j2k(img, no_jp2=True, mct=0), 18)
    out["jp2_prec12_40x56.jp2"] = j2w.jp2(j2w.set_precision(
        pil_j2k(img, no_jp2=True), 12))
    damaged = bytearray(pil_j2k(odd, irreversible=True))
    for pos in (len(damaged) // 2, 2 * len(damaged) // 3):
        damaged[pos] ^= 0x5A
    out["jp2_damaged_45x67.jp2"] = bytes(damaged)
    ok, buf = cv2.imencode(".jp2", picture(rng, 480, 640)[..., ::-1])
    assert ok
    out[JP2_FRAME] = buf.tobytes()
    out[JP2_LOSSLESS_FRAME] = pil_j2k(smooth_frame(rng, 480, 640, 80))
    return out


def screen(rng, h, w, ncol):
    """Screen content: rows of six seeded 8x6 glyphs of ncol colours,
    which PIL's AVIF writer codes with palettes and intra block copy."""
    pal = rng.integers(0, 256, (ncol, 3))
    glyphs = [rng.integers(0, ncol, (8, 6)) for _ in range(6)]
    idx = np.zeros((h, w), np.int64)
    for y in range(0, h, 10):
        for x in range(0, w, 7):
            g = glyphs[int(rng.integers(0, len(glyphs)))]
            idx[y:y + 8, x:x + 6] = g[:min(8, h - y), :min(6, w - x)]
    return pal[idx].astype(np.uint8)


def pil_avif(img) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "AVIF")
    return b.getvalue()


def avif_kinds():
    """AVIF files as cv2.imwrite and PIL write them at their defaults
    (cv2: quantizer matrices, delta q, CDEF, one transform size a block
    at some sizes and selected ones at others; PIL: no CDEF, palettes on
    few-colour frames, intra block copy on screen content, two tile
    columns from about 512x512 samples, 128x128 superblocks above 480 a
    side), and AVIF_FRAME, the 480x640 frame of phase 14 (c)."""
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for h, w in ((37, 53), (65, 130), (70, 140)):
        ok, buf = cv2.imencode(".avif", picture(rng, h, w)[..., ::-1])
        assert ok
        out[f"avif_cv2_{h}x{w}.avif"] = buf.tobytes()
    out["avif_pil_45x67.avif"] = pil_avif(picture(rng, 45, 67))
    dots = ((rng.random((48, 72, 3)) < 0.05) * 255).astype(np.uint8)
    out["avif_pil_palette_48x72.avif"] = pil_avif(dots)
    # its own generator, so that the later fixtures do not move with it
    out["avif_pil_intrabc_150x120.avif"] = pil_avif(
        screen(np.random.default_rng(SEED + 6), 150, 120, 3))
    out["avif_pil_tiles_300x900.avif"] = pil_avif(
        smooth_frame(rng, 300, 900, 20))
    out["avif_pil_sb128_520x520.avif"] = pil_avif(
        smooth_frame(rng, 520, 520, 20))
    ok, buf = cv2.imencode(".avif", picture(rng, 480, 640)[..., ::-1])
    assert ok
    out[AVIF_FRAME] = buf.tobytes()
    return out


KINDS = {"fixtures": fixtures, "new": new_kinds, "format": format_kinds,
         "decoder": decoder_kinds, "jp2": jp2_kinds, "avif": avif_kinds}


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest(), "shape": list(img.shape)}


def cv2_digest(path: str, flag: int):
    """The digest of cv2.imread(path, flag) (RGB at IMREAD_COLOR), or None
    where cv2 gives no image of that flag's channels (a PFM's other
    channel count): the port raises there."""
    img = cv2.imread(path, flag)
    channels = 3 if flag == cv2.IMREAD_COLOR else 1
    if img is None or (img.ndim == 3) != (channels == 3):
        return None
    if channels == 3:
        return digest(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return digest(img[..., None])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "torch_jpeg"))
    ap.add_argument("--kinds", nargs="+", choices=sorted(KINDS),
                    default=sorted(KINDS))
    args = ap.parse_args()
    out = args.out
    os.makedirs(out, exist_ok=True)
    hashes = {}
    if set(args.kinds) != set(KINDS):
        with open(os.path.join(out, "hashes.json")) as f:
            hashes = json.load(f)["files"]
    files = {}
    for kind in args.kinds:
        files.update(KINDS[kind]())
    for name, data in files.items():
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        hashes[name] = {"rgb": cv2_digest(path, cv2.IMREAD_COLOR),
                        "gray": cv2_digest(path, cv2.IMREAD_GRAYSCALE)}
        assert (hashes[name]["rgb"] or hashes[name]["gray"]) != \
            ("_refused_" in name), name
    with open(os.path.join(out, "hashes.json"), "w") as f:
        json.dump({"decoder": f"OpenCV {cv2.__version__}",
                   "files": hashes}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
