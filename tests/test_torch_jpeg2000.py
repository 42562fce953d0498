"""JPEG 2000 in the port's decoder (data/jp2.py, native/j2k*.c), byte for
byte as cv2 (OpenJPEG 2.5) gives it, at 3 channels (after
COLOR_BGR2RGB) and 1 (IMREAD_GRAYSCALE), through bytes (cv2.imdecode)
and a file (cv2.imread, and the JAX package's load_image under its cv2
decoder):

  * every JP2 / J2K fixture of tests/data/torch_jpeg (tools/
    jpeg_fixtures.py's jp2_kinds: the five progression orders, every
    code-block style, 5/3 and 9/7 with and without MCT, odd tiles, SOP,
    PLT, one resolution, precincts and layers, the PIL modes, the 480x640
    frames) against cv2 and its recorded hash;
  * PIL's options on seeded images of odd sizes, tests/j2k_writer.py's
    rewrites (POC, EPH, PPM / PPT, tile-parts in and out of order, TNsot
    0, a missing tile, RGN, restated COC / QCC / COD, TLM, CRG) and its
    encoder (the code-block styles, SOP, a real ROI), and JP2 boxes (colour spaces,
    ICC, palettes, channel definitions, precisions);
  * what cv2 gives no image for (an image origin, signed samples,
    precisions below 8, CMYK, a codestream cut short anywhere, a PPM /
    PPT or QCD segment too short for its parameters) raises
    ValueError naming the file; a damaged codestream that OpenJPEG
    decodes gives its bytes; what is not ported (Part 2 and Part 15
    extensions) raises naming the marker.

At the slice's level a seeded scene saved as 9/7 and 5/3 JP2 gives the
port's detect_raw the boxes of the JAX detector on cv2's decode.
"""

import hashlib
import json
import os
import struct
import threading

import cv2
import numpy as np
import pytest
import torch

from tests import j2k_writer as j2w
from tools.jpeg_fixtures import pil_j2k
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu_torch.native.preproc import decode_image, decode_image_bytes

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_jpeg")
with open(os.path.join(FIXTURES, "hashes.json")) as _f:
    HASHES = json.load(_f)["files"]
JP2_FIXTURES = sorted(n for n in HASHES if n.endswith((".jp2", ".j2k")))


def _cv2(data, channels):
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR if channels == 3
                       else cv2.IMREAD_GRAYSCALE)
    if img is None:
        return None
    return img[..., ::-1] if channels == 3 else img[..., None]


@pytest.fixture
def jax_cv2_decoder():
    """The JAX package's load_image under its default decoder, cv2."""
    old = jpipe.get_decoder()
    jpipe.set_decoder("cv2")
    yield jpipe.load_image
    jpipe.set_decoder(old)


def same_as_cv2(data, path=None, load=None):
    """The port's bytes equal cv2.imdecode's at 3 and 1 channels, or it
    raises where cv2 gives no image; with a path, the file's too (and the
    JAX package's load_image). -> the channels cv2 gave an image at."""
    gave = []
    for c in (3, 1):
        want = _cv2(data, c)
        if want is None:
            with pytest.raises(ValueError, match="cv2 gives no image"):
                decode_image_bytes(data, c)
            if path is not None:
                with pytest.raises(ValueError) as err:
                    decode_image(path, c)
                assert path in str(err.value)
            continue
        got = decode_image_bytes(data, c)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if path is not None:
            np.testing.assert_array_equal(decode_image(path, c), got)
            np.testing.assert_array_equal(
                load(path, c).reshape(got.shape), got)
        gave.append(c)
    return gave


def _picture(rng, h, w):
    """Ramps, a few flat rectangles and mild noise, RGB uint8."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                    (xx + yy) * 127 // (w + h - 2)], -1).astype(np.int64)
    for _ in range(3):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 256, 3)
    img += rng.integers(-10, 11, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# --- the fixtures ----------------------------------------------------------------

@pytest.mark.parametrize("name", JP2_FIXTURES)
def test_fixture_matches_cv2_and_its_hash(name, jax_cv2_decoder):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    gave = same_as_cv2(data, path, jax_cv2_decoder)
    want = HASHES[name]
    assert (want["rgb"] is not None, want["gray"] is not None) == \
        (3 in gave, 1 in gave)
    for key, c in (("rgb", 3), ("gray", 1)):
        if want[key] is not None:
            img = decode_image(path, c)
            assert list(img.shape) == want[key]["shape"]
            assert hashlib.sha256(img.tobytes()).hexdigest() == \
                want[key]["sha256"]


def test_fixtures_cover_the_kinds():
    names = " ".join(JP2_FIXTURES)
    for kind in ("lrcp", "rlcp", "rpcl", "pcrl", "cprl", "bypass", "reset",
                 "termall", "vertical", "predictable", "segmark", "97_mct0",
                 "53_mct1", "tiles_odd", "sop", "plt", "roi",
                 "one_resolution", "poc",
                 "eph", "ppm", "ppt", "tileparts", "rgn", "palette", "cdef",
                 "sycc", "prec12", "mode_la", "mode_rgba", "mode_i16",
                 ".j2k", "refused_origin", "refused_signed", "damaged"):
        assert kind in names, kind


# --- PIL's options and the writer's rewrites, in memory ------------------------

PIL_OPTIONS = {
    "53": dict(irreversible=False),
    "97": dict(irreversible=True),
    "97 no mct": dict(irreversible=True, mct=0),
    "tiles 17x29 97": dict(tile_size=(17, 29), irreversible=True),
    "tiles 33x45 53": dict(tile_size=(33, 45)),
    "cblk 16x64 97": dict(codeblock_size=(16, 64), irreversible=True),
    "precincts 16 rpcl": dict(precinct_size=(16, 16), progression="RPCL",
                              codeblock_size=(8, 8), quality_layers=[20, 6],
                              quality_mode="rates"),
    "layers db pcrl": dict(quality_layers=[28, 36], quality_mode="dB",
                           progression="PCRL"),
    "cprl tiles plt": dict(progression="CPRL", tile_size=(32, 32), plt=True),
    "resolutions 2": dict(num_resolutions=2, irreversible=True),
}


@pytest.mark.parametrize("kind", sorted(PIL_OPTIONS))
def test_pil_options_match_cv2(kind):
    # 45x67: no edge tile of a 9/7 grid is one sample wide, which
    # OpenJPEG's encoder cannot write
    rng = np.random.default_rng(len(kind))
    for nj in (False, True):
        same_as_cv2(pil_j2k(_picture(rng, 45, 67), no_jp2=nj,
                            **PIL_OPTIONS[kind]))


def _parts(cs, fn):
    """cs with its tile-parts passed through fn (TNsot recounted where a
    part's is None)."""
    s = j2w.parse(cs)
    return j2w.build(s["main"], fn([(i, t, None, h, d)
                                    for i, t, _, h, d in s["parts"]]))


def _rewrites():
    rng = np.random.default_rng(21)
    img = _picture(rng, 45, 67)
    layers = dict(quality_layers=[25, 8], quality_mode="rates")
    tiled = pil_j2k(img, no_jp2=True, tile_size=(32, 32), **layers)
    tiled97 = pil_j2k(img, no_jp2=True, tile_size=(24, 40), irreversible=True)
    return {
        "poc": lambda: j2w.restate_poc(pil_j2k(
            img, no_jp2=True, progression="RLCP", **layers)),
        "eph": lambda: j2w.with_eph(tiled97),
        "ppm": lambda: j2w.packed_headers(tiled, "ppm"),
        "ppt": lambda: j2w.packed_headers(tiled, "ppt"),
        "ppm over tile-parts": lambda: j2w.packed_headers(
            j2w.tile_parts(tiled97, 2, False), "ppm"),
        "tile-parts": lambda: j2w.tile_parts(tiled, 3, False),
        "tile-parts interleaved": lambda: j2w.tile_parts(tiled, 2, True),
        "markers": lambda: j2w.with_markers(tiled),
        "rgn 97": lambda: j2w.with_markers(tiled97, 4),
        "rgn bypass": lambda: j2w.with_markers(j2w.encode(
            img, style=j2w.LAZY), 2),
        "TNsot 0": lambda: _parts(tiled, lambda ps: [
            (i, t, 0, h, d) for i, t, _, h, d in ps]),
        "tiles in reverse order": lambda: _parts(tiled, lambda ps: ps[::-1]),
        "a tile missing (zeros)": lambda: _parts(tiled, lambda ps: ps[1:]),
        "encoder, bypass + vsc": lambda: j2w.encode(
            img, cblk=(2, 3), style=j2w.LAZY | j2w.VSC),
        "encoder, reset + termall + segsym, sop": lambda: j2w.encode(
            img, levels=3, style=j2w.RESET | j2w.TERMALL | j2w.SEGSYM,
            sop=True),
        "encoder, roi on bypass": lambda: j2w.encode(
            img, cblk=(3, 3), style=j2w.LAZY, roi=(0.1, 0.5, 0.3, 0.9)),
        "precision 10": lambda: j2w.set_precision(pil_j2k(
            img, no_jp2=True), 10),
        "precision 16 gray": lambda: j2w.jp2(j2w.set_precision(pil_j2k(
            img[..., 1], no_jp2=True), 16), 17),
    }


REWRITES = _rewrites()


@pytest.mark.parametrize("kind", sorted(REWRITES))
def test_writer_rewrites_match_cv2(kind):
    data = REWRITES[kind]()
    assert same_as_cv2(data) == [3, 1]
    assert same_as_cv2(j2w.jp2(data) if data[:2] == b"\xff\x4f" else data)


def _boxes():
    rng = np.random.default_rng(22)
    img = _picture(rng, 40, 56)
    rgba = np.concatenate([img, rng.integers(0, 256, (40, 56, 1),
                                             np.uint8)], 2)
    cs = pil_j2k(img, no_jp2=True)
    cs4 = pil_j2k(rgba, "RGBA", no_jp2=True)
    idx = pil_j2k(img[..., 0] // 16, no_jp2=True)
    pal = rng.integers(0, 256, (16, 3))
    rgb_map = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
    return {
        "srgb": j2w.jp2(cs, 16), "gray of rgb": j2w.jp2(cs, 17),
        "sycc": j2w.jp2(pil_j2k(img, no_jp2=True, mct=0), 18),
        "sycc rgba 97": j2w.jp2(pil_j2k(rgba, "RGBA", no_jp2=True,
                                        irreversible=True), 18),
        "cielab as srgb": j2w.jp2(cs, 14), "unknown enumcs": j2w.jp2(cs, 99),
        "icc": j2w.jp2(cs, icc=bytes(128)),
        "first colr counts": j2w.jp2(cs, 17, extra_colr=16),
        "palette": j2w.jp2(idx, pclr=(pal.tolist(), [8, 8, 8]),
                           cmap=rgb_map),
        "palette 16-bit": j2w.jp2(idx, pclr=((pal * 257).tolist(),
                                             [16, 16, 16]), cmap=rgb_map),
        "palette short, indices clamped": j2w.jp2(
            idx, pclr=(pal[:9].tolist(), [8, 8, 8]), cmap=rgb_map),
        "palette without cmap": j2w.jp2(idx, 17, pclr=(pal.tolist(),
                                                       [8, 8, 8])),
        "cdef swap": j2w.jp2(cs, cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)]),
        "cdef alpha first": j2w.jp2(cs4, cdef=[(0, 1, 0), (1, 0, 1),
                                               (2, 0, 2), (3, 0, 3)]),
        "la as gray": j2w.jp2(pil_j2k(rgba[..., :2], "LA", no_jp2=True), 17),
    }


BOXES = _boxes()


@pytest.mark.parametrize("kind", sorted(BOXES))
def test_jp2_boxes_match_cv2(kind):
    assert same_as_cv2(BOXES[kind]) == [3, 1]


# --- what cv2 gives no image for -------------------------------------------------

def _siz_size(cs, w, h):
    """cs with SIZ's image and tile sizes set to w x h."""
    s = j2w.parse(cs)
    main = [(m, b[:2] + struct.pack(">IIIIII", w, h, 0, 0, w, h) + b[26:])
            if m == j2w.SIZ else (m, b) for m, b in s["main"]]
    return j2w.build(main, [(i, t, None, hh, d)
                            for i, t, _, hh, d in s["parts"]])


def _packed_marker(cs, where, body):
    """cs's packet headers in PPM / PPT markers, and one more of them
    (in the main header / the first tile-part's) with the given body."""
    s = j2w.parse(j2w.packed_headers(cs, where))
    main, parts = list(s["main"]), [(i, t, None, h, d)
                                     for i, t, _, h, d in s["parts"]]
    if where == "ppm":
        main.append((0xFF60, body))
    else:
        parts[0] = parts[0][:3] + (parts[0][3] + [(0xFF61, body)],
                                   parts[0][4])
    return j2w.build(main, parts)


def _refusals():
    rng = np.random.default_rng(23)
    img = _picture(rng, 40, 56)
    cs = pil_j2k(img, no_jp2=True)
    tiled = pil_j2k(img, no_jp2=True, tile_size=(32, 32))
    short_qcd = [(m, b"\x21" if m == j2w.QCD else b)
                 for m, b in j2w.parse(cs)["main"]]
    la = pil_j2k(np.ascontiguousarray(img[..., :2]), "LA", no_jp2=True)
    return {
        "image origin": (pil_j2k(img, offset=(1, 2), tile_offset=(0, 0),
                                 tile_size=(64, 64)), "image origin"),
        "signed": (pil_j2k(img, signed=True), "signed"),
        "precision 7": (j2w.set_precision(cs, 7), "precision of 7"),
        "cmyk": (j2w.jp2(cs, 12), "colour space 12"),
        "e-sycc": (j2w.jp2(cs, 24), "colour space 24"),
        "incomplete cdef": (j2w.jp2(cs, cdef=[(0, 0, 1), (1, 0, 2)]),
                            "incomplete channel"),
        "cmap past the components": (j2w.jp2(cs, pclr=([[1, 2]], [8, 8]),
                                             cmap=[(5, 1, 0), (0, 1, 1)]),
                                     "cmap names component 5"),
        "ftyp not second": (cs[:0] + j2w.jp2(cs)[:12] + j2w.jp2(cs)[32:],
                            "ftyp"),
        "wider than 2^20": (_siz_size(cs, (1 << 20) + 1, 16), "2^20"),
        "more than 2^30 pixels": (_siz_size(cs, 40000, 30000), "2^30"),
        # a PPM / PPT needs its Z byte and one byte of headers: a length
        # of 2 or 3 must not be read as a segment that ends before it
        # starts
        "ppm of length 2": (_packed_marker(tiled, "ppm", b""),
                            "a PPM of length 2"),
        "ppm of length 3": (_packed_marker(tiled, "ppm", b"\x02"),
                            "a PPM of length 3"),
        "ppt of length 2": (_packed_marker(tiled, "ppt", b""),
                            "a PPT of length 2"),
        "ppt of length 3": (_packed_marker(tiled, "ppt", b"\x02"),
                            "a PPT of length 3"),
        "qcd shorter than its step": (
            j2w.build(short_qcd, [(i, t, None, h, d) for i, t, _, h, d
                                  in j2w.parse(cs)["parts"]]),
            "marker 0xff5c is shorter than its parameters"),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cv2_refusals_raise_naming_the_file(tmp_path, case):
    data, reason = REFUSALS[case]
    for c in (3, 1):
        try:
            assert _cv2(data, c) is None
        except cv2.error:         # imdecode raises past its size limits
            pass
    path = str(tmp_path / "bad.jp2")
    with open(path, "wb") as f:
        f.write(data)
    for c in (3, 1):
        with pytest.raises(ValueError) as err:
            decode_image(path, c)
        assert path in str(err.value) and reason in str(err.value)
        assert "cv2 gives no image either" in str(err.value)


@pytest.mark.parametrize("where", ["no EOC", "in the last packet",
                                   "mid-stream", "in a tile-part header",
                                   "in the main header", "in the jp2c box"])
def test_truncated_codestreams_raise_as_cv2_refuses(tmp_path, where):
    """OpenJPEG (strict, as OpenCV runs it) refuses a codestream cut
    anywhere, and so does the port, naming the file."""
    rng = np.random.default_rng(24)
    data = pil_j2k(_picture(rng, 40, 56), tile_size=(32, 32),
                   irreversible=True, no_jp2=where != "in the jp2c box")
    n = len(data)
    cut = {"no EOC": n - 2, "in the last packet": n - 9, "mid-stream": n // 2,
           "in a tile-part header": data.index(b"\xff\x90") + 6,
           "in the main header": 60, "in the jp2c box": n - 100}[where]
    path = str(tmp_path / "cut.jp2")
    with open(path, "wb") as f:
        f.write(data[:cut])
    for c in (3, 1):
        assert _cv2(data[:cut], c) is None
        with pytest.raises(ValueError, match="cv2 gives no image") as err:
            decode_image(path, c)
        assert path in str(err.value)


@pytest.mark.parametrize("seed", range(5))
def test_damaged_codestreams_decode_as_cv2_decodes(seed):
    """Bytes flipped in the tile data: OpenJPEG decodes what the MQ
    decoder (and, in BYPASS's raw passes, the raw reader) reads from
    them, and the port gives the same bytes. 9/7 and 5/3 in the default
    style from PIL, and 5/3 in the BYPASS, TERMALL and VSC styles from
    j2k_writer's encoder (PIL's writer ignores its cblk_style)."""
    rng = np.random.default_rng(30 + seed)
    img = _picture(rng, 40, 56)
    style = [None, j2w.LAZY, j2w.TERMALL, j2w.VSC, None][seed]
    data = bytearray(pil_j2k(img, no_jp2=True, irreversible=seed == 0)
                     if style is None else j2w.encode(img, style=style))
    sod = data.index(b"\xff\x93") + 2
    for pos in rng.integers(sod + 20, len(data) - 2, 3):
        data[pos] ^= int(rng.integers(1, 256))
    assert same_as_cv2(bytes(data)) == [3, 1]


# --- what is not ported ----------------------------------------------------------

def _insert_main(cs, marker, body):
    sot = cs.index(b"\xff\x90")
    return cs[:sot] + struct.pack(">HH", marker, len(body) + 2) + body + \
        cs[sot:]


def _not_ported():
    cs = pil_j2k(_picture(np.random.default_rng(25), 24, 32), no_jp2=True)
    cod = cs.index(b"\xff\x52") + 4
    spcod = cod + 5
    return {
        "CAP": (_insert_main(cs, 0xFF50, bytes(6)), "CAP"),
        "CBD": (_insert_main(cs, 0xFF78, b"\x00\x03\x07\x07\x07"), "CBD"),
        "MCT marker": (_insert_main(cs, 0xFF74, bytes(4)), "MCT"),
        "MCC": (_insert_main(cs, 0xFF75, bytes(4)), "MCC"),
        "array transform (COD mct 2)": (
            cs[:cod + 4] + b"\x02" + cs[cod + 5:], "component transform 2"),
        "high-throughput blocks": (
            cs[:spcod + 3] + bytes([cs[spcod + 3] | 0x40]) + cs[spcod + 4:],
            "high-throughput"),
        "Part 2 wavelet": (
            cs[:spcod + 4] + b"\x02" + cs[spcod + 5:], "wavelet transform 2"),
    }


NOT_PORTED = _not_ported()


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_extensions_raise_naming_the_marker(tmp_path, case):
    data, name = NOT_PORTED[case]
    path = str(tmp_path / "ext.j2k")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError) as err:
        decode_image(path)
    assert path in str(err.value) and name in str(err.value)


# --- threads and the slice ------------------------------------------------------

def test_threads_decode_the_same_bytes():
    """The C call releases the interpreter lock: eight threads decode the
    9/7 frame at once to the single-thread bytes."""
    from tools.jpeg_fixtures import JP2_FRAME

    with open(os.path.join(FIXTURES, JP2_FRAME), "rb") as f:
        data = f.read()
    want = decode_image_bytes(data)
    got = [None] * 8

    def one(i):
        got[i] = decode_image_bytes(data)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_slice_detections_match_jax_on_cv2s_decode(tmp_path):
    """A seeded scene saved as 9/7 (cv2.imwrite's default) and 5/3 JP2:
    the port's decode + detect_raw give the JAX detector's boxes on cv2's
    decode of the same file (fp32)."""
    import jax.numpy as jnp

    from tests.torch_port import he_weights, to_jax_config
    from yolo_tpu.io import darknet_weights as jdw
    from yolo_tpu.models import graph as jgraph
    from yolo_tpu.models.predict import make_detector as jax_make_detector
    import yolo_tpu_torch
    from yolo_tpu_torch.configs import get_variant
    from yolo_tpu_torch.data.synthetic import write_voc_scenes
    from yolo_tpu_torch.models.predict import detect_raw

    pairs = write_voc_scenes(str(tmp_path), [(90, 120)],
                             np.random.default_rng(13), jpeg_quality=95)
    rgb = decode_image(pairs[0][0])
    files = {"scene97.jp2": cv2.imencode(".jp2", rgb[..., ::-1])[1].tobytes(),
             "scene53.jp2": pil_j2k(rgb)}
    weights = str(tmp_path / "tiny-voc.weights")
    he_weights(get_variant("tiny-voc"), weights, box_scale=0.1,
               objectness_shift=-2.0)
    model = yolo_tpu_torch.load(weights, "tiny-voc", device="cpu",
                                precision="fp32", input_size=160)
    jcfg = to_jax_config(model.cfg)
    params, _ = jdw.load(weights, jcfg.layers)
    jparams = jgraph.params_to_jax(jgraph.fold_params(jcfg.layers, params,
                                                      jcfg.bn_eps))
    detector = jax_make_detector(jcfg, compute_dtype=jnp.float32,
                                 head="fused")
    for name, data in files.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        frame = decode_image(path)
        ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(frame, ref)
        got = detect_raw(model.cfg, model.params,
                         torch.from_numpy(frame[None]), head="fused")
        want = detector(jparams, jnp.asarray(ref[None]))
        v = np.asarray(want["valid"])
        assert v.sum() >= 1, name
        np.testing.assert_array_equal(got["valid"].numpy(), v)
        np.testing.assert_array_equal(got["classes"].numpy()[v],
                                      np.asarray(want["classes"])[v])
        np.testing.assert_allclose(got["boxes"].numpy()[v],
                                   np.asarray(want["boxes"])[v], rtol=0,
                                   atol=1e-2)
