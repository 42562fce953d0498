"""The JPEG kinds beyond one baseline scan, read by the port's decoder
(yolo_tpu_torch/native/jpeg.c) byte for byte as cv2.imdecode gives them
and as the JAX package's load_image (cv2.imread under its default
decoder) gives them from a file, at 1 and 3 channels:

  * progressive Huffman files (cv2's and PIL's encoders, and scan
    scripts of tests/jpeg_writer.py, block smoothing among them);
  * sequential files split over several scans;
  * arithmetic-coded files, sequential and progressive;
  * CMYK and YCCK files (Adobe transforms 0, 1 and 2, or none);
  * lossless files (several scans, subsampled components), where cv2
    reads them.

What cv2 gives no image for raises, naming the file and the reason;
damaged scans decode to cv2's bytes wherever cv2 gives an image, and
coefficients that overflow the IDCT saturate as libjpeg-turbo's SIMD
IDCT saturates them.
"""

import io
import itertools

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tests.jpeg_writer import (Frame, Scan, progressive_script,
                               random_coefficients, sequential_script,
                               write_jpeg, write_lossless)
from tests.torch_port import cv2_idct_saturates
from yolo_tpu.data import pipeline as jpipe
from yolo_tpu_torch.native.preproc import decode_image, decode_image_bytes

torch.set_num_threads(1)

SAMPLINGS = {"420": [(2, 2), (1, 1), (1, 1)], "422": [(2, 1), (1, 1), (1, 1)],
             "440": [(1, 2), (1, 1), (1, 1)], "444": [(1, 1)] * 3,
             "gray": [(1, 1)], "cmyk": [(1, 1)] * 4,
             "cmyk2211": [(2, 2), (1, 1), (1, 1), (2, 2)]}


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


def same_as_cv2(data, tmp_path=None, load=None, channels=(1, 3)):
    """The port's bytes equal cv2.imdecode's at each channel count, and,
    given a tmp_path and the JAX package's load_image, the file's."""
    path = None
    if tmp_path is not None:
        path = str(tmp_path / "kind.jpg")
        with open(path, "wb") as f:
            f.write(data)
    for c in channels:
        want = _cv2(data, c)
        assert want is not None, "cv2 gives no image"
        got = decode_image_bytes(data, c)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if path is not None:
            np.testing.assert_array_equal(decode_image(path, c), got)
            ref = load(path, c)
            np.testing.assert_array_equal(got, ref.reshape(got.shape))


def _picture(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                    (xx * yy) % 256], -1).astype(np.int64)
    img += rng.integers(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _frame(kind, h, w):
    return Frame(w, h, SAMPLINGS[kind])


# --- progressive Huffman -----------------------------------------------------

@pytest.mark.parametrize("sampling,restart", list(itertools.product(
    ["420", "422", "444", "gray"], [0, 2])))
def test_cv2_progressive_jpegs_match_cv2(tmp_path, jax_cv2_decoder, sampling,
                                        restart):
    """cv2.imencode's progressive script (jpeg_simple_progression), with
    restart markers inside each scan, at sizes from 1x1 up."""
    flags = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
    rng = np.random.default_rng(restart + len(sampling))
    for (h, w), q in itertools.product([(1, 1), (9, 17), (40, 61)],
                                       (60, 95)):
        img = _picture(rng, h, w)
        params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY,
                  q, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        if sampling == "gray":
            src = img[..., 0]
        else:
            src = img[..., ::-1]
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flags[sampling]]
        ok, buf = cv2.imencode(".jpg", src, params)
        assert ok
        same_as_cv2(buf.tobytes(), tmp_path, jax_cv2_decoder)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_pil_progressive_jpegs_match_cv2(tmp_path, jax_cv2_decoder,
                                         subsampling):
    rng = np.random.default_rng(subsampling)
    for (h, w), optimize in itertools.product([(7, 5), (33, 50)],
                                              (False, True)):
        b = io.BytesIO()
        Image.fromarray(_picture(rng, h, w)).save(
            b, "JPEG", quality=80, progressive=True, optimize=optimize,
            subsampling=subsampling)
        same_as_cv2(b.getvalue(), tmp_path, jax_cv2_decoder)


def _scripts(n):
    everything = list(range(n))
    return {
        "simple al=1": progressive_script,
        "simple al=3 rst": lambda fr: progressive_script(fr, restart=3,
                                                         al=3),
        "DC only (DC interpolation)": lambda fr: [Scan(everything, 0, 0, 0,
                                                       0)],
        "DC at al=2, no refinement": lambda fr: [Scan(everything, 0, 0, 0,
                                                      2)],
        "AC 1-5 left at al=1 (smoothed)": lambda fr: (
            [Scan(everything, 0, 0, 0, 0)]
            + [Scan([i], 1, 5, 0, 1) for i in everything]),
        "AC 6-63 only": lambda fr: (
            [Scan(everything, 0, 0, 0, 1), Scan(everything, 0, 0, 1, 0)]
            + [Scan([i], 6, 63, 0, 0) for i in everything]),
        "bands of one coefficient, refined twice, rst 1": lambda fr: (
            [Scan(everything, 0, 0, 0, 2, 1)]
            + [Scan([i], k, k, 0, 2, 1) for i in everything
               for k in (1, 2, 3)]
            + [Scan([i], 1, 63, 0, 2, 1) for i in everything[:1]]
            + [Scan([i], 4, 63, 0, 2, 1) for i in everything[1:]]
            + [Scan(everything, 0, 0, 2, 1, 1),
               Scan(everything, 0, 0, 1, 0, 1)]
            + [Scan([i], 1, 63, a, a - 1, 1) for a in (2, 1)
               for i in everything]),
        "one component never scanned": lambda fr: (
            [Scan([0], 0, 0, 0, 0), Scan([0], 1, 63, 0, 0)]),
    }


@pytest.mark.parametrize("sampling", ["420", "444", "gray", "cmyk2211"])
@pytest.mark.parametrize("arithmetic", [False, True])
def test_progressive_scan_scripts_match_cv2(tmp_path, jax_cv2_decoder,
                                            sampling, arithmetic):
    """Scan scripts of the test writer: successive approximation, EOB
    runs and correction bits across restarts, and scripts that leave
    coefficients unrefined at EOI, where jdcoefct.c's block smoothing
    estimates them (and, with no AC data at all, the DC too)."""
    rng = np.random.default_rng(len(sampling) + 10 * arithmetic)
    fr = _frame(sampling, 37, 45)
    coefs = random_coefficients(rng, fr, ac_scale=0.6)
    for name, script in _scripts(fr.ncomp).items():
        data = write_jpeg(fr, coefs, script(fr), progressive=True,
                          arithmetic=arithmetic, jfif=fr.ncomp != 4)
        same_as_cv2(data, tmp_path, jax_cv2_decoder)


# --- multi-scan sequential ---------------------------------------------------

@pytest.mark.parametrize("sampling", ["420", "440", "444", "cmyk2211"])
def test_multiscan_sequential_jpegs_match_cv2(tmp_path, jax_cv2_decoder,
                                              sampling):
    """Components split over scans every way: single-component scans code
    the component's own blocks, interleaved ones whole MCUs; the restart
    interval changes between scans and quantization tables arrive just
    before the scans that first use them."""
    rng = np.random.default_rng(len(sampling))
    fr = _frame(sampling, 29, 43)
    coefs = random_coefficients(rng, fr)
    n = fr.ncomp
    groups = [[[i] for i in range(n)], [[0], list(range(1, n))],
              [list(range(1, n)), [0]], [[n - 1], list(range(n - 1))]]
    for g, restart in itertools.product(groups, (0, 2)):
        scans = sequential_script(fr, g)
        for k, s in enumerate(scans):
            s.restart = restart * (k % 2)
        data = write_jpeg(fr, coefs, scans, jfif=n != 4, late_dqt=True)
        same_as_cv2(data, tmp_path, jax_cv2_decoder)


# --- arithmetic --------------------------------------------------------------

def test_patched_sof9_baseline_matches_cv2(tmp_path, jax_cv2_decoder):
    """A baseline file whose SOF0 reads SOF9: its Huffman bytes decoded
    as arithmetic data, as libjpeg-turbo decodes them."""
    ok, buf = cv2.imencode(".jpg", _picture(np.random.default_rng(0), 24, 40),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = buf.tobytes()
    i = data.index(b"\xff\xc0")
    same_as_cv2(data[:i + 1] + b"\xc9" + data[i + 2:], tmp_path,
                jax_cv2_decoder)


@pytest.mark.parametrize("sampling", ["420", "422", "gray", "cmyk"])
def test_arithmetic_sequential_jpegs_match_cv2(tmp_path, jax_cv2_decoder,
                                               sampling):
    """jcarith.c's QM coder: one scan or several, restart intervals
    (statistics reset at each), DAC conditioning."""
    rng = np.random.default_rng(len(sampling) + 5)
    fr = _frame(sampling, 31, 53)
    coefs = random_coefficients(rng, fr, ac_scale=1.5)
    n = fr.ncomp
    cases = [dict(), dict(scans=sequential_script(fr, restart=1)),
             dict(scans=sequential_script(fr, [[i] for i in range(n)],
                                          restart=3)),
             dict(dac={0: (2, 5, 3), 1: (0, 0, 20)}),
             dict(dac={0: (0, 15, 63), 1: (1, 1, 1)},
                  scans=sequential_script(fr, restart=2))]
    for kw in cases:
        data = write_jpeg(fr, coefs, arithmetic=True, jfif=n != 4, **kw)
        same_as_cv2(data, tmp_path, jax_cv2_decoder)


# --- CMYK and YCCK -----------------------------------------------------------

@pytest.mark.parametrize("adobe", [None, 0, 1, 2])
def test_four_component_jpegs_match_cv2(tmp_path, jax_cv2_decoder, adobe):
    """No Adobe marker or transform 0: CMYK; 1 (which libjpeg warns of)
    and 2: YCCK, converted by jdcolor.c's ycck_cmyk_convert. Then RGB
    or gray as OpenCV converts CMYK."""
    rng = np.random.default_rng(7 if adobe is None else adobe)
    for sampling, (h, w) in itertools.product(["cmyk", "cmyk2211"],
                                              [(8, 8), (23, 41)]):
        fr = _frame(sampling, h, w)
        coefs = random_coefficients(rng, fr, dc_range=120)
        for kw in (dict(), dict(progressive=True)):
            data = write_jpeg(fr, coefs, jfif=False, adobe=adobe, **kw)
            same_as_cv2(data, tmp_path, jax_cv2_decoder)


def test_pil_cmyk_jpegs_of_random_quadruples_match_cv2(tmp_path,
                                                       jax_cv2_decoder):
    """Random CMYK quadruples through PIL's encoder (Adobe marker,
    inverted samples), baseline and progressive."""
    rng = np.random.default_rng(11)
    for (h, w), kw in itertools.product([(1, 1), (16, 16), (19, 37)],
                                        (dict(), dict(progressive=True))):
        cmyk = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        b = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(b, "JPEG", quality=90, **kw)
        same_as_cv2(b.getvalue(), tmp_path, jax_cv2_decoder)


# --- lossless ----------------------------------------------------------------

@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpegs_match_cv2(tmp_path, jax_cv2_decoder, predictor):
    """8-bit lossless frames: gray read as gray, RGB (Adobe transform 0)
    read as colour, with point transforms 0 and 2; the samples come back
    shifted up."""
    rng = np.random.default_rng(predictor)
    samples = rng.integers(0, 256, (13, 21, 3))
    for pt in (0, 2):
        gray = write_lossless(samples[..., :1], predictor=predictor, pt=pt)
        same_as_cv2(gray, tmp_path, jax_cv2_decoder, channels=(1,))
        got = decode_image_bytes(gray, 1)[..., 0]
        np.testing.assert_array_equal(got, (samples[..., 0] >> pt) << pt)
        rgb = write_lossless(samples, predictor=predictor, pt=pt, adobe=0)
        same_as_cv2(rgb, tmp_path, jax_cv2_decoder, channels=(3,))


def _box(plane, fh, fv, h, w):
    return np.repeat(np.repeat(plane, fv, 0), fh, 1)[:h, :w]


def _lossless_kinds():
    """Lossless files split over scans and subsampled: (writer
    arguments, the RGB or gray samples cv2 gives back: box-upsampled,
    as jdsample.c upsamples a lossless frame)."""
    rng = np.random.default_rng(11)
    full = rng.integers(0, 256, (13, 21, 3))
    y = full[..., 0]
    c22, c21, c12 = ([rng.integers(0, 256, s) for _ in range(2)]
                     for s in ((7, 11), (13, 11), (7, 21)))
    s420 = [(2, 2), (1, 1), (1, 1)]
    up22 = np.stack([y] + [_box(c, 2, 2, 13, 21) for c in c22], -1)
    up21 = np.stack([y] + [_box(c, 2, 1, 13, 21) for c in c21], -1)
    up12 = np.stack([y] + [_box(c, 1, 2, 13, 21) for c in c12], -1)
    return {
        "multi-scan Y|CbCr": (dict(samples=full, scans=[[0], [1, 2]],
                                   predictor=4), full),
        "multi-scan 3 scans, restarts": (dict(
            samples=full, scans=[[0], [1], [2]], restart=42, predictor=7,
            pt=1), full >> 1 << 1),
        "420": (dict(samples=[y] + c22, sampling=s420, predictor=1), up22),
        "420 restarts": (dict(samples=[y] + c22, sampling=s420, restart=22,
                              predictor=6), up22),
        "420 3 scans, a restart interval each": (dict(
            samples=[y] + c22, sampling=s420, scans=[[0], [1], [2]],
            restart=[42, 11, 22], predictor=4), up22),
        "420 restarts inside an iMCU row": (dict(
            samples=[y] + c22, sampling=s420, scans=[[0], [1, 2]],
            restart=[21, 11], predictor=2), up22),
        "422": (dict(samples=[y] + c21, sampling=[(2, 1), (1, 1), (1, 1)],
                     predictor=5), up21),
        "440 two scans": (dict(samples=[y] + c12,
                               sampling=[(1, 2), (1, 1), (1, 1)],
                               scans=[[0, 1], [2]], predictor=3), up12),
        "gray sampled 2x2, restarts": (dict(samples=[y], sampling=[(2, 2)],
                                            restart=21, predictor=4), y),
        "CMYK two scans": (dict(samples=rng.integers(0, 256, (13, 21, 4)),
                                scans=[[0, 1], [2, 3]], predictor=1), None),
    }


@pytest.mark.parametrize("kind", sorted(_lossless_kinds()))
def test_lossless_scans_and_sampling_match_cv2(tmp_path, jax_cv2_decoder,
                                               kind):
    """Lossless frames of several scans (restart intervals of whole MCU
    rows, a different one a scan, a restart inside a single component's
    iMCU row) and of subsampled components: the bytes of cv2 and of the
    JAX package's load_image, and the samples written."""
    args, want = _lossless_kinds()[kind]
    gray = want is not None and want.ndim == 2
    data = write_lossless(**args, adobe=None if gray else 0)
    channels = (1,) if gray else (3,) if want is not None else (1, 3)
    same_as_cv2(data, tmp_path, jax_cv2_decoder, channels=channels)
    if want is not None:
        got = decode_image_bytes(data, channels[0])
        np.testing.assert_array_equal(got, want.reshape(got.shape))


def _lossless_refusals():
    samples = np.random.default_rng(0).integers(0, 256, (8, 8, 3))
    gray = write_lossless(samples[..., :1])
    ycc = write_lossless(samples)
    rgb = write_lossless(samples, adobe=0)
    return [("gray as colour", gray, 3), ("RGB as gray", rgb, 1),
            ("YCbCr as gray", ycc, 1), ("YCbCr as colour", ycc, 3),
            ("restart interval of part of a row",
             write_lossless(samples, adobe=0, restart=5), 3),
            ("gray restart interval of a row and a half",
             write_lossless(samples[..., :1], restart=12), 1)]


@pytest.mark.parametrize("case", range(6))
def test_lossless_conversions_cv2_refuses_raise(tmp_path, case):
    """libjpeg-turbo converts no colour space of a lossless frame and
    takes no restart interval that is not whole MCU rows: cv2 gives no
    image, and the port raises, naming the file and why."""
    name, data, channels = _lossless_refusals()[case]
    assert _cv2(data, channels) is None, name
    path = str(tmp_path / "lossless.jpg")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError) as err:
        decode_image(path, channels)
    assert path in str(err.value) and "lossless" in str(err.value)
    assert "cv2 gives no image" in str(err.value)


# --- damage ------------------------------------------------------------------

def _damaged_sources():
    rng = np.random.default_rng(5)
    img = _picture(rng, 48, 64)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                          cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    fr = _frame("420", 48, 64)
    coefs = random_coefficients(rng, fr)
    return {
        "progressive": prog.tobytes(),
        "arithmetic sequential": write_jpeg(
            fr, coefs, sequential_script(fr, restart=2), arithmetic=True),
        "arithmetic progressive": write_jpeg(fr, coefs, progressive=True,
                                             arithmetic=True),
        "multi-scan": write_jpeg(fr, coefs, sequential_script(
            fr, [[0], [1, 2]], restart=3)),
        "lossless multi-scan 420": write_lossless(
            [img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]],
            sampling=[(2, 2), (1, 1), (1, 1)], scans=[[0], [1, 2]],
            restart=[64, 32], predictor=4, adobe=0),
    }


@pytest.mark.parametrize("kind", sorted(_damaged_sources()))
def test_damaged_scans_raise_or_decode(kind):
    """Random damage to the scans' bytes decodes as libjpeg-turbo decodes
    it: wherever cv2 gives an image the port gives its bytes, at 3 and 1
    channels (bad Huffman codes, data cut by a marker, lost and
    out-of-order restart markers, overflowing coefficients), and where
    cv2 gives none the port raises a ValueError."""
    data0 = _damaged_sources()[kind]
    start = data0.index(b"\xff\xda") + 10
    rng = np.random.default_rng(1)
    outcomes = set()
    for _ in range(40):
        data = bytearray(data0)
        for i in rng.integers(start, len(data0) - 2, 4):
            data[i] = int(rng.integers(0, 256))
        data = bytes(data)
        for c in (3, 1):
            want = _cv2(data, c)
            if want is None:
                with pytest.raises(ValueError):
                    decode_image_bytes(data, c)
                outcomes.add("raised")
                continue
            got = decode_image_bytes(data, c)
            assert got.shape == (48, 64, c)
            np.testing.assert_array_equal(got, want)
            outcomes.add("decoded")
    assert "decoded" in outcomes


def _overflowing(kind, sampling, seed, scale):
    """The IDCT's overflow: seeded coefficients scaled and clipped to
    +-1023 (legal baseline values) in a 32x32 frame."""
    fr = _frame(sampling, 32, 32)
    coefs = [np.clip(c * scale, -1023, 1023)
             for c in random_coefficients(np.random.default_rng(seed), fr)]
    return write_jpeg(fr, coefs, progressive=kind.endswith("progressive"),
                      arithmetic=kind.startswith("arithmetic"))


@pytest.mark.parametrize("kind", ["baseline", "progressive", "arithmetic",
                                  "arithmetic progressive"])
@pytest.mark.parametrize("sampling", ["gray", "420"])
def test_overflowing_coefficients_match_cv2(tmp_path, jax_cv2_decoder, kind,
                                            sampling):
    """Coefficients that overflow the islow IDCT (scale 40: 91 of 1024
    gray pixels of seed 3 were 0 or 255 in cv2 and wrapped in the C
    IDCT) give cv2's bytes: libjpeg-turbo's SIMD IDCT wraps the
    dequantization and some sums at 16 bits and saturates at each pack.
    On a host whose cv2 runs another IDCT the port differs only where
    cv2 saturates."""
    saturates = cv2_idct_saturates()
    for seed, scale in ((3, 40), (4, 200), (5, 8)):
        data = _overflowing(kind, sampling, seed, scale)
        if saturates:
            same_as_cv2(data, tmp_path, jax_cv2_decoder)
            continue
        for c in (1, 3):
            want, got = _cv2(data, c), decode_image_bytes(data, c)
            assert np.isin(want[got != want], (0, 255)).all()
