"""TIFF, Sun raster, PFM and Radiance HDR stills as ``cv2.imdecode`` reads
them, through the port's ``data.base.decode_rgb``, against the JAX
package's ``viddet_tpu.cli.serve.decode_image_bytes`` (cv2), bit for bit.

The files come from seeded numpy content through the tests' TIFF writer
(``tests/torch_tiff_writer.py``: byte orders, BigTIFF, strips and tiles,
planar 1 and 2, predictor 2, FillOrder 2, LZW old and new, PackBits,
Deflate, JPEG with ``JPEGTables``, every YCbCr subsampling, forged tags),
through PIL (its libtiff writer: every mode and compression it offers; no
JPEG compression of ``P``, ``1`` or ``LA`` images, which can crash PIL's
process) and through ``cv2.imencode``; the Sun raster, PFM and HDR writers
are below.  Each rule the decoders follow has a case; the refusals raise
ValueError naming the file, the format and the feature, whether cv2 reads
the file or not.  OpenCV 5's own departures (``imread`` of a TIFF turned
by orientation 5-8, uncompressed tiles of a size not a multiple of 1,024
bytes) are asserted as they stand,
so that a later OpenCV shows a change.  ``detect --input one.tif`` writes
what JAX's does.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from tests import torch_tiff_writer as T
from tests.test_torch_image_formats import (  # noqa: F401 (detect_weights: a fixture)
    _detect_both, cv2_rgb, detect_weights, photo,
)
from viddet_tpu_torch.data.base import decode_rgb, imread_rgb
from viddet_tpu_torch.utils.image import apply_orientation

H, W = 29, 37


def assert_tiff_equals_cv2(data: bytes, what: str) -> np.ndarray:
    want = cv2_rgb(data)
    assert want is not None, f"{what}: cv2 refuses the file"
    got = decode_rgb(data, what)
    assert got.dtype == np.uint8 and got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)
    return got


def rng_for(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def samples(rng, spp: int = 3, bps: int = 8, h: int = H, w: int = W) -> np.ndarray:
    """Smooth content (long LZW strings, PackBits runs) with noise in it."""
    base = photo(rng, h, w, 3).astype(np.int64)
    out = np.concatenate([base] * 2, 2)[..., :spp] if spp > 3 else base[..., :spp]
    if spp == 4:
        out[..., 3] = rng.integers(0, 256, (h, w))
    if bps == 16:
        out = out * 257 + rng.integers(0, 257, out.shape)
        out = np.minimum(out, 65535)
    elif bps < 8:
        out = out >> (8 - bps)
    return out


# ---------------------------------------------------------------------------
# the container and the compressions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("big", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_byte_orders_and_bigtiff(order, big, layout):
    rng = rng_for("order", order, big, layout)
    kw = {"rows_per_strip": 7} if layout == "strips" else {"tile": (16, 32)}
    assert_tiff_equals_cv2(T.tiff(samples(rng), order=order, big=big, compression=5, **kw),
                           f"{order} {big} {layout}")


@pytest.mark.parametrize("compression", [1, 5, "5-old", 8, 32946, 32773, 7])
@pytest.mark.parametrize("rows", [None, 8])
def test_compressions(compression, rows):
    rng = rng_for("compression", compression, rows)
    kw = {"compression": 5, "old_lzw": True} if compression == "5-old" else {
        "compression": compression}
    if compression == 7:
        kw.update(photometric=6, subsampling=(2, 2))
    if compression == 32773:
        kw["rng"] = rng
    assert_tiff_equals_cv2(T.tiff(samples(rng), rows_per_strip=rows, **kw), f"{compression}")


def test_lzw_table_resets_and_long_strings():
    """A strip long enough to fill the 4,096-entry table several times, in
    both LZW forms, and a stream with no end code."""
    rng = rng_for("lzw")
    noise = rng.integers(0, 256, (120, 200, 3))
    for old in (False, True):
        assert_tiff_equals_cv2(T.tiff(noise, compression=5, old_lzw=old), f"noise old={old}")
    flat = np.zeros((90, 140, 3), np.int64)
    flat[40:] = 200
    assert_tiff_equals_cv2(T.tiff(flat, compression=5), "long strings")
    raw = T.pack(noise[:10].reshape(10, -1), 8, "<")
    stream = T.lzw(raw + bytes(rng.integers(0, 256, 300, np.uint8)))
    page = T.page(noise[:10], compression=5)
    chunks = [stream[: len(stream) - 100]]  # more than the strip, and no end code
    tags = dict(page[0])
    assert_tiff_equals_cv2(T.layout([(tags, chunks, page[2], page[3])]), "no end code")


@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression", [5, 8])
@pytest.mark.parametrize("planar", [1, 2])
def test_predictor_2(bps, order, compression, planar):
    rng = rng_for("predictor", bps, order, compression, planar)
    data = T.tiff(samples(rng, 3, bps), bps=bps, order=order, compression=compression,
                  predictor=2, planar=planar, rows_per_strip=10)
    assert_tiff_equals_cv2(data, f"predictor {bps} {order} {compression} {planar}")


@pytest.mark.parametrize("compression", [1, 32773])
def test_predictor_tag_is_ignored_without_lzw_or_deflate(compression):
    rng = rng_for("predictor ignored", compression)
    pixels = samples(rng)
    data = T.tiff(pixels, compression=compression, rng=rng,
                  tags={T.PREDICTOR: (T.SHORT, [2])})
    np.testing.assert_array_equal(assert_tiff_equals_cv2(data, "ignored"), pixels)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_fill_order_2(compression):
    rng = rng_for("fill", compression)
    assert_tiff_equals_cv2(T.tiff(samples(rng), compression=compression, fill_order=2,
                                  rng=rng, rows_per_strip=9), f"fill order {compression}")


# ---------------------------------------------------------------------------
# photometric interpretations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bps", [1, 8, 16])
@pytest.mark.parametrize("photometric", [0, 1], ids=["min_is_white", "min_is_black"])
@pytest.mark.parametrize("order", ["<", ">"])
def test_grey(bps, photometric, order):
    """16-bit grey keeps its high byte; MinIsWhite is inverted."""
    rng = rng_for("grey", bps, photometric, order)
    pixels = samples(rng, 1, bps)
    got = assert_tiff_equals_cv2(T.tiff(pixels, bps=bps, photometric=photometric, order=order,
                                        compression=8), f"grey {bps}")
    if bps == 16:
        high = pixels[..., 0] >> 8
        np.testing.assert_array_equal(got[..., 0], high if photometric else 255 - high)


@pytest.mark.parametrize("bps", [1, 4, 8])
@pytest.mark.parametrize("map_bits", [16, 8])
def test_palette(bps, map_bits):
    """A 16-bit colour map is cut by >> 8; one whose entries all lie below
    256 is taken as 8-bit (libtiff's checkcmap)."""
    rng = rng_for("palette", bps, map_bits)
    indices = rng.integers(0, 1 << bps, (H, W, 1))
    cmap = rng.integers(0, 1 << map_bits, (1 << bps, 3))
    got = assert_tiff_equals_cv2(T.tiff(indices, bps=bps, photometric=3, colormap=cmap,
                                        compression=32773), f"palette {bps}")
    np.testing.assert_array_equal(got, (cmap >> 8 if map_bits == 16 else cmap)[indices[..., 0]])


@pytest.mark.parametrize("planar", [1, 2])
def test_cmyk(planar):
    rng = rng_for("cmyk", planar)
    cmyk = rng.integers(0, 256, (H, W, 4))
    got = assert_tiff_equals_cv2(T.tiff(cmyk, photometric=5, planar=planar, compression=5),
                                 "cmyk")
    np.testing.assert_array_equal(got, (255 - cmyk[..., :3]) * (255 - cmyk[..., 3:]) // 255)


SUBSAMPLINGS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)]


# 4x4 and 1x2 data units an odd number wide make libtiff read past what it
# decoded (its scanline size rounds down), so those widths are left out.
YCBCR_SHAPES = [(sub, size) for sub in SUBSAMPLINGS for size in ((16, 24), (13, 17), (9, 8))
                if not (sub == (4, 4) and -(-size[1] // 4) % 2)
                and not (sub == (1, 2) and size[1] % 2)]


@pytest.mark.parametrize("sub,size", YCBCR_SHAPES, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("rows", [None, 4])
def test_ycbcr_uncompressed(sub, size, rows):
    """libtiff's own YCbCr conversion, chroma replicated over its block."""
    h, w = size
    rng = rng_for("ycbcr", sub, size, rows)
    ycc = rng.integers(0, 256, (h, w, 3))
    assert_tiff_equals_cv2(T.tiff(ycc, photometric=6, subsampling=sub, rows_per_strip=rows),
                           f"ycbcr {sub}")


@pytest.mark.parametrize("reference", [None, (16, 235, 128, 240, 128, 240),
                                       (15, 236, 120, 250, 130, 230)], ids=str)
@pytest.mark.parametrize("luma", [None, (0.2126, 0.7152, 0.0722)], ids=str)
def test_ycbcr_reference_and_coefficients(reference, luma):
    rng = rng_for("ycbcr tags", reference, luma)
    ycc = rng.integers(0, 256, (16, 16, 3))
    assert_tiff_equals_cv2(T.tiff(ycc, photometric=6, subsampling=(2, 2), reference=reference,
                                  coefficients=luma), "ycbcr tags")


@pytest.mark.parametrize("case", ["planar_1x1", "lzw_predictor_2x2", "lzw_predictor_1x1",
                                  "tiles_2x2"])
def test_ycbcr_forms(case):
    rng = rng_for("ycbcr form", case)
    ycc = rng.integers(0, 256, (32, 48, 3))
    kw = {"planar_1x1": {"planar": 2, "subsampling": (1, 1)},
          "lzw_predictor_2x2": {"compression": 5, "predictor": 2, "subsampling": (2, 2)},
          "lzw_predictor_1x1": {"compression": 5, "predictor": 2, "subsampling": (1, 1)},
          "tiles_2x2": {"tile": (16, 16), "subsampling": (2, 2), "compression": 8}}[case]
    assert_tiff_equals_cv2(T.tiff(ycc, photometric=6, **kw), case)


JPEG_CASES = {
    "ycbcr_420_strips": {"photometric": 6, "subsampling": (2, 2), "rows_per_strip": 16},
    "ycbcr_420_last_strip_short": {"photometric": 6, "subsampling": (2, 2),
                                   "rows_per_strip": 32},
    "ycbcr_420_tiles": {"photometric": 6, "subsampling": (2, 2), "tile": (32, 32)},
    "ycbcr_422": {"photometric": 6, "subsampling": (2, 1),
                  "jpeg_sampling": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422},
    "ycbcr_444": {"photometric": 6, "subsampling": (1, 1),
                  "jpeg_sampling": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444},
    "rgb_as_stored": {"photometric": 2, "rows_per_strip": 16,
                      "jpeg_sampling": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444},
    "grey": {"photometric": 1, "spp": 1, "tile": (16, 16)},
    "min_is_white": {"photometric": 0, "spp": 1, "rows_per_strip": 8},
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_with_tables(case):
    """Abbreviated JPEG strips and tiles with their JPEGTables: under YCbCr
    libjpeg converts to RGB with its fancy upsampling (libtiff's
    JPEGCOLORMODE_RGB), under other photometrics the samples pass as they
    are."""
    rng = rng_for("jpeg", case)
    kw = dict(JPEG_CASES[case])
    spp = kw.pop("spp", 3)
    pixels = samples(rng, 3, 8, 45, 53)[..., :spp]
    data = T.tiff(pixels, compression=7, quality=85, **kw)
    got = assert_tiff_equals_cv2(data, case)
    if case == "ycbcr_420_strips":  # replicated chroma would not give cv2's picture
        first = T.page(pixels, compression=7, quality=85, **kw)
        tables, strip = first[0][T.JPEG_TABLES][1], first[1][0]
        spliced = strip[:2] + tables[2:-2] + strip[2:]
        whole = cv2.imdecode(np.frombuffer(spliced, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(got[:16], whole)


def test_jpeg_of_subsampled_rgb_is_refused_as_libtiff_refuses_it():
    rng = rng_for("jpeg 420 rgb")
    data = T.tiff(samples(rng), compression=7, photometric=2, rows_per_strip=16)
    assert cv2_rgb(data) is None
    with pytest.raises(ValueError, match="x.tif: TIFF JPEG strip: JPEG component 0 sampled 2x2"):
        decode_rgb(data, "x.tif")


# ---------------------------------------------------------------------------
# alpha, layout, pages, orientation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [None, (0,), (1,), (2,)], ids=str)
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("bps", [8, 16])
def test_rgb_alpha(extra, planar, bps):
    """Associated alpha (and an unspecified fourth sample) dropped,
    unassociated alpha premultiplied as (c * a + 127) // 255."""
    rng = rng_for("alpha", extra, planar, bps)
    rgba = samples(rng, 4, bps)
    got = assert_tiff_equals_cv2(T.tiff(rgba, bps=bps, extra_samples=extra, planar=planar,
                                        compression=8), f"alpha {extra}")
    eight = (rgba + 128) // 257 if bps == 16 else rgba
    want = ((eight[..., :3] * eight[..., 3:] + 127) // 255 if extra == (2,)
            else eight[..., :3])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extra", [None, (1,), (2,)], ids=str)
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
def test_grey_alpha(extra, planar, photometric):
    """Contiguous grey takes its first sample through the grey map; grey in
    planes goes as RGB, so its alpha premultiplies and MinIsWhite stays."""
    rng = rng_for("grey alpha", extra, planar, photometric)
    pixels = samples(rng, 2)
    pixels[..., 1] = rng.integers(0, 256, (H, W))
    assert_tiff_equals_cv2(T.tiff(pixels, photometric=photometric, extra_samples=extra,
                                  planar=planar), f"grey alpha {extra}")


@pytest.mark.parametrize("planar", [1, 2])
def test_sixteen_bit_grey_alpha(planar):
    rng = rng_for("grey16 alpha", planar)
    assert_tiff_equals_cv2(T.tiff(samples(rng, 3, 16)[..., :2], bps=16, photometric=1,
                                  extra_samples=(2,), planar=planar), "grey16 alpha")


@pytest.mark.parametrize("layout", [{"rows_per_strip": 1}, {"rows_per_strip": 11},
                                    {"rows_per_strip": 1000}, {"tile": (16, 16)},
                                    {"tile": (32, 16)}, {"tile": (48, 64)}], ids=str)
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("compression", [5, 32773])
def test_strips_tiles_and_planes(layout, planar, compression):
    rng = rng_for("layout", str(layout), planar, compression)
    assert_tiff_equals_cv2(T.tiff(samples(rng, 3, 8, 50, 70), planar=planar,
                                  compression=compression, rng=rng, **layout), "layout")


def test_uncompressed_tiles_cv2_refuses_are_read():
    """OpenCV 5 (libtiff 4.7) refuses uncompressed tiles whose size is not a
    multiple of 1,024 bytes; the port reads them, as it reads the same tiles
    LZW-compressed, which cv2 does."""
    rng = rng_for("raw tiles")
    pixels = samples(rng, 3, 8, 40, 40)
    for tile, planar in (((16, 16), 1), ((32, 16), 2)):
        raw = T.tiff(pixels, tile=tile, planar=planar)
        assert cv2_rgb(raw) is None
        lzw = assert_tiff_equals_cv2(T.tiff(pixels, tile=tile, planar=planar, compression=5),
                                     "lzw tiles")
        np.testing.assert_array_equal(decode_rgb(raw, "raw tiles"), lzw)
    assert_tiff_equals_cv2(T.tiff(pixels, tile=(32, 32)), "raw tiles of 3,072 bytes")


def test_multi_page_gives_the_first_page():
    rng = rng_for("pages")
    pixels = samples(rng)
    for big in (False, True):
        got = assert_tiff_equals_cv2(T.tiff(pixels, pages=3, big=big, compression=8), "pages")
        np.testing.assert_array_equal(got, pixels)


@pytest.mark.parametrize("orientation", range(0, 10))
@pytest.mark.parametrize("layout", [{"rows_per_strip": 9}, {"tile": (32, 32)}], ids=str)
def test_orientation(orientation, layout):
    """cv2.imdecode turns the page upright for all eight values; where it
    mirrors left to right, libtiff mirrors each tile in place.  0 and 9 are
    refused by libtiff and leave the raster as stored."""
    rng = rng_for("orientation", orientation, str(layout))
    pixels = samples(rng, 3, 8, 70, 90)
    got = assert_tiff_equals_cv2(T.tiff(pixels, orientation=orientation, compression=5,
                                        **layout), f"orientation {orientation}")
    if "rows_per_strip" in layout and 1 <= orientation <= 8:
        np.testing.assert_array_equal(got, apply_orientation(pixels.astype(np.uint8),
                                                             orientation))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_imread_of_orientations_5_to_8_differs_from_imdecode(orientation, tmp_path):
    """OpenCV 5.0.0's ``imread`` returns None for orientations 5-8 (its
    'original_ptr == real_mat.data' assertion), so JAX's ``imread_rgb``
    raises there; ``imdecode`` gives the turned picture, and so does the
    port on every surface (a deviation kept in ROADMAP Queue 3)."""
    rng = rng_for("imread", orientation)
    pixels = samples(rng, 3, 8, 30, 40)
    data = T.tiff(pixels, orientation=orientation)
    path = tmp_path / "turned.tif"
    path.write_bytes(data)
    want = apply_orientation(pixels.astype(np.uint8), orientation)
    np.testing.assert_array_equal(assert_tiff_equals_cv2(data, "imdecode"), want)
    read = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if orientation >= 5:
        assert read is None
    else:
        np.testing.assert_array_equal(read[..., ::-1], want)
    np.testing.assert_array_equal(imread_rgb(str(path)), want)


PIL_MODES = ["RGB", "RGBA", "L", "LA", "P", "1", "CMYK", "YCbCr", "I;16", "I;16B"]
PIL_COMPRESSIONS = ["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits", "jpeg"]


# PIL's libtiff writer refuses JPEG for LA, P, 1 and 16-bit grey, and can
# crash its process after refusing P and writing 1 or LA.
PIL_CASES = [(m, c) for m in PIL_MODES for c in PIL_COMPRESSIONS
             if not (c == "jpeg" and m in ("LA", "P", "1", "I;16", "I;16B"))]


@pytest.mark.parametrize("mode,compression", PIL_CASES)
def test_pil_files(mode, compression):
    rng = rng_for("pil", mode, compression)
    rgb = photo(rng, 41, 55)
    if mode.startswith("I;16"):
        image = Image.fromarray((rgb[..., 0].astype(np.uint16) * 257)).convert(mode)
    else:
        image = Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    image.save(buf, "TIFF", compression=compression)
    assert_tiff_equals_cv2(buf.getvalue(), f"PIL {mode} {compression}")


@pytest.mark.parametrize("what", ["rgb", "grey", "rgb16"])
def test_cv2_written_tiffs(what):
    rng = rng_for("cv2 tiff", what)
    image = {"rgb": photo(rng, 33, 44), "grey": photo(rng, 33, 44)[..., 0],
             "rgb16": photo(rng, 33, 44).astype(np.uint16) * 257}[what]
    assert_tiff_equals_cv2(cv2.imencode(".tiff", image)[1].tobytes(), what)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _pil(mode: str, compression: str) -> bytes:
    rng = rng_for("pil refusal", mode, compression)
    buf = io.BytesIO()
    Image.fromarray(photo(rng, 20, 24)).convert(mode).save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def _refused(case: str) -> bytes:
    rng = rng_for("refused", case)
    pixels = samples(rng)
    if case.startswith("ccitt_"):
        return _pil("1", {"ccitt_g4": "group4", "ccitt_g3": "group3",
                          "ccitt_rle": "tiff_ccitt"}[case])
    compressions = {"lzma": 34925, "zstd": 50000, "webp": 50001, "old_jpeg": 6,
                    "pixarlog": 32909, "unknown_compression": 12345}
    if case in compressions:
        return T.tiff(pixels, compression=compressions[case])
    if case == "signed":
        return T.tiff(pixels, sample_format=2)
    if case == "float":
        return T.tiff(rng.integers(0, 1 << 30, (H, W, 3)), bps=32, sample_format=3)
    if case == "bits_12":
        return T.tiff(samples(rng, 3, 16) >> 4, bps=12)
    if case == "grey_2_bits":
        return T.tiff(samples(rng, 1, 2), bps=2, photometric=1)
    if case == "grey_4_bits":
        return T.tiff(samples(rng, 1, 4), bps=4, photometric=1)
    if case == "palette_16_bits":
        return T.tiff(rng.integers(0, 1 << 16, (H, W, 1)), bps=16, photometric=3,
                      colormap=rng.integers(0, 1 << 16, (1 << 16, 3)))
    if case == "cielab":
        return T.tiff(pixels, photometric=8)
    if case == "inkset_2":
        return T.tiff(samples(rng, 4), photometric=5, inkset=2)
    if case == "five_samples":
        return T.tiff(np.concatenate([pixels, pixels[..., :2]], 2), extra_samples=(0, 0))
    if case == "ycbcr_1x4":
        return T.tiff(pixels, photometric=6, subsampling=(1, 4))
    if case == "no_photometric":
        return T.tiff(pixels, tags={T.PHOTOMETRIC: None})
    if case == "no_byte_counts":
        return T.tiff(pixels, tags={T.STRIP_COUNTS: None})
    if case == "strip_past_end":
        return T.tiff(pixels, rows_per_strip=10, tags={T.STRIP_OFFSETS: (T.LONG, [8, 8, 1 << 20])})
    if case == "lzw_short":
        page = T.page(pixels, compression=5)
        return T.layout([(page[0], [page[1][0][: len(page[1][0]) // 2]], page[2], page[3])])
    raise KeyError(case)


REFUSALS = {  # case: (what the message names, whether cv2 reads the file)
    "ccitt_g4": ("compression CCITT Group 4", True),
    "ccitt_g3": ("compression CCITT Group 3", True),
    "ccitt_rle": ("compression CCITT modified Huffman", True),
    "lzma": ("compression LZMA", False),
    "zstd": ("compression ZSTD", False),
    "webp": ("compression WebP", False),
    "old_jpeg": ("compression old-style JPEG", False),
    "pixarlog": ("compression PixarLog", False),
    "unknown_compression": ("compression 12345", None),
    "signed": ("signed samples", True),
    "float": ("floating-point samples", False),
    "bits_12": ("12-bit samples", False),
    "grey_2_bits": ("2-bit samples", False),
    "grey_4_bits": ("4-bit samples", False),
    "palette_16_bits": ("Palette of 16-bit samples", False),
    "cielab": ("Photometric CIELab", True),
    "inkset_2": ("InkSet 2", False),
    "five_samples": ("5 samples a pixel", False),
    "ycbcr_1x4": ("YCbCr subsampling 1x4", False),
    "no_photometric": ("lacks its Photometric tag", False),
    "no_byte_counts": ("lacks its strip or tile byte counts", None),
    "strip_past_end": ("past the end of the file", None),
    "lzw_short": ("LZW data ends", None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_the_file_tiff_and_the_feature(case):
    """Refused before any pixel, naming the feature; ``None`` marks files
    libtiff mends or reads in part, which the port refuses whole."""
    data = _refused(case)
    feature, cv2_reads = REFUSALS[case]
    if cv2_reads is not None:
        assert (cv2_rgb(data) is not None) == cv2_reads, case
    with pytest.raises(ValueError, match=f"^refused.tif: TIFF .*{feature}"):
        decode_rgb(data, "refused.tif")


def test_damaged_files_raise_value_error_or_decode():
    """Seeded cuts, byte edits and bit flips of LZW, PackBits, Deflate and
    JPEG TIFFs: ValueError or an image, never another error."""
    rng = rng_for("damaged")
    pixels = samples(rng, 3, 8, 40, 48)
    seeds = [T.tiff(pixels, compression=5, tile=(16, 16), planar=2, predictor=2),
             T.tiff(pixels, compression=32773, rows_per_strip=8, rng=rng),
             T.tiff(pixels, compression=8, big=True, order=">"),
             T.tiff(pixels, compression=7, photometric=6, subsampling=(2, 2),
                    rows_per_strip=16),
             T.tiff(pixels, photometric=6, subsampling=(4, 2))]
    decoded = 0
    for i in range(200):
        data = bytearray(seeds[i % len(seeds)])
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(8, len(data)))
            edit = rng.random()
            if edit < 0.5:
                data[pos] ^= 1 << int(rng.integers(0, 8))
            elif edit < 0.8:
                data[pos] = int(rng.integers(0, 256))
            else:
                del data[pos:]
        try:
            image = decode_rgb(bytes(data), f"damaged {i}")
        except ValueError:
            continue
        assert image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3
        decoded += 1
    assert decoded


# ---------------------------------------------------------------------------
# Sun raster, PFM, Radiance HDR
# ---------------------------------------------------------------------------


def sun_raster(pixels: np.ndarray, depth: int, kind: int = 1, colour_map=None,
               map_type=None) -> bytes:
    """A Sun raster of palette indices (depth 1, 8) or RGB (24, 32, stored
    B, G, R and X, B, G, R), rows padded to an even size."""
    h, w = pixels.shape[:2]
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    rows = []
    for row in pixels:
        if depth == 1:
            raw = np.packbits(row.astype(np.uint8)).tobytes()
        elif depth == 8:
            raw = row.astype(np.uint8).tobytes()
        else:
            bgr = row[..., ::-1].astype(np.uint8)
            if depth == 32:
                bgr = np.concatenate([np.full((w, 1), 0xAB, np.uint8), bgr], 1)
            raw = bgr.tobytes()
        rows.append(raw + bytes(pitch - len(raw)))
    cmap = b"" if colour_map is None else np.asarray(colour_map, np.uint8).T.tobytes()
    data = b"".join(rows)
    if map_type is None:
        map_type = 0 if colour_map is None else 1
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind, map_type,
                       len(cmap)) + cmap + data


def pfm(values: np.ndarray, scale: float = -1.0) -> bytes:
    """PF (H, W, 3) or Pf (H, W) of float32 values, rows bottom-up."""
    h, w = values.shape[:2]
    order = "<" if scale < 0 else ">"
    return (b"PF" if values.ndim == 3 else b"Pf") + b"\n%d %d\n%r\n" % (w, h, scale) + (
        values[::-1].astype(order + "f4").tobytes())


def rgbe(values: np.ndarray) -> np.ndarray:
    """Float RGB -> RGBE bytes, as Radiance's float2rgbe writes them."""
    v = values.max(-1)
    mantissa, exponent = np.frexp(v)
    scale = np.where(v > 1e-32, mantissa * 256.0 / np.where(v > 1e-32, v, 1), 0)
    out = np.zeros(values.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (values * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v > 1e-32, exponent + 128, 0)
    return out


def hdr(pixels: np.ndarray, rle: bool = True,
        head: bytes = b"#?RADIANCE\n# made from a seed\nFORMAT=32-bit_rle_rgbe\n\n",
        size: bytes = None) -> bytes:
    """RGBE pixels (H, W, 4) as a Radiance file: new-style RLE scanlines
    (runs of 3 or more, literals of up to 128) or flat."""
    h, w = pixels.shape[:2]
    out = bytearray(head + (size or b"-Y %d +X %d\n" % (h, w)))
    for row in pixels:
        if not (rle and 8 <= w < 0x8000):
            out += row.tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            channel, i = row[:, c].tobytes(), 0
            while i < w:
                run = 1
                while i + run < w and run < 127 and channel[i + run] == channel[i]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, channel[i]])
                    i += run
                    continue
                j = i + 1
                while j < w and j - i < 128 and not (
                        j + 2 < w and channel[j] == channel[j + 1] == channel[j + 2]):
                    j += 1
                out += bytes([j - i]) + channel[i:j]
                i = j
    return bytes(out)


@pytest.mark.parametrize("depth,colour_map", [(1, "none"), (1, "full"), (1, "short"),
                                              (8, "none"), (8, "full"), (8, "short"),
                                              (24, "none"), (32, "none")])
@pytest.mark.parametrize("kind", [0, 1], ids=["old", "standard"])
@pytest.mark.parametrize("width", [7, 8, 9])
def test_sun_raster(depth, kind, width, colour_map):
    rng = rng_for("ras", depth, kind, width, colour_map)
    if depth <= 8:
        pixels = rng.integers(0, 1 << depth, (6, width))
    else:
        pixels = rng.integers(0, 256, (6, width, 3))
    cmap = None
    if colour_map != "none":
        cmap = rng.integers(0, 256, ((1 << depth) // (2 if colour_map == "short" else 1), 3))
    assert_tiff_equals_cv2(sun_raster(pixels, depth, kind, cmap), f"ras {depth}")
    assert_tiff_equals_cv2(cv2.imencode(".ras", photo(rng, 11, width))[1].tobytes(), "cv2 ras")


@pytest.mark.parametrize("case", ["rle", "rgb_type", "type_5", "map_at_24_bits", "map_type_2",
                                  "depth_4", "truncated"])
def test_sun_raster_refusals(case):
    """OpenCV 5 reads neither the RLE nor the RGB type; both refuse alike."""
    rng = rng_for("ras refused", case)
    idx = rng.integers(0, 256, (5, 9))
    data = {"rle": sun_raster(idx, 8, 2), "rgb_type": sun_raster(idx, 8, 3),
            "type_5": sun_raster(idx, 8, 5),
            "map_at_24_bits": sun_raster(rng.integers(0, 256, (5, 9, 3)), 24, 1, np.zeros((2, 3))),
            "map_type_2": sun_raster(idx, 8, 1, rng.integers(0, 256, (256, 3)), map_type=2),
            "depth_4": struct.pack(">8I", 0x59A66A95, 9, 5, 4, 30, 1, 0, 0) + bytes(30),
            "truncated": sun_raster(idx, 8)[:-1]}[case]
    assert cv2_rgb(data) is None
    with pytest.raises(ValueError, match="^x.ras: Sun raster"):
        decode_rgb(data, "x.ras")


@pytest.mark.parametrize("scale", [-1.0, 1.0, -2.0, -3.0, 0.5, -7.25])
def test_pfm(scale):
    """Either byte order, rows bottom-up, values over |scale|, then
    rounded half to even, clamped, no 255 scale."""
    rng = rng_for("pfm", scale)
    values = (rng.random((9, 13, 3)) * 320 - 30).astype(np.float32)
    got = assert_tiff_equals_cv2(pfm(values, scale), "pfm")
    if scale == -1.0:
        np.testing.assert_array_equal(got, np.clip(np.rint(values), 0, 255))


TIES = np.array([0.5, 1.5, 2.5, 127.5, 254.5, 255.5, -0.5, 3.5, 2147483520.0, 2147483648.0,
                 2.5e9, 1e20, np.inf, -np.inf, np.nan, -1e10], np.float32)


def test_pfm_rounding_ties_and_overflow():
    """Half to even, and 0 for NaN and for what overflows a 32-bit integer
    (x86's answer for cvRound there), as OpenCV's saturate_cast gives."""
    values = np.repeat(TIES[None, :, None], 3, 2)
    got = assert_tiff_equals_cv2(pfm(values), "ties")
    np.testing.assert_array_equal(got[0, :, 0], [0, 2, 2, 128, 254, 255, 0, 4, 255, 0, 0, 0, 0,
                                                 0, 0, 0])


@pytest.mark.parametrize("head", [b"PF\n7 5\n-1\n", b"PF\n7\n5\n-1.0\n", b"PF\n7x 5\n-1\n",
                                  b"PF\n+7 5\n-1.0e0\t", b"PF\n7 5\n-0.5junk\n",
                                  b"PF\n7 5\n-0x1p1\n", b"PF\n7 5\n-inf\n"])
def test_pfm_headers_as_atoi_and_atof_read_them(head):
    rng = rng_for("pfm head", head)
    values = (rng.random((5, 7, 3)) * 255).astype(np.float32)
    assert_tiff_equals_cv2(head + values[::-1].astype("<f4").tobytes(), repr(head))


def test_grey_pfm_as_imdecode_gives_it():
    """OpenCV 5's imdecode gives a Pf image as one channel whatever
    IMREAD_COLOR asks, and JAX's BGR-to-RGB conversion makes it three."""
    rng = rng_for("Pf")
    values = (rng.random((6, 11)) * 300 - 20).astype(np.float32)
    data = pfm(values)
    raw = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert raw.shape == (6, 11)
    np.testing.assert_array_equal(raw, np.clip(np.rint(values), 0, 255))
    np.testing.assert_array_equal(assert_tiff_equals_cv2(data, "grey.pfm"),
                                  np.repeat(raw[..., None], 3, 2))


@pytest.mark.parametrize("case", ["space_after_magic", "scale_0", "scale_nan", "zero_height",
                                  "truncated"])
def test_pfm_refusals(case):
    values = np.ones((5, 7, 3), np.float32)
    body = values.astype("<f4").tobytes()
    data = {"space_after_magic": b"PF 7 5\n-1\n" + body, "scale_0": b"PF\n7 5\n0\n" + body,
            "scale_nan": b"PF\n7 5\nnan\n" + body, "zero_height": b"PF\n7  5\n-1\n" + body,
            "truncated": b"PF\n7 5\n-1\n" + body[:-1]}[case]
    assert cv2_rgb(data) is None
    with pytest.raises(ValueError, match="^x.pfm: PFM"):
        decode_rgb(data, "x.pfm")


@pytest.mark.parametrize("rle", [True, False], ids=["rle", "flat"])
@pytest.mark.parametrize("width", [5, 8, 40])
def test_hdr(rle, width):
    """RGBE to float as rgbe2float, then 255 * f rounded half to even."""
    rng = rng_for("hdr", rle, width)
    pixels = rgbe((rng.random((7, width, 3)) * 1.5).astype(np.float32))
    pixels[2, : width // 2] = pixels[2, 0]  # runs
    assert_tiff_equals_cv2(hdr(pixels, rle), "hdr")


def test_hdr_rounding_ties_and_overflow():
    """m * 2^(e - 136) * 255 lands on 127.5 (to 128) and on halves above
    255; bright pixels overflow a 32-bit integer and come out 0."""
    pixels = np.array([[[1, 1, 2, 135], [2, 2, 6, 134], [3, 5, 7, 135], [1, 1, 1, 0],
                        [255, 255, 255, 151], [255, 255, 255, 152], [255, 255, 255, 255],
                        [128, 64, 1, 152], [200, 100, 50, 151], [1, 2, 3, 1]]], np.uint8)
    got = assert_tiff_equals_cv2(hdr(pixels), "ties")
    np.testing.assert_array_equal(got[0, :5, 0], [128, 128, 255, 0, 255])
    np.testing.assert_array_equal(got[0, 5:7], 0)


def test_hdr_rle_then_flat_scanlines():
    """From the first scanline that is not new-style RLE, every pixel is
    read flat (RGBE_ReadPixels_RLE)."""
    rng = rng_for("hdr mixed")
    pixels = rgbe((rng.random((6, 20, 3)) * 2).astype(np.float32))
    data = hdr(pixels[:2]).replace(b"-Y 2 +X 20", b"-Y 6 +X 20") + pixels[2:].tobytes()
    assert_tiff_equals_cv2(data, "mixed")


@pytest.mark.parametrize("head", [
    b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n",
    b"#?RADIANCE\nGAMMA=2.2\nFORMAT=32-bit_rle_rgbe\nEXPOSURE=1\n\n",
    b"#?RADIANCE" + b"x" * 130 + b"\nFORMAT=32-bit_rle_rgbe\n\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n" + b"#" * 126 + b"\n\n",
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nFORMAT=32-bit_rle_xyze\n\n",
], ids=["rgbe", "gamma_exposure", "long_first_line", "line_of_127", "xyze_after_rgbe"])
@pytest.mark.parametrize("size", [b"-Y 6 +X 20\n", b"-Y6+X20\n", b"-Y  6  +X  20 junk\r\n"],
                         ids=["plain", "tight", "loose"])
def test_hdr_headers_as_fgets_and_sscanf_read_them(head, size):
    rng = rng_for("hdr head", head, size)
    pixels = rgbe((rng.random((6, 20, 3)) * 2).astype(np.float32))
    assert_tiff_equals_cv2(hdr(pixels, head=head, size=size), repr(head[:20]))


@pytest.mark.parametrize("case", ["no_format", "xyze", "no_blank_line", "nul_line",
                                  "format_then_nul", "plus_y", "minus_x", "x_first",
                                  "no_size_newline", "bad_run", "truncated"])
def test_hdr_refusals(case):
    rng = rng_for("hdr refused", case)
    pixels = rgbe((rng.random((6, 20, 3)) * 2).astype(np.float32))
    heads = {"no_format": b"#?RADIANCE\n\n", "xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n",
             "no_blank_line": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",
             "nul_line": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\0\n",
             "format_then_nul": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\0x\n\n"}
    sizes = {"plus_y": b"+Y 6 +X 20\n", "minus_x": b"-Y 6 -X 20\n", "x_first": b"+X 20 -Y 6\n",
             "no_size_newline": b"-Y 6 +X 20"}
    if case in heads:
        data = hdr(pixels, head=heads[case])
    elif case in sizes:
        data = hdr(pixels, size=sizes[case])
    elif case == "bad_run":
        data = bytearray(hdr(pixels))
        at = data.index(b"\x02\x02\x00\x14") + 4
        data[at] = 0  # a literal of no bytes
        data = bytes(data)
    else:
        data = hdr(pixels)[:-3]
    if case not in ("bad_run", "truncated"):  # OpenCV ignores a scanline's errors
        assert cv2_rgb(data) is None
    with pytest.raises(ValueError, match="^x.hdr: Radiance HDR"):
        decode_rgb(data, "x.hdr")


def test_cv2_written_hdr_and_pfm():
    rng = rng_for("cv2 float")
    values = rng.random((12, 17, 3)).astype(np.float32)
    assert_tiff_equals_cv2(cv2.imencode(".hdr", values)[1].tobytes(), "cv2 hdr")
    assert_tiff_equals_cv2(cv2.imencode(".pfm", values * 255)[1].tobytes(), "cv2 pfm")


# ---------------------------------------------------------------------------
# the detect surface
# ---------------------------------------------------------------------------


def test_detect_reads_a_single_tiff_as_jax(detect_weights, tmp_path, monkeypatch):
    """One TIFF (tiled, planar, LZW with the predictor) given alone as
    --input: its .txt equal to JAX's, which reads it with cv2.imread."""
    rng = rng_for("detect tiff")
    single = tmp_path / "scene.tif"
    single.write_bytes(T.tiff(photo(rng, 80, 120), compression=5, predictor=2, planar=2,
                              tile=(32, 32)))
    assert _detect_both(str(single), tmp_path / "one", detect_weights, monkeypatch) == [
        "scene.txt"]
