"""CCITT bilevel TIFFs, signed samples and CIELab as ``cv2.imdecode`` reads
them, through the port's ``data.base.decode_rgb``, against the JAX
package's decode (cv2), bit for bit.

The files come from seeded content through PIL (its libtiff writer: Group 4,
Group 3 1-D and 2-D, modified Huffman) and through the tests' own writer
(``tests/torch_tiff_writer.py`` ``fax``: every CCITT scheme in strips and
tiles, FillOrder 2, MinIsWhite and MinIsBlack, Group 3 with and without
fill bits and 2-D rows, runs past 2,560 that need the extended make-up
codes).  What libtiff does not decode, or decodes only in part, raises
ValueError naming the file, "TIFF" and the feature.
"""

import io
import zlib

import numpy as np
import pytest
from PIL import Image

from tests import torch_tiff_writer as T
from tests.test_torch_image_formats import cv2_rgb
from tests.test_torch_tiff import assert_tiff_equals_cv2
from viddet_tpu_torch.data.base import decode_rgb


def rng_for(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(("ccitt",) + key).encode()))


def bilevel(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 1) bits in runs of every length class, then speckle below."""
    img = np.zeros((h, w), np.int64)
    for y in range(h):
        x, c = 0, int(rng.integers(0, 2))
        while x < w:
            n = int(rng.choice([1, 2, 3, 5, 17, 70, 300, 1800, 2700]))
            img[y, x : x + n] = c
            x, c = x + n, c ^ 1
    img[h // 2 :] ^= rng.random((h - h // 2, w)) < 0.05
    return img[..., None]


def _pil_ccitt(compression: str, rng, options=None) -> bytes:
    buf = io.BytesIO()
    info = {} if options is None else {T.T4_OPTIONS: options}
    Image.fromarray(rng.random((61, 37)) < 0.3).save(buf, "TIFF", compression=compression,
                                                     tiffinfo=info)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["group4", "group3", "group3_2d", "tiff_ccitt"])
def test_pil_ccitt_files(case):
    rng = rng_for("pil", case)
    compression = "group3" if case == "group3_2d" else case
    data = _pil_ccitt(compression, rng, 1 if case == "group3_2d" else None)
    assert_tiff_equals_cv2(data, case)


SCHEMES = {"mh": (2, 0), "g3_1d": (3, 0), "g3_2d": (3, 1), "g3_fill": (3, 4),
           "g3_2d_fill": (3, 5), "g4": (4, 0)}
LAYOUTS = {"strips": {"rows_per_strip": 5}, "tiles": {"tile": (32, 16)},
           "fill_order_2": {"fill_order": 2}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("photometric", [0, 1], ids=["min_is_white", "min_is_black"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_ccitt_schemes_layouts_and_photometrics(scheme, photometric, layout):
    """Every scheme in strips, tiles and FillOrder 2, at a width that is not
    a multiple of 8, 0 / 255 in all three channels as libtiff's RGBA read
    maps MinIsWhite and MinIsBlack."""
    compression, options = SCHEMES[scheme]
    rng = rng_for(scheme, photometric, layout)
    data = T.tiff(bilevel(rng, 23, 45), bps=1, photometric=photometric,
                  compression=compression, ccitt_options=options, rng=rng, **LAYOUTS[layout])
    got = assert_tiff_equals_cv2(data, f"{scheme} {photometric} {layout}")
    assert set(np.unique(got)) <= {0, 255}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_ccitt_extended_make_up_codes(scheme):
    """Runs of 1,792 to 2,560 and past it (make-up codes repeated)."""
    compression, options = SCHEMES[scheme]
    rng = rng_for("wide", scheme)
    assert_tiff_equals_cv2(T.tiff(bilevel(rng, 6, 5300), bps=1, photometric=0,
                                  compression=compression, ccitt_options=options, rng=rng),
                           f"wide {scheme}")


@pytest.mark.parametrize("compression", [3, 4])
def test_ccitt_uncompressed_option_alone_is_read(compression):
    """T4Options / T6Options bit 1 allows uncompressed mode; a stream that
    never enters it reads as any other."""
    rng = rng_for("uncompressed option", compression)
    assert_tiff_equals_cv2(T.tiff(bilevel(rng, 9, 40), bps=1, photometric=0,
                                  compression=compression, ccitt_options=2 | (compression == 3)),
                           f"options {compression}")


def _g4_with(prefix: str, rng) -> bytes:
    """A Group 4 page whose first row starts with ``prefix`` bits."""
    tags, chunks, offsets, counts = T.page(bilevel(rng, 8, 40), bps=1, photometric=0,
                                           compression=4)
    bits = "".join(f"{b:08b}" for b in chunks[0])
    bits = prefix + bits
    bits += "0" * (-len(bits) % 8)
    return T.layout([(tags, [int(bits, 2).to_bytes(len(bits) // 8, "big")], offsets, counts)])


@pytest.mark.parametrize("case,feature", [
    ("uncompressed", "CCITT Group 4 data: uncompressed mode"),
    ("bad_code", "CCITT Group 4 data: a bad .* code word at row 0"),
    ("eofb_early", "CCITT Group 4 data: an EOL inside a row at row 0"),
    ("cut", "CCITT Group 4 data: .* at row [1-9]"),
    ("two_bits", "compression CCITT Group 4 of 1 8-bit samples"),
    ("rlew", "compression CCITT RLEW"),
])
def test_ccitt_refusals_name_the_file_tiff_and_the_feature(case, feature):
    """libtiff reports these and cv2 keeps what it decoded; the port
    refuses the file whole.  RLEW (32771): libtiff reports bad code words
    in PIL's RLEW files and cv2's picture is not the image written, so it
    stays refused."""
    rng = rng_for("refused", case)
    if case == "uncompressed":
        data = _g4_with("0000001111", rng)
    elif case == "bad_code":
        data = _g4_with("001" + "0000000000110", rng)  # horizontal, then no white code
    elif case == "eofb_early":
        data = _g4_with("000000000001" * 2, rng)
    elif case == "cut":
        tags, chunks, offsets, counts = T.page(bilevel(rng, 40, 64), bps=1, photometric=0,
                                               compression=4)
        data = T.layout([(tags, [chunks[0][: len(chunks[0]) // 2]], offsets, counts)])
    elif case == "two_bits":
        data = T.tiff(rng.integers(0, 256, (8, 8, 1)), bps=8, photometric=1, compression=4)
    else:
        buf = io.BytesIO()
        bits = rng.random((61, 37)) < 0.3
        Image.fromarray(bits).save(buf, "TIFF", compression="tiff_raw_16")
        data = buf.getvalue()
        want = cv2_rgb(data)
        assert want is not None and not np.array_equal(want[..., 0] == 255, bits)
    with pytest.raises(ValueError, match=f"^refused.tif: TIFF .*{feature}"):
        decode_rgb(data, "refused.tif")


def test_damaged_ccitt_raise_value_error_or_decode():
    """Seeded bit flips, byte edits and cuts of every scheme: ValueError or
    an image, never another error."""
    rng = rng_for("damaged")
    seeds = [T.tiff(bilevel(rng, 20, 50), bps=1, photometric=p, compression=c,
                    ccitt_options=o, rng=rng, tile=(32, 16) if c == 4 else None)
             for (c, o), p in zip(SCHEMES.values(), [0, 1, 0, 1, 0, 1])]
    decoded = 0
    for i in range(120):
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
# signed samples and CIELab
# ---------------------------------------------------------------------------

SIGNED = {  # case: (bps, photometric, samples a pixel, more options)
    "grey8": (8, 1, 1, {}), "min_is_white8": (8, 0, 1, {}), "rgb8": (8, 2, 3, {}),
    "rgba8": (8, 2, 4, {"extra_samples": (2,)}), "cmyk8": (8, 5, 4, {}),
    "palette8": (8, 3, 1, {}), "grey16": (16, 1, 1, {}), "min_is_white16": (16, 0, 1, {}),
    "rgb16": (16, 2, 3, {}), "rgba16": (16, 2, 4, {"extra_samples": (2,)}),
    "grey1": (1, 1, 1, {}),
    "rgb8_planes_lzw": (8, 2, 3, {"planar": 2, "compression": 5, "predictor": 2}),
    "rgb16_planes_lzw": (16, 2, 3, {"planar": 2, "compression": 5, "predictor": 2}),
    "ycbcr8": (8, 6, 3, {"subsampling": (2, 2)}),
}


@pytest.mark.parametrize("case", sorted(SIGNED))
def test_signed_samples_read_as_unsigned(case):
    """SampleFormat 2: libtiff's RGBA read ignores the sign at 1, 8 and 16
    bits, under every photometric it reads."""
    bps, photometric, spp, options = SIGNED[case]
    rng = rng_for("signed", case)
    kw = dict(options)
    if photometric == 3:
        kw["colormap"] = rng.integers(0, 256, (256, 3))
    assert_tiff_equals_cv2(T.tiff(rng.integers(0, 1 << bps, (29, 37, spp)), bps=bps,
                                  photometric=photometric, sample_format=2, **kw),
                           f"signed {case}")


def _lab(rng, bps: int) -> np.ndarray:
    """Every L, a and b value along three rows, noise below."""
    px = rng.integers(0, 1 << bps, (24, 256, 3))
    ramp = np.arange(256) * ((1 << bps) - 1) // 255
    for c in range(3):
        px[c, :, c] = ramp
    return px


CIELAB = {  # case: (bps, more options)
    "lab8": (8, {}), "lab16": (16, {}), "lab8_lzw_strips": (8, {"compression": 5,
                                                                 "rows_per_strip": 7}),
    "lab8_d65": (8, {"tags": {T.WHITE_POINT: (T.RATIONAL, [(3127, 10000), (3290, 10000)])}}),
    "lab16_d65_tiles": (16, {"tile": (64, 16), "tags": {
        T.WHITE_POINT: (T.RATIONAL, [(3127, 10000), (3290, 10000)])}}),
    "lab8_big_endian": (8, {"order": ">"}), "lab16_big_endian": (16, {"order": ">"}),
}


@pytest.mark.parametrize("case", sorted(CIELAB))
def test_cielab(case):
    """Photometric CIELab at 8 and 16 bits through libtiff's float
    conversion, with the WhitePoint tag and without it (D50)."""
    bps, options = CIELAB[case]
    rng = rng_for("cielab", case)
    assert_tiff_equals_cv2(T.tiff(_lab(rng, bps), bps=bps, photometric=8, **options), case)


@pytest.mark.parametrize("case,feature", [
    ("cielab_planes", "CIELab of 3 8-bit samples in planes"),
    ("cielab_alpha", "CIELab of 4 8-bit samples"),
    ("cielab_grey", "CIELab of 1 8-bit samples"),
    ("icclab", "Photometric ICCLab"),
    ("itulab", "Photometric ITULab"),
    ("white_point_0", "CIELab WhitePoint out of range"),
])
def test_lab_refusals_which_cv2_refuses_too(case, feature):
    rng = rng_for("lab refused", case)
    px = _lab(rng, 8)
    data = {
        "cielab_planes": lambda: T.tiff(px, photometric=8, planar=2),
        "cielab_alpha": lambda: T.tiff(np.concatenate([px, px[..., :1]], 2), photometric=8,
                                       extra_samples=(2,)),
        "cielab_grey": lambda: T.tiff(px[..., :1], photometric=8),
        "icclab": lambda: T.tiff(px, photometric=9),
        "itulab": lambda: T.tiff(px, photometric=10),
        "white_point_0": lambda: T.tiff(px, photometric=8, tags={
            T.WHITE_POINT: (T.RATIONAL, [(3127, 10000), (0, 1)])}),
    }[case]()
    assert cv2_rgb(data) is None
    with pytest.raises(ValueError, match=f"^refused.tif: TIFF .*{feature}"):
        decode_rgb(data, "refused.tif")
