"""The port's image codec (``viddet_tpu_torch.native``) against OpenCV.

Decoding must equal ``cv2.imdecode(buf, IMREAD_COLOR)`` plus the BGR-to-RGB
swap bit for bit, over a seeded corpus written here:

* JPEG by ``cv2``: sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, baseline
  and progressive, qualities 1 to 100, restart intervals, greyscale, sizes
  from 1x1 to 240x320 (odd ones leave partial MCUs at both edges), and the
  same files with their DHT segments stripped (the standard tables then
  apply, as for Motion-JPEG frames);
* JPEG by PIL: progressive with and without optimised tables, restart
  markers every few blocks or rows, greyscale, RGB kept as RGB (Adobe
  transform 0), CMYK, and YCCK (the CMYK file's Adobe transform set to 2);
* PNG written by a small encoder in this file: every colour type at every
  bit depth it allows, plain and Adam7, with every filter type, with tRNS
  and gAMA chunks, plus the files ``cv2`` and PIL write;
* BMP by ``cv2`` (24-bit, and 32-bit with bit fields) and PIL (24- and
  32-bit), bottom-up and top-down.

Bad inputs raise ``ValueError``.  The JPEG encoder writes the bytes
``cv2.imencode(".jpg", ...)`` writes at qualities 75, 90 and 95 (and 50 and
100); the PNG encoder's pixels round-trip exactly, through the port's
decoder and through ``cv2``.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from viddet_tpu_torch.data.base import decode_rgb, imread_rgb
from viddet_tpu_torch.native import decode_bmp, decode_jpeg, decode_png, encode_jpeg, encode_png
from viddet_tpu_torch.utils.image import imencode_jpeg, imwrite

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = ((37, 53), (240, 320), (1, 1), (17, 8), (5, 3), (3, 5), (2, 2), (4, 4), (9, 33), (64, 1))


def _image(h, w, seed=0, channels=3):
    """Smooth noise, so every DCT band and both chroma planes carry data."""
    rng = np.random.default_rng((seed, h, w, channels))
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, channels), dtype=np.uint8), (5, 5), 1.5)
    return img.reshape(h, w, channels)


def _cv2_rgb(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None, "cv2 could not decode the test file"
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _check(data: bytes, what: str):
    got = decode_rgb(data, what)
    want = _cv2_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _cv2_jpeg(image, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", image, list(params))
    assert ok
    return buf.tobytes()


def _pil_jpeg(image: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _segments(data: bytes):
    """(marker, start, end) of each marker segment before the first SOS."""
    i = 2
    while data[i + 1] != 0xDA:
        length = int.from_bytes(data[i + 2 : i + 4], "big")
        yield data[i + 1], i, i + 2 + length
        i += 2 + length


# ---------------------------------------------------------------------------
# JPEG decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sub", sorted(SAMPLING))
def test_cv2_jpeg_samplings_equal_cv2(sub, progressive):
    for h, w in SIZES:
        data = _cv2_jpeg(_image(h, w), cv2.IMWRITE_JPEG_QUALITY, 90,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub],
                         cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
        _check(data, f"{sub} {h}x{w}")


@pytest.mark.parametrize("quality", [1, 10, 50, 100])
def test_cv2_jpeg_qualities_equal_cv2(quality):
    for h, w in ((48, 64), (33, 17)):
        _check(_cv2_jpeg(_image(h, w, seed=2), cv2.IMWRITE_JPEG_QUALITY, quality),
               f"q{quality} {h}x{w}")


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline", "progressive"])
def test_cv2_jpeg_restart_intervals_equal_cv2(interval, progressive):
    for h, w in ((40, 72), (17, 31)):
        data = _cv2_jpeg(_image(h, w, seed=3), cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                         cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
        assert b"\xff\xdd" in data
        _check(data, f"rst{interval} {h}x{w}")


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline", "progressive"])
def test_greyscale_jpeg_equal_cv2(progressive):
    for h, w in ((61, 47), (1, 9), (16, 16)):
        _check(_cv2_jpeg(_image(h, w, channels=1)[..., 0], cv2.IMWRITE_JPEG_PROGRESSIVE,
                         progressive), f"grey {h}x{w}")


def test_jpeg_without_huffman_tables_uses_the_standard_ones():
    """A Motion-JPEG style frame (no DHT): libjpeg-turbo's standard tables."""
    data = _cv2_jpeg(_image(24, 40, seed=4))
    stripped = b"".join(data[s:e] for m, s, e in _segments(data) if m == 0xC4)
    cut = data
    for m, s, e in reversed(list(_segments(data))):
        if m == 0xC4:
            cut = cut[:s] + cut[e:]
    assert stripped and b"\xff\xc4" not in cut[: cut.index(b"\xff\xda")]
    _check(cut, "no DHT")


PIL_CASES = {
    "progressive": dict(progressive=True, quality=85),
    "progressive_optimised": dict(progressive=True, optimize=True, quality=70),
    "optimised": dict(optimize=True, quality=92),
    "restart_blocks": dict(restart_marker_blocks=3, quality=80),
    "restart_rows": dict(restart_marker_rows=1, quality=80, subsampling=2),
    "restart_progressive": dict(restart_marker_blocks=2, progressive=True, quality=75),
    "subsampling_444": dict(subsampling=0, quality=95),
    "subsampling_422": dict(subsampling=1, quality=60),
    "keep_rgb": dict(keep_rgb=True, subsampling=0, quality=90),
}


@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_pil_jpegs_equal_cv2(case):
    for h, w in ((45, 67), (8, 8), (3, 70)):
        data = _pil_jpeg(Image.fromarray(_image(h, w, seed=5)), **PIL_CASES[case])
        _check(data, f"{case} {h}x{w}")


@pytest.mark.parametrize("kind", ["grey", "grey_progressive", "cmyk", "cmyk_progressive", "ycck"])
def test_pil_other_components_equal_cv2(kind):
    for h, w in ((40, 30), (7, 13)):
        rgb = Image.fromarray(_image(h, w, seed=6))
        if kind.startswith("grey"):
            data = _pil_jpeg(rgb.convert("L"), progressive=kind.endswith("progressive"))
        else:
            data = _pil_jpeg(rgb.convert("CMYK"), quality=90,
                             progressive=kind.endswith("progressive"))
            adobe = data.index(b"Adobe")
            assert data[adobe + 11] == 0  # PIL writes plain CMYK
            if kind == "ycck":
                data = data[: adobe + 11] + b"\x02" + data[adobe + 12 :]
        _check(data, f"{kind} {h}x{w}")


def _sof_patched(marker=None, precision=None, size=None) -> bytes:
    data = _cv2_jpeg(_image(16, 16, seed=7))
    sof = data.index(b"\xff\xc0")
    if size is not None:
        data = data[: sof + 5] + struct.pack(">HH", *size) + data[sof + 9 :]
    if marker is not None:
        data = data[: sof + 1] + bytes([marker]) + data[sof + 2 :]
    if precision is not None:
        data = data[: sof + 4] + bytes([precision]) + data[sof + 5 :]
    return data


def _bad_jpegs():
    data = _cv2_jpeg(_image(64, 80, seed=8), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    base = _cv2_jpeg(_image(64, 80, seed=8), cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    rst = base.index(b"\xff\xd0")
    last_sos = data.rindex(b"\xff\xda")
    return {
        "arithmetic": (_sof_patched(marker=0xC9), "arithmetic"),
        "lossless": (_sof_patched(marker=0xC3), "lossless"),
        "twelve_bit": (_sof_patched(precision=12), "12-bit"),
        "truncated_progressive": (data[: len(data) * 2 // 3], ""),
        # the last scans missing: libjpeg would smooth the blocks
        "incomplete_progressive": (data[:last_sos] + b"\xff\xd9", "incomplete"),
        "restart_out_of_order": (base[: rst + 1] + b"\xd3" + base[rst + 2 :], "restart"),
        "garbage": (b"\xff\xd8\xff" + bytes(range(256)) * 4, ""),
        # a forged frame header: 65535 x 65535 pixels is past OpenCV's limit
        "huge": (_sof_patched(size=(65535, 65535)), "exceeds"),
        # two codes of length 1 in the first table: one of them all ones
        "huffman_overflow": (_dht_patched(), "Huffman"),
    }


def _dht_patched() -> bytes:
    data = _cv2_jpeg(_image(16, 16, seed=7))
    counts = data.index(b"\xff\xc4") + 5  # marker, length, table index
    patched = bytearray(data)
    patched[counts] += 2
    patched[counts + 2] -= 2  # the same number of symbols
    return bytes(patched)


def test_mutated_files_decode_or_raise():
    """Seeded random byte edits of JPEG, PNG and BMP files: each decodes or
    raises ValueError (a crash in the C++ codec would take the process)."""
    rng = np.random.default_rng(20)
    img = _image(24, 40, seed=19)
    seeds = [_cv2_jpeg(img), _cv2_jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
             _cv2_jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 1), encode_png(img),
             cv2.imencode(".bmp", img)[1].tobytes()]
    outcomes = {"decoded": 0, "raised": 0}
    for i in range(600):
        data = bytearray(seeds[i % len(seeds)])
        for _ in range(int(rng.integers(1, 6))):
            pos = int(rng.integers(0, len(data)))
            if rng.random() < 0.7:
                data[pos] = int(rng.integers(0, 256))
            else:
                del data[pos : pos + int(rng.integers(1, 12))]
        try:
            decode_rgb(bytes(data), "mutated")
            outcomes["decoded"] += 1
        except ValueError:
            outcomes["raised"] += 1
    assert outcomes["decoded"] > 0 and outcomes["raised"] > 0, outcomes


@pytest.mark.parametrize("case", sorted(_bad_jpegs()))
def test_bad_jpeg_raises(case):
    data, why = _bad_jpegs()[case]
    with pytest.raises(ValueError, match=f"{case}.*{why}"):
        decode_jpeg(data, case)


# ---------------------------------------------------------------------------
# PNG decode
# ---------------------------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row of raw bytes under a random filter type 0-4."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        ft = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0 * row, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][ft]
        out.append(bytes([ft]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) samples -> (h, rowbytes) bytes, big-endian, MSB first."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth :]
    return np.packbits(bits.reshape(samples.shape[0], -1), axis=-1)


def _png(samples, depth, color, interlace=False, palette=None, extra=(), seed=0) -> bytes:
    """A PNG of (H, W, C) samples under random per-row filters."""
    h, w, ch = samples.shape
    rng = np.random.default_rng(seed)
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, rng)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                               int(interlace)))
    for kind, payload in extra:
        out += chunk(kind, payload)
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


PNG_CASES = [(c, d) for c in sorted(DEPTHS) for d in DEPTHS[c]]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_CASES, ids=[f"type{c}_{d}bit" for c, d in PNG_CASES])
def test_png_colour_types_and_depths_equal_cv2(color, depth, interlace):
    top = (1 << depth) - 1
    for h, w in ((1, 1), (7, 13), (19, 9), (33, 40)):
        rng = np.random.default_rng((color, depth, h, w))
        palette = None
        if color == 3:
            n = min(top + 1, 200)  # some PNGs hold fewer entries than indices
            palette = rng.integers(0, 256, (n, 3))
            samples = rng.integers(0, n, (h, w, 1))
        else:
            samples = rng.integers(0, top + 1, (h, w, CHANNELS[color]))
        _check(_png(samples, depth, color, interlace, palette, seed=h),
               f"type {color} {depth}-bit {h}x{w}")


@pytest.mark.parametrize("color,depth", [(0, 8), (0, 16), (2, 8), (2, 16), (3, 4)])
def test_png_trns_and_gamma_are_ignored_as_cv2_ignores_them(color, depth):
    rng = np.random.default_rng(9)
    palette = rng.integers(0, 256, (16, 3)) if color == 3 else None
    samples = rng.integers(0, 16 if color == 3 else 1 << depth, (12, 10, CHANNELS[color]))
    if color == 3:
        trns = bytes(range(0, 160, 10))
    else:  # the colour of the first pixel is the transparent one
        trns = struct.pack(">" + "H" * CHANNELS[color], *(int(v) for v in samples[0, 0]))
    extra = ((b"gAMA", struct.pack(">I", 100000)), (b"tRNS", trns), (b"tEXt", b"k\x00v"))
    if color == 3:  # tRNS follows PLTE
        data = _png(samples, depth, color, palette=palette, extra=extra[:1])
        iend = data.index(b"IDAT") - 4
        tr = extra[1]
        data = data[:iend] + struct.pack(">I", len(tr[1])) + tr[0] + tr[1] + struct.pack(
            ">I", zlib.crc32(tr[0] + tr[1])) + data[iend:]
    else:
        data = _png(samples, depth, color, extra=extra)
    _check(data, f"tRNS type {color}")


@pytest.mark.parametrize("kind", ["cv2_rgb", "cv2_rgba", "cv2_grey16", "cv2_rgb16", "pil_p",
                                  "pil_1bit", "pil_la", "pil_p_trns"])
def test_library_written_pngs_equal_cv2(kind):
    rgb = _image(23, 31, seed=10)
    rng = np.random.default_rng(10)
    if kind.startswith("cv2"):
        image = {"cv2_rgb": rgb, "cv2_rgba": np.dstack([rgb, rgb[..., :1]]),
                 "cv2_grey16": rng.integers(0, 65536, (23, 31), dtype=np.uint16),
                 "cv2_rgb16": rng.integers(0, 65536, (23, 31, 3), dtype=np.uint16)}[kind]
        data = cv2.imencode(".png", image)[1].tobytes()
    else:
        pil = Image.fromarray(rgb)
        buf = io.BytesIO()
        if kind == "pil_p":
            pil.convert("P", palette=Image.ADAPTIVE, colors=12).save(buf, "PNG")
        elif kind == "pil_1bit":
            pil.convert("1").save(buf, "PNG")
        elif kind == "pil_la":
            pil.convert("LA").save(buf, "PNG")
        else:
            pil.convert("P", palette=Image.ADAPTIVE, colors=40).save(buf, "PNG", transparency=2)
        data = buf.getvalue()
    _check(data, kind)


def _bad_pngs():
    good = encode_png(_image(20, 24, seed=11))
    idat = good.index(b"IDAT") - 4
    (n,) = struct.unpack_from(">I", good, idat)
    payload = good[idat + 8 : idat + 8 + n]
    short = payload[: n // 2]
    short_chunk = (struct.pack(">I", len(short)) + b"IDAT" + short
                   + struct.pack(">I", zlib.crc32(b"IDAT" + short)))
    crc = bytearray(good)
    crc[idat + 8 + n] ^= 1
    return {
        "bad_crc": (bytes(crc), "CRC"),
        "short_stream": (good[:idat] + short_chunk + good[idat + 12 + n :], "short"),
        "no_iend": (good[:-12], "IEND"),
        "corrupt_stream": (good[:idat + 8] + bytes(n) + good[idat + 8 + n :], ""),
        "palette_missing": (_png(np.zeros((4, 4, 1), int), 8, 3), "PLTE"),
        "bad_depth": (good[:24] + b"\x05" + good[25:], ""),
        "huge": (_png(np.zeros((1, 1, 3), int), 8, 2)[:16] + _ihdr(40000, 40000)
                 + good[33:], "exceeds"),
    }


def _ihdr(width, height) -> bytes:
    payload = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return payload + struct.pack(">I", zlib.crc32(b"IHDR" + payload))


@pytest.mark.parametrize("case", sorted(_bad_pngs()))
def test_bad_png_raises(case):
    data, why = _bad_pngs()[case]
    with pytest.raises(ValueError, match=f"{case}.*{why}"):
        decode_png(data, case)


# ---------------------------------------------------------------------------
# BMP decode, dispatch
# ---------------------------------------------------------------------------


def _top_down(data: bytes) -> bytes:
    """The same BMP stored top-down: negative height, rows reversed."""
    (offset,) = struct.unpack_from("<I", data, 10)
    width, height, _, bpp = struct.unpack_from("<iiHH", data, 18)
    stride = (width * bpp // 8 + 3) & ~3
    rows = [data[offset + i * stride : offset + (i + 1) * stride] for i in range(height)]
    return (data[:22] + struct.pack("<i", -height) + data[26:offset] + b"".join(rows[::-1])
            + data[offset + height * stride :])


@pytest.mark.parametrize("kind", ["cv2_24", "cv2_32", "pil_24", "pil_32"])
@pytest.mark.parametrize("order", ["bottom_up", "top_down"])
def test_bmps_equal_cv2(kind, order):
    for h, w in ((1, 1), (13, 7), (30, 41)):
        rgb = _image(h, w, seed=12)
        if kind == "cv2_24":
            data = cv2.imencode(".bmp", rgb)[1].tobytes()
        elif kind == "cv2_32":
            data = cv2.imencode(".bmp", np.dstack([rgb, rgb[..., :1]]))[1].tobytes()
        else:
            buf = io.BytesIO()
            mode = "RGB" if kind == "pil_24" else "RGBA"
            Image.fromarray(np.dstack([rgb, rgb[..., :1]])[..., : len(mode)], mode).save(buf, "BMP")
            data = buf.getvalue()
        if order == "top_down":
            data = _top_down(data)
        _check(data, f"{kind} {order} {h}x{w}")


def test_bad_bmps_raise():
    good = cv2.imencode(".bmp", _image(8, 8, seed=13))[1].tobytes()
    with pytest.raises(ValueError, match="truncated"):
        decode_bmp(good[:-40], "short")
    rle = good[:30] + struct.pack("<I", 1) + good[34:]  # RLE8 of 24-bit pixels: cv2 refuses it
    with pytest.raises(ValueError, match="24 bits, compression 1"):
        decode_bmp(rle, "rle")
    eight_bit = good[:28] + struct.pack("<H", 8) + good[30:]  # no room for its 256 colours
    with pytest.raises(ValueError, match="palette is truncated"):
        decode_bmp(eight_bit, "8-bit")


def test_decode_rgb_dispatches_on_magic_bytes(tmp_path):
    rgb = _image(21, 34, seed=14)
    files = {"a.jpg": _cv2_jpeg(rgb), "b.png": encode_png(rgb),
             "c.bmp": cv2.imencode(".bmp", rgb[..., ::-1])[1].tobytes()}
    for name, data in files.items():
        # the extension does not matter, the bytes do
        path = tmp_path / (name + ".bin")
        path.write_bytes(data)
        np.testing.assert_array_equal(imread_rgb(str(path)), _cv2_rgb(data))
    for junk in (b"", b"\x00" * 64):
        with pytest.raises(ValueError, match="junk.*not a JPEG, PNG, BMP, WebP, GIF or PNM"):
            decode_rgb(junk, "junk")
    with pytest.raises(ValueError, match="junk: GIF screen of size 0x0"):  # a GIF, but empty
        decode_rgb(b"GIF89a" + bytes(20), "junk")


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

ENCODE_SIZES = ((480, 640), (37, 53), (1, 1), (17, 8), (15, 17), (16, 16), (9, 300))


@pytest.mark.parametrize("quality", [75, 90, 95, 50, 100])
def test_jpeg_encoder_writes_cv2s_bytes(quality):
    for h, w in ENCODE_SIZES:
        rgb = _image(h, w, seed=15)
        want = _cv2_jpeg(np.ascontiguousarray(rgb[..., ::-1]), cv2.IMWRITE_JPEG_QUALITY, quality)
        got = encode_jpeg(rgb, quality)
        assert got == want, f"{h}x{w}: {len(got)} bytes against cv2's {len(want)}"


def test_jpeg_encoder_on_flat_and_saturated_images():
    """Flat blocks (no AC), pure colours (the colour converter's extremes),
    and noise (long Huffman codes, 0xFF bytes to stuff)."""
    rng = np.random.default_rng(16)
    images = [np.zeros((24, 24, 3), np.uint8), np.full((24, 24, 3), 255, np.uint8),
              np.tile(np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8), (10, 7, 1)),
              rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)]
    for i, rgb in enumerate(images):
        for quality in (75, 95):
            want = _cv2_jpeg(np.ascontiguousarray(rgb[..., ::-1]), cv2.IMWRITE_JPEG_QUALITY,
                             quality)
            assert encode_jpeg(rgb, quality) == want, f"image {i} q{quality}"


def test_png_encoder_round_trips(tmp_path):
    for h, w in ENCODE_SIZES:
        rgb = np.random.default_rng((17, h, w)).integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = encode_png(rgb)
        np.testing.assert_array_equal(decode_png(data), rgb)
        np.testing.assert_array_equal(_cv2_rgb(data), rgb)


def test_imwrite_and_imencode_jpeg(tmp_path):
    rgb = _image(30, 44, seed=18)
    assert imencode_jpeg(rgb) == encode_jpeg(rgb, 95)
    imwrite(str(tmp_path / "a.jpg"), rgb)
    imwrite(str(tmp_path / "a.png"), rgb)
    assert (tmp_path / "a.jpg").read_bytes() == _cv2_jpeg(np.ascontiguousarray(rgb[..., ::-1]),
                                                           cv2.IMWRITE_JPEG_QUALITY, 95)
    np.testing.assert_array_equal(imread_rgb(str(tmp_path / "a.png")), rgb)
    with pytest.raises(ValueError, match="extension"):
        imwrite(str(tmp_path / "a.gif"), rgb)


def test_library_needs_no_image_library():
    """The built library names no libjpeg, libpng or libz among its needs."""
    import subprocess

    from viddet_tpu_torch.native import build

    needed = subprocess.run(["ldd", str(build())], capture_output=True, text=True).stdout
    assert "libstdc++" in needed or "libc." in needed
    for lib in ("libjpeg", "libpng", "libz"):
        assert lib not in needed


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A source that does not compile raises; no other codec is tried."""
    from viddet_tpu_torch import native

    broken = tmp_path / "codec.cpp"
    broken.write_text("int vd_jpeg_header( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="image codec build failed(.|\n)*codec.cpp"):
        native.build()
