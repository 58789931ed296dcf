"""Still images as ``cv2.imdecode`` reads them, through the port's
``data.base.decode_rgb``, against the JAX package's
``viddet_tpu.cli.serve.decode_image_bytes`` and
``viddet_tpu.data.base.imread_rgb`` (cv2), bit for bit.

The corpus is made here from seeds with cv2, PIL and the writers below
(BMP, GIF, WebP containers, PNM and PAM laid out by hand, for the forms
neither library writes): PNG ``eXIf`` orientations, every BMP form OpenCV
reads (palettes, RLE8 / RLE4 with their escapes, 16-bit, the OS/2 header),
WebP lossy at qualities 0-100, lossless (with the decoder's feature flags),
alpha, ``EXIF`` and animation, GIF (interlace, transparency, local tables,
a first frame smaller than the screen), P1-P7 and 16-bit samples, and
APNG.  Truncated and bit-flipped files raise ValueError where cv2 returns
None and decode to cv2's pixels where it does not.  The ``serve`` handler
and the ``detect`` CLI read the new formats as JAX's do, a directory's
``.webp`` and ``.gif`` files are skipped alike, and the formats the port
does not read (TIFF, AVIF, JPEG 2000, HDR, PFM, Sun raster) raise naming
themselves.
"""

import functools
import io
import json
import os
import struct
import urllib.request
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from viddet_tpu.cli.serve import decode_image_bytes as jax_decode_image_bytes
from viddet_tpu.cli.serve import detections_to_json as jax_detections_to_json
from viddet_tpu.data.base import imread_rgb as jax_imread_rgb
from viddet_tpu_torch.data.base import decode_rgb, imread_rgb
from viddet_tpu_torch.native.webp import VP8L_FEATURES, decode_webp

# ---------------------------------------------------------------------------
# writers (also used by tests/fixtures/make_image_fixtures.py)
# ---------------------------------------------------------------------------


def photo(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    """Smooth noise with a gradient and a flat corner: every predictor and
    both chroma planes see data."""
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, channels), np.uint8), (5, 5), 1.5)
    img[: h // 3, : w // 3, :3] = (np.arange(w // 3)[None, :, None] * 5 % 256).astype(np.uint8)
    img[h - h // 4 :, w - w // 4 :, :3] = 0
    return img


def texture(rng, h: int, w: int) -> np.ndarray:
    """Upscaled noise with fine grain, a gradient and a copied channel: the
    content on which libwebp's lossless encoder picks every predictor."""
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), np.uint8)
    img = cv2.resize(cv2.GaussianBlur(base, (3, 3), 1), (w, h), interpolation=cv2.INTER_CUBIC)
    img = np.clip(img.astype(int) + rng.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)
    img[: h // 3, : w // 3] = (np.arange(w // 3)[None, :, None] * 3 % 256).astype(np.uint8)
    img[h // 2 :, w // 2 :, 1] = img[h // 2 :, w // 2 :, 0]
    return img


def tiff_exif(orientation: int, endian: str = "II") -> bytes:
    """A TIFF-header EXIF payload with one Orientation entry."""
    e = "<" if endian == "II" else ">"
    return (endian.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def png_chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def png_with_exif(png: bytes, payload: bytes, after_idat: bool = False) -> bytes:
    """``png`` with an ``eXIf`` chunk after IHDR or before IEND."""
    pos = png.rindex(b"IEND") - 4 if after_idat else 33
    return png[:pos] + png_chunk(b"eXIf", payload) + png[pos:]


def bmp(width: int, height: int, bpp: int, compression: int, pixels: bytes, palette: bytes = b"",
        header: int = 40, colours=None, masks: bytes = b"") -> bytes:
    """A BMP file: a 12-byte OS/2 or a 40-byte-or-longer Windows header,
    then masks, palette and pixels."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
    else:
        count = len(palette) // 4 if colours is None else colours
        info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bpp, compression,
                           len(pixels), 2835, 2835, count, 0) + bytes(header - 40)
    offset = 14 + len(info) + len(masks) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + masks
            + palette + pixels)


def bmp_rows(values: np.ndarray, bpp: int) -> bytes:
    """Rows (in file order) of palette indices or 16-bit words, each padded
    to 4 bytes."""
    out = []
    for row in values:
        if bpp == 16:
            raw = row.astype("<u2").tobytes()
        elif bpp == 8:
            raw = row.astype(np.uint8).tobytes()
        else:
            per = 8 // bpp
            padded = np.concatenate([row, np.zeros(-len(row) % per, row.dtype)]).reshape(-1, per)
            raw = sum(padded[:, k].astype(np.uint8) << (8 - bpp * (k + 1))
                      for k in range(per)).astype(np.uint8).tobytes()
        out.append(raw + bytes(-len(raw) % 4))
    return b"".join(out)


def bmp_rle(values: np.ndarray, four: bool, rng, escapes: bool = False) -> bytes:
    """A valid RLE8 / RLE4 stream of the indices (rows in file order):
    encoded and absolute runs at random, an end of line after each row and
    an end of bitmap; with ``escapes`` also deltas, end-of-line codes at
    the start of a row and runs ending a row."""
    h, w = values.shape
    out = bytearray()
    for y in range(h):
        x = 0
        while x < w:
            n = int(rng.integers(1, min(w - x, 255) + 1))
            if escapes and n < w - x and rng.random() < 0.15:  # a delta: skipped pixels
                dx = int(rng.integers(1, min(w - x - n, 255) + 1))
                out += bytes([0, 2, dx, 0])
                x += dx
                continue
            if rng.random() < 0.5 or n < 3:
                first = int(values[y, x])
                second = int(values[y, x + 1]) if x + 1 < w else 0
                out += bytes([n, (first << 4 | second) if four else first])
            else:
                run = values[y, x : x + n]
                if four:
                    run = np.concatenate([run, np.zeros(n % 2, run.dtype)])
                    raw = (run[0::2] << 4 | run[1::2]).astype(np.uint8).tobytes()
                    raw += bytes(((len(raw) + 1) & ~1) - len(raw))
                else:
                    raw = run.astype(np.uint8).tobytes() + bytes(n % 2)
                out += bytes([0, n]) + raw
            x += n
        if y < h - 1 or not escapes:
            out += b"\0\0"
    out += b"\0\1"
    return bytes(out)


def _lzw(indices: np.ndarray, min_size: int) -> bytes:
    """GIF LZW codes of the indices: a clear code first, a clear when the
    table fills, the end code last."""
    clear = 1 << min_size
    size, table, nxt = min_size + 1, {(i,): i for i in range(clear)}, clear + 2
    codes, w = [(clear, size)], ()
    for p in indices.reshape(-1).tolist():
        wp = w + (p,)
        if wp in table:
            w = wp
            continue
        codes.append((table[w], size))
        table[wp], nxt = nxt, nxt + 1
        if nxt - 1 == 1 << size and size < 12:
            size += 1
        if nxt == 4095:
            codes.append((clear, size))
            size, table, nxt = min_size + 1, {(i,): i for i in range(clear)}, clear + 2
        w = (p,)
    if w:
        codes.append((table[w], size))
    codes.append((clear + 1, size))
    buf = bits = 0
    out = bytearray()
    for code, n in codes:
        buf |= code << bits
        bits += n
        while bits >= 8:
            out.append(buf & 255)
            buf >>= 8
            bits -= 8
    if bits:
        out.append(buf & 255)
    return bytes(out)


def _table_flags(colours) -> tuple:
    size = max(0, int(np.ceil(np.log2(max(len(colours), 2)))) - 1)
    table = np.zeros((2 << size, 3), np.uint8)
    table[: len(colours)] = colours
    return size, table.tobytes()


def _interlaced(h: int) -> list:
    return (list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
            + list(range(1, h, 2)))


def gif(width: int, height: int, frames, global_table=None, background: int = 0,
        version: bytes = b"GIF89a") -> bytes:
    """A GIF of ``frames``: dicts of ``indices`` (h, w) and optional ``x``,
    ``y``, ``local`` (a colour table), ``interlace``, ``transparent``."""
    flags, table = 0, b""
    if global_table is not None:
        size, table = _table_flags(global_table)
        flags = 0x80 | 0x70 | size
    out = bytearray(version + struct.pack("<HHBBB", width, height, flags, background, 0) + table)
    for f in frames:
        if f.get("transparent") is not None:
            out += bytes([0x21, 0xF9, 4, 1, 10, 0, f["transparent"], 0])
        indices = f["indices"]
        h, w = indices.shape
        packed, local = 0, b""
        if f.get("local") is not None:
            size, local = _table_flags(f["local"])
            packed = 0x80 | size
        if f.get("interlace"):
            packed |= 0x40
            indices = indices[_interlaced(h)]
        min_size = max(2, int(indices.max()).bit_length())
        data = _lzw(indices, min_size)
        blocks = b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255]
                          for i in range(0, len(data), 255))
        out += (b"\x2c" + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), w, h, packed)
                + local + bytes([min_size]) + blocks + b"\0")
    return bytes(out + b";")


def riff_chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def webp_chunks(data: bytes) -> list:
    """(tag, payload) of the chunks of a WebP file."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag, (n,) = data[pos : pos + 4], struct.unpack_from("<I", data, pos + 4)
        out.append((tag, data[pos + 8 : pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp(chunks) -> bytes:
    body = b"WEBP" + b"".join(riff_chunk(t, p) for t, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(width: int, height: int, flags: int) -> tuple:
    u24 = lambda v: struct.pack("<I", v)[:3]  # noqa: E731
    return b"VP8X", struct.pack("<I", flags) + u24(width - 1) + u24(height - 1)


def webp_animation(frames, width: int, height: int, background=(0, 0, 0, 0)) -> bytes:
    """An animated WebP of ``frames``: (encoded still WebP, x, y, blend,
    dispose), x and y even."""
    u24 = lambda v: struct.pack("<I", v)[:3]  # noqa: E731
    chunks = [vp8x(width, height, 0x12), (b"ANIM", bytes(background) + struct.pack("<H", 0))]
    for data, x, y, blend, dispose in frames:
        still = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        h, w = still.shape[:2]
        image = b"".join(riff_chunk(t, p) for t, p in webp_chunks(data)
                         if t in (b"ALPH", b"VP8 ", b"VP8L"))
        flags = (0 if blend else 2) | (1 if dispose else 0)
        chunks.append((b"ANMF", u24(x // 2) + u24(y // 2) + u24(w - 1) + u24(h - 1) + u24(100)
                       + bytes([flags]) + image))
    return webp(chunks)


def encode_webp(image: np.ndarray, quality: int) -> bytes:
    """cv2's WebP: lossy at 1-100, lossless above 100."""
    return cv2.imencode(".webp", image, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()


def pil_webp(rgb: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "WEBP", **options)
    return buf.getvalue()


def pnm(kind: int, samples: np.ndarray, maxval: int, separator: bytes = b"\n") -> bytes:
    """A P1-P6 file of (h, w) or (h, w, 3) samples, with a comment."""
    h, w = samples.shape[:2]
    head = b"P%d%s# made from a seed\n%d %d" % (kind, separator, w, h)
    if kind not in (1, 4):
        head += b"%s%d" % (separator, maxval)
    head += b"\n"
    rows = samples.reshape(h, -1)
    if kind == 4:
        return head + b"".join(np.packbits(r.astype(np.uint8)).tobytes() for r in rows)
    if kind in (5, 6):
        return head + rows.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    glue = b"" if kind == 1 else b" "
    return head + b"".join(glue.join(b"%d" % v for v in r) + b"\n" for r in rows)


def pam(samples: np.ndarray, maxval: int, tuple_type=None) -> bytes:
    h, w, depth = samples.shape
    head = b"P7\n# made from a seed\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval)
    if tuple_type:
        head += b"TUPLTYPE " + tuple_type + b"\n"
    return head + b"ENDHDR\n" + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def cv2_rgb(data: bytes):
    """JAX's decode of the bytes, or None where cv2 refuses them."""
    try:
        return jax_decode_image_bytes(data)
    except (ValueError, cv2.error):
        return None


def assert_equal_to_jax(data: bytes, what: str):
    want = cv2_rgb(data)
    assert want is not None, f"{what}: cv2 refuses the file"
    got = decode_rgb(data, what)
    assert got.dtype == np.uint8 and got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)
    return got


def assert_agrees_with_cv2(data: bytes, what: str) -> bool:
    """The port raises ValueError where cv2 refuses the bytes and equals it
    elsewhere.  True when it decoded."""
    want = cv2_rgb(data)
    if want is None:
        with pytest.raises(ValueError):
            decode_rgb(data, what)
        return False
    np.testing.assert_array_equal(decode_rgb(data, what), want, err_msg=what)
    return True


SIZES = ((1, 1), (7, 5), (16, 16), (33, 47), (191, 257))

# ---------------------------------------------------------------------------
# PNG eXIf (a fault of earlier slices: the chunk was skipped)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("after_idat", [False, True], ids=["before_idat", "after_idat"])
@pytest.mark.parametrize("endian", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_equals_cv2(orientation, endian, after_idat, tmp_path):
    rng = np.random.default_rng(orientation)
    png = cv2.imencode(".png", rng.integers(0, 256, (5, 7, 3), np.uint8))[1].tobytes()
    data = png_with_exif(png, tiff_exif(orientation, endian), after_idat)
    got = assert_equal_to_jax(data, f"exif {orientation}")
    assert got.shape == ((7, 5, 3) if orientation >= 5 else (5, 7, 3))
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(imread_rgb(str(path)), jax_imread_rgb(str(path)))


@pytest.mark.parametrize("case", ["exif_prefix", "bad_magic", "truncated", "orientation_9",
                                  "first_valid_wins", "invalid_then_valid"])
def test_png_exif_payloads_cv2_ignores_are_ignored(case):
    png = cv2.imencode(".png", photo(np.random.default_rng(3), 9, 14))[1].tobytes()
    payloads = {
        "exif_prefix": [b"Exif\0\0" + tiff_exif(6)],
        "bad_magic": [tiff_exif(6)[:2] + b"\x2b\0" + tiff_exif(6)[4:]],
        "truncated": [tiff_exif(6)[:11]],
        "orientation_9": [tiff_exif(9)],
        "first_valid_wins": [tiff_exif(6), tiff_exif(3)],
        "invalid_then_valid": [b"MM\0\x2b" + tiff_exif(6, "MM")[4:], tiff_exif(8, "MM")],
    }[case]
    data = png[:33] + b"".join(png_chunk(b"eXIf", p) for p in payloads) + png[33:]
    assert_equal_to_jax(data, case)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L"])
@pytest.mark.parametrize("default_image", [False, True])
def test_apng_first_frame_equals_cv2(mode, default_image):
    """cv2 gives the default image when it is the first frame, and the
    first fcTL frame when the default image is not part of the animation."""
    rng = np.random.default_rng(4)
    frames = [Image.fromarray(photo(rng, 21, 34, 4)).convert(mode) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:],
                   default_image=default_image)
    assert_equal_to_jax(buf.getvalue(), f"apng {mode}")
    an = cv2.Animation()
    an.frames = [photo(rng, 21, 34) for _ in range(2)]
    an.durations = [40, 40]
    assert_equal_to_jax(cv2.imencodeanimation(".png", an)[1].tobytes(), "cv2 apng")


# ---------------------------------------------------------------------------
# BMP (cv2's own 8-bit palette form raised before this slice)
# ---------------------------------------------------------------------------


def _bmp_case(form: str, h: int, w: int, rng) -> bytes:
    if form.startswith(("pal", "rle", "os2_pal")):
        bpp = 1 if "1" in form.split("_")[-1] else 4 if "4" in form else 8
        count = 1 << bpp
        if form.endswith("short"):
            count = max(1, count // 3)
        values = rng.integers(0, 1 << bpp, (h, w))
        if form.startswith("os2"):
            table = rng.integers(0, 256, (1 << bpp, 3), np.uint8).tobytes()
            return bmp(w, h, bpp, 0, bmp_rows(values, bpp), table, header=12)
        table = rng.integers(0, 256, (count, 4), np.uint8).tobytes()
        colours = 0 if form.endswith("count0") else None
        if form.startswith("rle"):
            four = bpp == 4
            stream = bmp_rle(values, four, rng, escapes=form.endswith("escapes"))
            return bmp(w, h, bpp, 2 if four else 1, stream, table)
        height = -h if form.endswith("top_down") else h
        return bmp(w, height, bpp, 0, bmp_rows(values, bpp), table, colours=colours)
    if form.startswith("bits"):
        words = rng.integers(0, 1 << 16, (h, w))
        masks = {"bits555": None, "bits565": (0xF800, 0x7E0, 0x1F),
                 "bits555_fields": (0x7C00, 0x3E0, 0x1F)}[form]
        return bmp(w, h, 16, 0 if masks is None else 3, bmp_rows(words, 16),
                   masks=b"" if masks is None else struct.pack("<III", *masks))
    if form == "os2_24":
        rows = [rng.integers(0, 256, 3 * w, np.uint8).tobytes() for _ in range(h)]
        return bmp(w, h, 24, 0, b"".join(r + bytes(-len(r) % 4) for r in rows), header=12)
    if form == "v4_32_fields":  # masks inside the 108-byte header, not read
        rows = rng.integers(0, 256, (h, 4 * w), np.uint8).tobytes()
        return bmp(w, h, 32, 3, rows, header=108)
    if form == "cv2_grey":
        return cv2.imencode(".bmp", photo(rng, h, w)[..., 0])[1].tobytes()
    buf = io.BytesIO()
    Image.fromarray(photo(rng, h, w)).convert(form[4:]).save(buf, "BMP")
    return buf.getvalue()


BMP_FORMS = ["pal1", "pal4", "pal8", "pal8_short", "pal8_count0", "pal4_top_down", "rle8",
             "rle8_escapes", "rle4", "rle4_escapes", "bits555", "bits565", "bits555_fields",
             "os2_pal1", "os2_pal4", "os2_pal8", "os2_24", "v4_32_fields", "cv2_grey", "pil_1",
             "pil_L", "pil_P"]


@pytest.mark.parametrize("form", BMP_FORMS)
def test_bmp_forms_equal_cv2(form, tmp_path):
    rng = np.random.default_rng(BMP_FORMS.index(form))
    for h, w in SIZES:
        data = _bmp_case(form, h, w, rng)
        assert_equal_to_jax(data, f"{form} {h}x{w}")
    path = tmp_path / "x.bmp"
    path.write_bytes(data)
    np.testing.assert_array_equal(imread_rgb(str(path)), jax_imread_rgb(str(path)))


def _refused_bmp(case: str) -> bytes:
    rng = np.random.default_rng(5)
    values = rng.integers(0, 256, (6, 9))
    table = rng.integers(0, 256, (256, 4), np.uint8).tobytes()
    good = bmp(9, 6, 8, 0, bmp_rows(values, 8), table)
    if case == "odd_16bit_masks":
        return bmp(9, 6, 16, 3, bmp_rows(values, 16), masks=struct.pack("<III", 0xF00, 0xF0, 0xF))
    if case == "jpeg_compression":
        return good[:30] + struct.pack("<I", 4) + good[34:]
    if case == "colour_count_300":
        return good[:46] + struct.pack("<I", 300) + good[50:]
    if case == "rle8_with_24_bits":
        return good[:28] + struct.pack("<HI", 24, 1) + good[34:]
    if case == "header_20":
        return good[:14] + struct.pack("<I", 20) + good[18:]
    if case == "palette_truncated":
        return good[:300]
    if case == "rle_run_past_row":
        return bmp(4, 2, 8, 1, bytes([5, 1, 0, 0, 0, 1]), table)
    if case == "rle_truncated":
        return bmp(4, 2, 8, 1, bytes([4, 1, 0, 0, 2]), table)
    return bmp(4, 2, 4, 2, bytes([4, 0x12, 0, 1]), table[:64])  # RLE4 end of bitmap ends a row


@pytest.mark.parametrize("case", ["odd_16bit_masks", "jpeg_compression", "colour_count_300",
                                  "rle8_with_24_bits", "header_20", "palette_truncated",
                                  "rle_run_past_row", "rle_truncated", "rle4_early_end"])
def test_bmp_forms_cv2_refuses_raise(case):
    data = _refused_bmp(case)
    assert cv2_rgb(data) is None
    with pytest.raises(ValueError, match=case):
        decode_rgb(data, case)


# ---------------------------------------------------------------------------
# WebP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [1, 10, 25, 40, 50, 60, 75, 85, 90, 95, 100])
def test_webp_lossy_equals_cv2(quality):
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        data = encode_webp(photo(rng, h, w)[..., ::-1], quality)
        assert webp_chunks(data)[0][0] == b"VP8 "
        assert_equal_to_jax(data, f"q{quality} {h}x{w}")


@functools.lru_cache(maxsize=1)
def _lossless_corpus() -> tuple:
    """(name, file) of lossless WebPs: cv2's, and PIL's at every method on
    photos and on images of 256, 16, 4 and 2 colours (colour-indexing and
    its pixel bundling)."""
    rng = np.random.default_rng(6)
    files = [("cv2", encode_webp(photo(rng, 61, 83), 101))]
    for method in range(7):
        h, w = (191, 257) if method == 4 else (int(rng.integers(40, 160)), int(rng.integers(40, 160)))
        files.append((f"photo m{method}", pil_webp(texture(rng, h, w), lossless=True,
                                                   quality=int(rng.integers(0, 101)),
                                                   method=method)))
        for colours in (256, 16, 4, 2):
            table = rng.integers(0, 256, (colours, 3), np.uint8)
            pattern = (np.arange(h)[:, None] // 7 + np.arange(w)[None, :] // 5) % colours
            image = table[pattern if method % 2 else rng.integers(0, colours, (h, w))]
            files.append((f"{colours} colours m{method}",
                          pil_webp(image, lossless=True, method=method)))
    return tuple(files)


@pytest.mark.parametrize("group", ["cv2", "photo", "256", "16", "4", "2"])
def test_webp_lossless_equals_cv2(group):
    for name, data in _lossless_corpus():
        if name.split()[0] == group:
            assert webp_chunks(data)[0][0] == b"VP8L"
            assert_equal_to_jax(data, name)


def test_webp_lossless_corpus_exercises_every_feature():
    """The decoder's flags over the corpus: every transform, every bundling,
    the colour cache and its hits, LZ77, meta prefix codes, simple and
    normal codes, and predictor modes 1-13."""
    used, modes = set(), set()
    for name, data in _lossless_corpus():
        flags = {}
        decode_webp(data, name, flags)
        used |= flags["features"]
        modes |= flags["predictor_modes"]
    assert used == set(VP8L_FEATURES), set(VP8L_FEATURES) - used
    assert modes >= set(range(1, 14)), set(range(1, 14)) - modes


@pytest.mark.parametrize("quality", [80, 101], ids=["lossy", "lossless"])
def test_webp_alpha_equals_cv2(quality):
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        image = photo(rng, h, w, 4)
        image[..., 3] = rng.integers(0, 256, (h, w))
        data = encode_webp(image, quality)
        if quality < 101:
            assert [t for t, _ in webp_chunks(data)][:3] == [b"VP8X", b"ALPH", b"VP8 "]
        assert_equal_to_jax(data, f"alpha {h}x{w}")


@pytest.mark.parametrize("flag", [True, False], ids=["exif_flag", "no_flag"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_webp_exif_orientation_equals_cv2(orientation, flag):
    """The EXIF chunk turns the image only under the VP8X EXIF flag."""
    rng = np.random.default_rng(orientation)
    for quality in (70, 101):
        h, w = 11, 18
        image = webp_chunks(encode_webp(photo(rng, h, w), quality))
        payload = tiff_exif(orientation, "II" if quality < 101 else "MM")
        data = webp([vp8x(w, h, 0x08 if flag else 0), *image, (b"EXIF", payload)])
        got = assert_equal_to_jax(data, f"exif {orientation}")
        assert got.shape[0] == (w if flag and orientation >= 5 else h)


@pytest.mark.parametrize("case", ["offset_blend", "offset_no_blend_dispose", "lossy_frames",
                                  "background", "pil", "cv2", "extended_chunks"])
def test_webp_animation_and_extended_forms_equal_cv2(case):
    rng = np.random.default_rng(len(case))
    frame = photo(rng, 13, 20, 4)
    frame[..., 3] = rng.integers(0, 256, (13, 20))
    lossless, lossy = encode_webp(frame, 101), encode_webp(frame, 70)
    if case == "extended_chunks":  # ICCP, XMP and an unknown chunk beside the image
        data = webp([vp8x(20, 13, 0x24), (b"ICCP", bytes(40)), *webp_chunks(lossy)[1:],
                     (b"XMP ", b"<x/>"), (b"ABCD", b"12345")])
    elif case == "pil":
        frames = [Image.fromarray(photo(rng, 30, 40)) for _ in range(3)]
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], quality=60)
        data = buf.getvalue()
    elif case == "cv2":
        an = cv2.Animation()
        an.frames = [photo(rng, 30, 40) for _ in range(3)]
        an.durations = [40] * 3
        data = cv2.imencodeanimation(".webp", an)[1].tobytes()
    else:
        first = lossy if case == "lossy_frames" else lossless
        x, y = (6, 4) if case.startswith("offset") else (0, 0)
        background = (10, 20, 30, 255) if case == "background" else (0, 0, 0, 0)
        data = webp_animation([(first, x, y, case != "offset_no_blend_dispose",
                                case == "offset_no_blend_dispose"),
                               (lossless, 0, 0, True, False)], 30, 22, background)
    assert_equal_to_jax(data, case)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _gif_case(case: str, rng) -> bytes:
    table = rng.integers(0, 256, (16, 3), np.uint8)
    if case in ("pil", "pil_interlaced", "pil_animated"):
        buf = io.BytesIO()
        frames = [Image.fromarray(photo(rng, 37, 53)) for _ in range(3)]
        if case == "pil_animated":
            frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], transparency=0,
                           disposal=2)
        else:
            frames[0].save(buf, "GIF", interlace=case == "pil_interlaced")
        return buf.getvalue()
    if case in ("cv2", "cv2_animated"):
        if case == "cv2":
            return cv2.imencode(".gif", photo(rng, 37, 53))[1].tobytes()
        an = cv2.Animation()
        an.frames = [photo(rng, 37, 53) for _ in range(2)]
        an.durations = [50, 50]
        return cv2.imencodeanimation(".gif", an)[1].tobytes()
    indices = rng.integers(0, 16, (19, 23))
    frame = {"indices": indices}
    screen, version, background, global_table = (23, 19), b"GIF89a", 3, table
    if case == "interlaced":
        frame["interlace"] = True
    elif case == "transparent":
        frame["transparent"] = 5
    elif case == "local_table":
        frame["local"] = rng.integers(0, 256, (4, 3), np.uint8)  # over the first 4 of 16
    elif case == "local_only":
        frame["local"], global_table = table, None
    elif case == "no_table":
        global_table = None
    elif case == "small_frame":  # on a larger screen, transparent, at an offset
        screen, frame["x"], frame["y"], frame["transparent"] = (40, 31), 9, 5, 2
    elif case == "gif87a":
        version = b"GIF87a"
    elif case == "big_lzw":  # a table that fills and clears
        frame["indices"] = rng.integers(0, 16, (150, 200))
        screen = (200, 150)
    later = {"indices": rng.integers(0, 16, (19, 23))}
    return gif(*screen, [frame, later], global_table, background, version)


GIF_CASES = ["interlaced", "transparent", "local_table", "local_only", "no_table",
             "small_frame", "gif87a", "big_lzw", "pil", "pil_interlaced", "pil_animated", "cv2",
             "cv2_animated"]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_first_frame_equals_cv2(case):
    rng = np.random.default_rng(GIF_CASES.index(case))
    assert_equal_to_jax(_gif_case(case, rng), case)


@pytest.mark.parametrize("case", ["index_past_table", "background_past_table",
                                  "frame_past_screen", "no_trailer", "short_lzw", "bad_block"])
def test_gif_cv2_refuses_raise(case):
    rng = np.random.default_rng(8)
    table = rng.integers(0, 256, (4, 3), np.uint8)
    indices = rng.integers(0, 4, (6, 7))
    data = gif(7, 6, [{"indices": indices}], table)
    if case == "index_past_table":
        indices[0, 0] = 6
        data = gif(7, 6, [{"indices": indices}], table)
    elif case == "background_past_table":
        data = gif(7, 6, [{"indices": indices}], table, background=9)
    elif case == "frame_past_screen":
        data = gif(7, 6, [{"indices": indices, "x": 3}], table)
    elif case == "no_trailer":
        data = data[:-1]
    elif case == "short_lzw":  # the image says 6 rows, its LZW codes hold 5
        data = bytearray(gif(7, 6, [{"indices": indices[:5]}], table))
        data[13 + 12 + 7] = 6
        data = bytes(data)
    else:
        data = data[:-1] + b"\x42;"
    assert cv2_rgb(data) is None
    with pytest.raises(ValueError, match=case):
        decode_rgb(data, case)


# ---------------------------------------------------------------------------
# PNM and PAM
# ---------------------------------------------------------------------------


def _pnm_case(case: str, rng) -> bytes:
    h, w = 13, 17
    if case.startswith(("P1", "P4")):
        return pnm(int(case[1]), rng.integers(0, 2, (h, w)), 1)
    kind = int(case[1])
    channels = 3 if kind in (3, 6) else 1
    maxval = {"8": 255, "7": 7, "16": 65535, "1000": 1000}[case.split("_")[1]]
    shape = (h, w, channels) if channels == 3 else (h, w)
    samples = rng.integers(0, maxval + 1, shape)
    if kind in (2, 3) and maxval < 1000:
        samples = np.minimum(samples + 3, maxval + 20)  # some past the maxval: clamped
    return pnm(kind, samples, maxval, separator=b" \t" if kind % 2 else b"\n")


PNM_CASES = ["P1", "P4", "P2_8", "P2_7", "P2_16", "P3_8", "P3_7", "P3_1000", "P5_8", "P5_7",
             "P5_16", "P6_8", "P6_1000", "P6_16"]


@pytest.mark.parametrize("case", PNM_CASES)
def test_pnm_equals_cv2(case, tmp_path):
    data = _pnm_case(case, np.random.default_rng(PNM_CASES.index(case)))
    assert_equal_to_jax(data, case)
    path = tmp_path / "x.ppm"
    path.write_bytes(data)
    np.testing.assert_array_equal(imread_rgb(str(path)), jax_imread_rgb(str(path)))


@pytest.mark.parametrize("case", ["cv2_pgm", "cv2_ppm", "cv2_ppm16", "cv2_pbm", "cv2_pam",
                                  "cv2_pgm_ascii", "pam_rgb", "pam_gray", "pam_bw", "pam_rgb16",
                                  "pam_no_type"])
def test_pnm_writers_and_pam_equal_cv2(case):
    """cv2's PxM / PAM writers, and P7 files of the tuple types whose
    pixels cv2 writes in full (RGB comes out with R and B swapped, as cv2
    copies it into BGR)."""
    rng = np.random.default_rng(len(case))
    image = photo(rng, 11, 14)
    data = {
        "cv2_pgm": lambda: cv2.imencode(".pgm", image[..., 0])[1].tobytes(),
        "cv2_ppm": lambda: cv2.imencode(".ppm", image)[1].tobytes(),
        "cv2_ppm16": lambda: cv2.imencode(".ppm", image.astype(np.uint16) * 257)[1].tobytes(),
        "cv2_pbm": lambda: cv2.imencode(".pbm", image[..., 0])[1].tobytes(),
        "cv2_pam": lambda: cv2.imencode(".pam", image)[1].tobytes(),
        "cv2_pgm_ascii": lambda: cv2.imencode(".pgm", image[..., 0],
                                              [cv2.IMWRITE_PXM_BINARY, 0])[1].tobytes(),
        "pam_rgb": lambda: pam(image, 255, b"RGB"),
        "pam_gray": lambda: pam(image[..., :1], 200, b"GRAYSCALE"),
        "pam_bw": lambda: pam(rng.integers(0, 2, (11, 14, 1)), 1, b"BLACKANDWHITE"),
        "pam_rgb16": lambda: pam(image.astype(np.uint16) * 251, 65535, b"RGB"),
        "pam_no_type": lambda: pam(image, 255),
    }[case]()
    got = assert_equal_to_jax(data, case)
    if case == "pam_rgb":
        np.testing.assert_array_equal(got, image[..., ::-1])


def test_pam_with_alpha_drops_it():
    """cv2 converts only part of each row of a two- or four-channel PAM and
    leaves the rest as memory held it; the port gives every pixel."""
    rng = np.random.default_rng(9)
    rgba = rng.integers(0, 256, (5, 6, 4))
    np.testing.assert_array_equal(decode_rgb(pam(rgba, 255, b"RGB_ALPHA"), "rgba"),
                                  rgba[..., :3])
    grey_alpha = rng.integers(0, 256, (5, 6, 2))
    np.testing.assert_array_equal(decode_rgb(pam(grey_alpha, 255, b"GRAYSCALE_ALPHA"), "ga"),
                                  np.repeat(grey_alpha[..., :1], 3, 2))


# ---------------------------------------------------------------------------
# damaged files
# ---------------------------------------------------------------------------


def _mutation_seeds(kind: str) -> list:
    rng = np.random.default_rng(10)
    image = photo(rng, 29, 37)
    if kind == "webp_lossy":
        return [encode_webp(image, q) for q in (30, 90)]
    if kind == "webp_lossless":
        return [encode_webp(image, 101), pil_webp(image, lossless=True, method=6)]
    if kind == "gif":
        return [_gif_case("pil", rng), _gif_case("small_frame", rng)]
    if kind == "bmp":
        return [_bmp_case("rle8_escapes", 23, 31, rng), _bmp_case("cv2_grey", 23, 31, rng),
                _bmp_case("rle4", 23, 31, rng)]
    if kind == "pnm":
        return [_pnm_case("P6_8", rng), _pnm_case("P3_7", rng), pam(image, 255, b"RGB")]
    png = cv2.imencode(".png", image)[1].tobytes()
    return [png_with_exif(png, tiff_exif(6))]


@pytest.mark.parametrize("kind", ["webp_lossy", "webp_lossless", "gif", "bmp", "pnm", "png"])
def test_truncated_and_bit_flipped_files_agree_with_cv2(kind):
    """Seeded byte edits, cuts and bit flips: the port raises ValueError
    where cv2 refuses the file and equals its pixels where it does not (a
    crash in the C++ decoders would take the process)."""
    rng = np.random.default_rng(11)
    seeds = _mutation_seeds(kind)
    decoded = refused = 0
    for i in range(150):
        data = bytearray(seeds[i % len(seeds)])
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, len(data)))
            edit = rng.random()
            if edit < 0.4:
                data[pos] ^= 1 << int(rng.integers(0, 8))
            elif edit < 0.7:
                data[pos] = int(rng.integers(0, 256))
            elif edit < 0.9:
                del data[pos : pos + int(rng.integers(1, 12))]
            else:
                del data[pos:]
            if not data:
                data = bytearray(seeds[0][:1])
        if assert_agrees_with_cv2(bytes(data), f"{kind} {i}"):
            decoded += 1
        else:
            refused += 1
    assert decoded and refused, (decoded, refused)


# ---------------------------------------------------------------------------
# formats the port does not read, and the surfaces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,ext", [("TIFF", ".tiff"), ("AVIF", ".avif"),
                                      ("JPEG 2000", ".jp2"), ("Radiance HDR", ".hdr"),
                                      ("PFM", ".pfm"), ("Sun raster", ".ras")])
def test_refused_formats_raise_naming_themselves(kind, ext):
    image = photo(np.random.default_rng(12), 64, 64)
    if ext in (".hdr", ".pfm"):
        image = image.astype(np.float32) / 255
    data = cv2.imencode(ext, image)[1].tobytes()
    assert cv2_rgb(data) is not None  # cv2 reads it
    with pytest.raises(ValueError, match=f"upload: {kind} images are not decoded"):
        decode_rgb(data, "upload")


def _uploads() -> dict:
    rng = np.random.default_rng(13)
    png = cv2.imencode(".png", photo(rng, 45, 70))[1].tobytes()
    return {
        "webp_lossy": encode_webp(photo(rng, 60, 90), 80),
        "webp_lossless": encode_webp(photo(rng, 41, 66), 101),
        "gif": _gif_case("pil", rng),
        "ppm": cv2.imencode(".ppm", photo(rng, 50, 40))[1].tobytes(),
        "bmp8": cv2.imencode(".bmp", photo(rng, 33, 52)[..., 0])[1].tobytes(),
        "png_exif6": png_with_exif(png, tiff_exif(6)),
    }


@pytest.fixture(scope="module")
def server():
    from viddet_tpu_torch.cli.common import setup_logging
    from viddet_tpu_torch.cli.serve import parse_args, serve_forever

    args = parse_args(["--network", "yolo3_tiny_darknet", "--dataset", "voc",
                       "--data-shape", "64", "--batch-size", "2", "--port", "0",
                       "--thresh", "0.0", "--platform", "cpu"])
    srv = serve_forever(args, setup_logging())
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.viddet_service.close()


@pytest.mark.parametrize("upload", sorted(_uploads()))
def test_serve_replies_to_new_uploads_as_jax(server, upload):
    """The reply equals JAX's ``detections_to_json`` over the direct
    predictor on JAX's decode of the upload (``cv2.imdecode``)."""
    from viddet_tpu_torch.cli.common import build_model, load_weights_or_seed, make_predictor
    from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
    from viddet_tpu_torch.infer.service import to_device_batch

    data = _uploads()[upload]
    req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/detect",
                                 data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        got = json.loads(resp.read())
    rgb = jax_decode_image_bytes(data)
    model, names = build_model("yolo3_tiny_darknet", "voc", device="cpu")
    load_weights_or_seed(model, "")
    x, _, affine = ValTransform(size=(64, 64), letterbox_resize=True, normalize=False)(rgb)
    ids, scores, boxes = (t.numpy() for t in make_predictor(model)(
        to_device_batch(x[None], 2, torch.device("cpu"))))
    want = jax_detections_to_json(ids[0], scores[0], invert_affine_to_boxes(boxes[0], affine),
                                  names, 0.0)
    want["width"], want["height"] = rgb.shape[1], rgb.shape[0]
    assert got == want


@pytest.mark.parametrize("body", ["truncated_webp", "corrupt_gif", "tiff"])
def test_serve_answers_400_for_what_it_cannot_read(server, body):
    data = {"truncated_webp": _uploads()["webp_lossy"][:-100],
            "corrupt_gif": _uploads()["gif"][:-1],
            "tiff": cv2.imencode(".tiff", photo(np.random.default_rng(14), 8, 8))[1].tobytes()}[body]
    req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/detect",
                                 data=data, method="POST")
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(req, timeout=60)
    assert info.value.code == 400 and "error" in json.loads(info.value.read())


@pytest.fixture(scope="module")
def detect_weights(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
    from viddet_tpu.models.zoo import get_model as jax_get_model
    from viddet_tpu.train.state import save_weights_npz

    module, _ = jax_get_model("yolo3_tiny_darknet_voc", policy=JAX_F32)
    variables = module.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)
    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    save_weights_npz(path, variables["params"], variables["batch_stats"])
    return path


def _detect_both(inputs: str, out, weights: str, monkeypatch):
    import jax

    import viddet_tpu.cli.detect as jax_detect
    import viddet_tpu.native as jax_native
    import viddet_tpu_torch.cli.detect as torch_detect
    from viddet_tpu.core.precision import FLOAT32_POLICY as JAX_F32
    from viddet_tpu_torch.core.precision import FLOAT32_POLICY

    monkeypatch.setattr(jax_detect, "build_model",
                        functools.partial(jax_detect.build_model, policy=JAX_F32))
    monkeypatch.setattr(torch_detect, "build_model",
                        functools.partial(torch_detect.build_model, policy=FLOAT32_POLICY))
    monkeypatch.setattr(jax_native, "available", lambda: False)  # JAX's per-file route
    monkeypatch.setenv("VIDDET_PAIR_TOPK", "det")
    jax.clear_caches()
    for main, side in ((jax_detect.main, "jax"), (torch_detect.main, "port")):
        main(["--network", "yolo3_tiny_darknet", "--dataset", "voc", "--input", inputs,
              "--output", str(out / side), "--data-shape", "64", "--batch-size", "2",
              "--thresh", "0.0", "--weights", weights, "--save-detections", "--no-draw",
              "--platform", "cpu"])
    files = sorted(os.listdir(out / "jax"))
    assert sorted(os.listdir(out / "port")) == files
    for name in files:
        assert (out / "port" / name).read_text() == (out / "jax" / name).read_text(), name
    return files


def test_detect_reads_bmp_directory_and_a_single_webp_as_jax(detect_weights, tmp_path,
                                                              monkeypatch):
    """A directory of cv2's 8-bit and RLE8 BMPs beside a .webp and a .gif
    (skipped on both sides: JAX's extension list has neither), then one
    WebP given alone as --input."""
    rng = np.random.default_rng(15)
    images = tmp_path / "images"
    images.mkdir()
    for i in range(2):
        cv2.imwrite(str(images / f"grey{i}.bmp"), photo(rng, 70 + i, 90)[..., 0])
    (images / "rle.bmp").write_bytes(_bmp_case("rle8_escapes", 48, 64, rng))
    (images / "skipped.webp").write_bytes(encode_webp(photo(rng, 40, 40), 80))
    (images / "skipped.gif").write_bytes(_gif_case("pil", rng))
    files = _detect_both(str(images), tmp_path / "dir", detect_weights, monkeypatch)
    assert files == ["grey0.txt", "grey1.txt", "rle.txt"]
    single = tmp_path / "photo.webp"
    single.write_bytes(encode_webp(photo(rng, 80, 120), 75))
    assert _detect_both(str(single), tmp_path / "one", detect_weights, monkeypatch) == [
        "photo.txt"]
