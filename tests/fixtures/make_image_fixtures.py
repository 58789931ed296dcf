"""Write the still-image fixtures of the card checks (run from the
repository root):

    python -m tests.fixtures.make_image_fixtures

Into ``tests/fixtures/stills/``, from seeded numpy content, by cv2 and PIL
and the writers of ``tests/test_torch_image_formats.py``:

* ``webp_lossy_640x480.webp``: cv2's lossy WebP at quality 75;
* ``webp_lossless_320x240.webp``: PIL's lossless WebP (method 4) of a
  texture on which libwebp uses every transform;
* ``webp_alpha_exif_160x120.webp``: an extended WebP, ``ALPH`` beside a
  lossy frame and an ``EXIF`` chunk of orientation 6 (it decodes to
  120x160);
* ``webp_animated_320x240.webp``: three lossless frames, the first at an
  offset on a larger canvas;
* ``gif_animated_interlaced_320x240.gif``: three interlaced frames, the
  first smaller than the screen, transparent, with a local colour table;
* ``bmp8_320x240.bmp`` and ``bmp_rle8_320x240.bmp``: cv2's 8-bit palette
  BMP of a grey image, and an RLE8 one with deltas and end-of-line codes;
* ``png_exif_320x240.png``: cv2's PNG with an ``eXIf`` chunk of
  orientation 8;
* ``ppm16_160x120.ppm``: a binary P6 of 16-bit samples;
* ``tiff_lzw_tiles_640x480.tif``: RGB in 64x64 tiles, planar 2, LZW with
  horizontal predictor 2 (the decode rate's file);
* ``tiff_jpeg_ycbcr_320x240.tif``: YCbCr JPEG strips of 16 rows, 4:2:0,
  abbreviated, with their ``JPEGTables``;
* ``tiff16_alpha_deflate_160x120.tif``: big-endian 16-bit RGBA, unassociated
  alpha, Deflate with predictor 2;
* ``tiff_palette_orientation6_160x120.tif``: an 8-bit palette in PackBits
  strips, orientation 6 (it decodes to 120x160);
* ``sun_raster_palette_320x240.ras``: an 8-bit Sun raster with a colour map
  (OpenCV 5 reads no RLE Sun raster);
* ``pfm_160x120.pfm``: a little-endian colour PFM with values past 0 and
  255 and on rounding ties;
* ``hdr_rle_320x240.hdr``: a Radiance HDR of new-style RLE scanlines;
* ``tiff_ccitt_g4_640x480.tif``: a bilevel page (blocks of text-like
  strokes, rules and a halftone patch), CCITT Group 4, MinIsWhite (the
  decode rate's file);
* ``tiff_ccitt_g3_2d_fill_320x240.tif``: Group 3 with 2-D rows and fill
  bits (T4Options 5) in strips of 64 rows, FillOrder 2;
* ``tiff_cielab_160x120.tif``: 8-bit CIELab with a D65 WhitePoint;
* ``jp2_reversible_tiles_640x480.jp2``: the 5/3 in 256x256 tiles, 64x64
  precincts, 3 layers, RPCL (a decode rate's file);
* ``jp2_irreversible_640x480.jp2``: the 9/7 at a compression rate of 16 in
  one tile, 6 resolutions (a decode rate's file);
* ``j2k_rgb16_320x240.j2k``: a raw codestream of three 16-bit components
  (cv2's lossless writer; OpenCV refuses a raw codestream of one).

And ``stills.json``: each file's shape and the SHA-256 of its RGB as
``cv2.imdecode(IMREAD_COLOR)`` and a BGR-to-RGB swap give it.  The card
machine has no OpenCV the port may use: ``chip_smoke.py``'s ``codec``
phase holds the port's decoders to these digests there, and its ``http``
and ``detect`` phases upload and read the files.
"""

import hashlib
import json
import os

import cv2
import numpy as np

from tests import torch_tiff_writer as T
from tests.test_torch_image_formats import (
    bmp,
    bmp_rle,
    encode_webp,
    gif,
    photo,
    pil_webp,
    png_with_exif,
    texture,
    tiff_exif,
    vp8x,
    webp,
    webp_animation,
    webp_chunks,
)
from tests.test_torch_jpeg2000 import cv2_jp2, pil_jp2, split_jp2
from tests.test_torch_tiff import hdr, pfm, rgbe, sun_raster

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "stills")
SEED = 24


def fixtures() -> dict:
    rng = np.random.default_rng(SEED)
    files = {}
    files["webp_lossy_640x480.webp"] = encode_webp(texture(rng, 480, 640)[..., ::-1], 75)
    files["webp_lossless_320x240.webp"] = pil_webp(texture(rng, 240, 320), lossless=True,
                                                   method=4)
    rgba = photo(rng, 120, 160, 4)
    rgba[..., 3] = np.linspace(0, 255, 160, dtype=np.uint8)[None, :]
    chunks = webp_chunks(encode_webp(rgba, 80))[1:]  # ALPH and VP8 after the VP8X
    files["webp_alpha_exif_160x120.webp"] = webp([vp8x(160, 120, 0x18), *chunks,
                                                  (b"EXIF", tiff_exif(6))])
    frames = [encode_webp(texture(rng, 180, 240), 101) for _ in range(3)]
    files["webp_animated_320x240.webp"] = webp_animation(
        [(frames[0], 40, 30, True, False), (frames[1], 0, 0, True, False),
         (frames[2], 80, 60, False, True)], 320, 240)
    table = (texture(rng, 16, 16).reshape(-1, 3)[:256]).astype(np.uint8)
    local = rng.integers(0, 256, (64, 3), np.uint8)
    first = {"indices": rng.integers(0, 64, (200, 280)), "x": 20, "y": 16, "local": local,
             "interlace": True, "transparent": 7}
    later = [{"indices": (texture(rng, 240, 320)[..., 0] // 2), "interlace": True}
             for _ in range(2)]
    files["gif_animated_interlaced_320x240.gif"] = gif(320, 240, [first, *later], table,
                                                       background=5)
    grey = texture(rng, 240, 320)[..., 1]
    files["bmp8_320x240.bmp"] = cv2.imencode(".bmp", grey)[1].tobytes()
    palette = rng.integers(0, 256, (256, 4), np.uint8).tobytes()
    values = (grey[::-1] // 16 * 16).astype(np.int64)  # long runs
    files["bmp_rle8_320x240.bmp"] = bmp(320, 240, 8, 1, bmp_rle(values, False, rng, True),
                                        palette)
    png = cv2.imencode(".png", texture(rng, 240, 320))[1].tobytes()
    files["png_exif_320x240.png"] = png_with_exif(png, tiff_exif(8, "MM"))
    samples = np.minimum(texture(rng, 120, 160).astype(np.int64) * 257
                         + rng.integers(0, 257, (120, 160, 3)), 65535)
    files["ppm16_160x120.ppm"] = b"P6\n160 120\n65535\n" + samples.astype(">u2").tobytes()
    files["tiff_lzw_tiles_640x480.tif"] = T.tiff(texture(rng, 480, 640), compression=5,
                                                 predictor=2, planar=2, tile=(64, 64))
    files["tiff_jpeg_ycbcr_320x240.tif"] = T.tiff(texture(rng, 240, 320), compression=7,
                                                  photometric=6, subsampling=(2, 2),
                                                  rows_per_strip=16, quality=80)
    rgba = photo(rng, 120, 160, 4).astype(np.int64) * 257 + rng.integers(0, 257, (120, 160, 4))
    rgba[..., 3] = np.linspace(0, 65535, 160, dtype=np.int64)[None, :]
    files["tiff16_alpha_deflate_160x120.tif"] = T.tiff(np.minimum(rgba, 65535), bps=16,
                                                       order=">", compression=8, predictor=2,
                                                       extra_samples=(2,), rows_per_strip=24)
    files["tiff_palette_orientation6_160x120.tif"] = T.tiff(
        texture(rng, 120, 160)[..., :1] // 8 * 8, bps=8, photometric=3,
        colormap=rng.integers(0, 65536, (256, 3)), compression=32773, orientation=6,
        rows_per_strip=32)
    files["sun_raster_palette_320x240.ras"] = sun_raster(
        texture(rng, 240, 320)[..., 2], 8, colour_map=rng.integers(0, 256, (256, 3)))
    values = texture(rng, 120, 160).astype(np.float32) * np.float32(1.25) - 20
    values[:8, :8] = np.float32(127.5)
    files["pfm_160x120.pfm"] = pfm(values)
    files["hdr_rle_320x240.hdr"] = hdr(rgbe(texture(rng, 240, 320).astype(np.float32) / 200))
    files["tiff_ccitt_g4_640x480.tif"] = T.tiff(page(rng, 480, 640), bps=1, photometric=0,
                                                compression=4)
    files["tiff_ccitt_g3_2d_fill_320x240.tif"] = T.tiff(
        page(rng, 240, 320), bps=1, photometric=0, compression=3, ccitt_options=5, rng=rng,
        rows_per_strip=64, fill_order=2)
    files["tiff_cielab_160x120.tif"] = T.tiff(
        texture(rng, 120, 160), photometric=8,
        tags={T.WHITE_POINT: (T.RATIONAL, [(3127, 10000), (3290, 10000)])})
    files["jp2_reversible_tiles_640x480.jp2"] = pil_jp2(
        texture(rng, 480, 640), tile_size=(256, 256), precinct_size=(64, 64),
        quality_mode="rates", quality_layers=[40, 10, 1], progression="RPCL")
    files["jp2_irreversible_640x480.jp2"] = pil_jp2(
        texture(rng, 480, 640), irreversible=True, quality_mode="rates", quality_layers=[16])
    deep = np.minimum(texture(rng, 240, 320).astype(np.int64) * 257
                      + rng.integers(0, 257, (240, 320, 3)), 65535).astype(np.uint16)
    files["j2k_rgb16_320x240.j2k"] = split_jp2(cv2_jp2(deep, 1000))[1]
    return files


def page(rng, h: int, w: int) -> np.ndarray:
    """(h, w, 1) bits of a scanned page: lines of short strokes, rules and a
    halftone patch (1 black)."""
    bits = np.zeros((h, w), np.uint8)
    for y in range(16, h - 24, 20):
        x = 24
        while x < w - 40:
            word = min(int(rng.integers(12, 60)), w - 24 - x)
            bits[y : y + 12, x : x + word] = rng.random((12, word)) < 0.35
            x += word + int(rng.integers(6, 14))
    bits[h // 2 : h // 2 + 3, 20 : w - 20] = 1
    patch = texture(rng, h // 4, w // 4)[..., 0]
    bits[h - h // 4 - 8 : h - 8, w - w // 4 - 8 : w - 8] = patch > rng.integers(0, 256, patch.shape)
    return bits[..., None]


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    digests = {}
    for name, data in fixtures().items():
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert bgr is not None, name
        rgb = np.ascontiguousarray(bgr[..., ::-1])
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        digests[name] = {"shape": list(rgb.shape), "bytes": len(data),
                         "rgb_sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "stills.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(d["bytes"] for d in digests.values())
    print(f"{len(digests)} files, {total} bytes")


if __name__ == "__main__":
    main()
