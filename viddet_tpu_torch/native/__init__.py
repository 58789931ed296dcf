"""The port's image codec: ``codec.cpp`` built with ``g++`` at first use and
called through ``ctypes``, with PNG's chunks, inflate and deflate (the
standard library's ``zlib``) and BMP's headers read here.

Decoding gives what ``cv2.imdecode(buf, IMREAD_COLOR)`` followed by a
BGR-to-RGB swap gives, bit for bit: JPEG (baseline and progressive
Huffman, any integral sampling, greyscale, CMYK and YCCK), PNG (every
colour type and bit depth, Adam7, the ``eXIf`` orientation, an APNG's
first frame) and every BMP form OpenCV reads (palettes, RLE8 and RLE4,
16-, 24- and 32-bit, the OS/2 header); WebP (``native.webp`` with
``webp.cpp``), GIF (``native.gif`` with ``gif.cpp``), PNM / PAM
(``native.pnm``), TIFF (``native.tiff`` with ``tiff.cpp``, its JPEG strips
through ``vd_jpeg_decode_as``) and Sun raster, PFM and Radiance HDR
(``native.stills``) likewise.  A JPEG's EXIF orientation is applied by the
caller (``data.base.decode_rgb``).
``encode_jpeg`` writes the bytes ``cv2.imencode(".jpg", bgr,
[IMWRITE_JPEG_QUALITY, q])`` writes; ``encode_png`` writes filter-0 PNGs
whose pixels round-trip.  The JAX package's ``viddet_tpu/native/decode.cpp``
prescales JPEGs in the DCT domain and so does not equal OpenCV; this codec
leaves the scale alone.

For video, ``frame_transform`` is ``data.transforms.ValTransform`` in C++,
bit for bit, ``Mpeg4Decoder`` decodes MPEG-4 Part 2 video and
``Mpeg4Encoder`` encodes it (``mpeg4enc.cpp``), ``Vp8Decoder`` decodes
VP8 (``vp8.cpp``), ``Vp9Decoder`` decodes VP9 profile 0 (``vp9.cpp``),
``H264Decoder`` decodes I, P and B H.264, CAVLC or CABAC (``h264.cpp``), and
``VideoStream`` reads, decodes and transforms the frames of a Motion-JPEG,
MPEG-4, VP8, VP9 or H.264 stream (indexed by ``native.avi``, ``native.mp4`` or
``native.mkv``) on a C++ thread into a ring of frames.

The library (``codec.cpp``, ``vp8.cpp``, ``vp9.cpp``, ``h264.cpp``, ``mpeg4enc.cpp``, ``webp.cpp``,
``gif.cpp`` and ``tiff.cpp``) links nothing beyond the C++ standard library.  Each source is compiled to an object on its own,
all at once, and the objects are linked; the library is built into
``build/viddet_tpu_torch/native/<hash>/``
at the repository root (``build/`` is git-ignored), keyed by a hash of the
sources and the flags, the way ``kernels/build.py`` keys the CUDA kernels.
Nothing is built at import time.  A failed build raises with the compiler's output; there is
no other codec to fall back to.  ``ctypes`` releases the GIL for each
call, so the loader's threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "codec.cpp"  # JPEG, PNG, MPEG-4 Part 2, the video stream
VP8_SOURCE = HERE / "vp8.cpp"  # the VP8 decoder, with its header
VP8_HEADER = HERE / "vp8.h"
VP9_SOURCE = HERE / "vp9.cpp"  # the VP9 decoder, with its header
VP9_HEADER = HERE / "vp9.h"
H264_SOURCE = HERE / "h264.cpp"  # the H.264 decoder, with its header
H264_HEADER = HERE / "h264.h"
MPEG4ENC_SOURCE = HERE / "mpeg4enc.cpp"  # the MPEG-4 Part 2 encoder
MPEG4_HEADER = HERE / "mpeg4.h"  # what the MPEG-4 decoder and encoder share
WEBP_SOURCE = HERE / "webp.cpp"  # WebP's lossless bitstream and lossy RGB step
GIF_SOURCE = HERE / "gif.cpp"  # GIF's LZW
TIFF_SOURCE = HERE / "tiff.cpp"  # TIFF's LZW, PackBits, predictor and samples to RGB
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "viddet_tpu_torch" / "native"
LIB_NAME = "libviddet_codec.so"
# no fused multiply-add: the video transform's float steps round as numpy's do
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off"]
LIBS = ["-pthread"]
_ERR_LEN = 512

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8\xff"
# OpenCV's default limit on a decoded image (CV_IO_MAX_IMAGE_PIXELS), so a
# forged header cannot make a decode allocate without bound.
MAX_PIXELS = 1 << 30
MAX_SIDE = 1 << 20  # CV_IO_MAX_IMAGE_WIDTH and _HEIGHT

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list:
    """The library's C++ sources, each compiled to an object of its own."""
    return [SOURCE, VP8_SOURCE, VP9_SOURCE, H264_SOURCE, MPEG4ENC_SOURCE, WEBP_SOURCE,
            GIF_SOURCE, TIFF_SOURCE]


def _digest() -> str:
    h = hashlib.sha256()
    for path in sources() + [VP8_HEADER, VP9_HEADER, H264_HEADER, MPEG4_HEADER]:
        h.update(path.read_bytes())
    h.update(repr((FLAGS, LIBS)).encode())
    return h.hexdigest()[:16]


def compile_commands(objects: Path) -> list:
    """One compiler call per source, each writing its object into ``objects``."""
    return [["g++", *FLAGS, "-c", str(src), "-o", str(objects / (src.stem + ".o"))]
            for src in sources()]


def build_command(output: Path, objects: Path = Path(".")) -> list:
    """The call that links the objects of ``compile_commands`` into the library."""
    return ["g++", "-shared", *(str(objects / (src.stem + ".o")) for src in sources()), "-o",
            str(output), *LIBS]


def build() -> Path:
    """Compile the library if this source hash has none yet: every source at
    once, then one link."""
    lib_path = BUILD_ROOT / _digest() / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        staged = Path(tmp) / LIB_NAME
        cmds = compile_commands(Path(tmp))
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                raise RuntimeError(f"image codec build failed:\n$ {' '.join(cmd)}\n{err}")
        cmd = build_command(staged, Path(tmp))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"image codec build failed:\n$ {' '.join(cmd)}\n{proc.stderr}")
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        os.replace(staged, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded codec (built on first call), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulong
            lib.vd_jpeg_header.argtypes = [p, size, ctypes.POINTER(i), ctypes.POINTER(i), p, i]
            lib.vd_jpeg_decode.argtypes = [p, size, p, i, i, p, i]
            lib.vd_jpeg_decode_as.argtypes = [p, size, p, i, i, i, i, p, i]
            lib.vd_jpeg_encode.argtypes = [p, i, i, i, p, size, ctypes.POINTER(size), p, i]
            lib.vd_png_unfilter.argtypes = [p, size, i, i, i, i, i, p, i, p, p, i]
            lib.vd_png_raw_size.argtypes = [i, i, i, i, i]
            lib.vd_png_raw_size.restype = size
            lib.vd_frame_transform.argtypes = [p, i, i, p, i, i, i, i, p]
            lib.vd_mpeg4_open.argtypes = [p, size, ctypes.c_char_p, ctypes.POINTER(i),
                                          ctypes.POINTER(i), p, i]
            lib.vd_mpeg4_open.restype = p
            lib.vd_mpeg4_decode.argtypes = [p, p, size, p, p, i]
            lib.vd_mpeg4_flush.argtypes = [p, p]
            lib.vd_mpeg4_planes.argtypes = [p, p, p, p]
            lib.vd_mpeg4_info.argtypes = [p, p]
            lib.vd_mpeg4_free.argtypes = [p]
            lib.vd_mpeg4enc_open.argtypes = [i, i, i, i, p, i]
            lib.vd_mpeg4enc_open.restype = p
            lib.vd_mpeg4enc_config.argtypes = [p, p, size]
            lib.vd_mpeg4enc_config.restype = size
            lib.vd_mpeg4enc_encode.argtypes = [p, p, p, size, ctypes.POINTER(size),
                                               ctypes.POINTER(i), p, i]
            lib.vd_mpeg4enc_planes.argtypes = [p, p, p, p]
            lib.vd_mpeg4enc_free.argtypes = [p]
            lib.vd_vp8_open.restype = p
            lib.vd_vp8_decode.argtypes = [p, p, size, p, i]
            lib.vd_vp8_size.argtypes = [p, ctypes.POINTER(i), ctypes.POINTER(i)]
            lib.vd_vp8_features.argtypes = [p]
            lib.vd_vp8_features.restype = ctypes.c_uint
            lib.vd_vp8_rgb.argtypes = [p, p]
            lib.vd_vp8_planes.argtypes = [p, p, p, p]
            lib.vd_vp9_open.restype = p
            lib.vd_vp9_decode.argtypes = [p, p, size, p, i]
            lib.vd_vp9_size.argtypes = [p, ctypes.POINTER(i), ctypes.POINTER(i)]
            lib.vd_vp9_features.argtypes = [p]
            lib.vd_vp9_features.restype = ctypes.c_uint
            lib.vd_vp9_rgb.argtypes = [p, p]
            lib.vd_vp9_planes.argtypes = [p, p, p, p]
            lib.vd_vp9_free.argtypes = [p]
            lib.vd_h264_open.argtypes = [p, size, p, i]
            lib.vd_h264_open.restype = p
            lib.vd_h264_decode.argtypes = [p, p, size, p, i]
            lib.vd_h264_probe.argtypes = [p, p, size, p, i]
            lib.vd_h264_size.argtypes = [p, ctypes.POINTER(i), ctypes.POINTER(i)]
            lib.vd_h264_features.argtypes = [p, p]
            lib.vd_h264_flush.argtypes = [p]
            lib.vd_h264_set_reorder.argtypes = [p, i]
            lib.vd_h264_reorder.argtypes = [p]
            lib.vd_h264_info.argtypes = [p, p]
            lib.vd_h264_contexts.argtypes = [p, p]
            lib.vd_h264_rgb.argtypes = [p, p]
            lib.vd_h264_planes.argtypes = [p, p, p, p]
            lib.vd_h264_free.argtypes = [p]
            lib.vd_vp8_free.argtypes = [p]
            lib.vd_vp8l_decode.argtypes = [p, size, i, i, p, ctypes.POINTER(ctypes.c_uint),
                                           ctypes.POINTER(ctypes.c_uint), p, i]
            lib.vd_webp_lossy.argtypes = [p, size, i, i, p, p, i]
            lib.vd_gif_lzw.argtypes = [p, size, i, p, size, ctypes.POINTER(size), p, i]
            lib.vd_tiff_decode.argtypes = [p, size, p, p, p, p, p, p, p, p, i]
            lib.vd_video_open.argtypes = [ctypes.c_char_p, i, p, size, ctypes.c_char_p, i, p, p,
                                          i, p, i, i, i, i, i, i, p, i]
            lib.vd_video_open.restype = p
            lib.vd_video_next.argtypes = [p, p, p, ctypes.POINTER(i), p, i]
            lib.vd_video_stop.argtypes = [p]
            lib.vd_video_free.argtypes = [p]
            for fn in (lib.vd_jpeg_header, lib.vd_jpeg_decode, lib.vd_jpeg_encode,
                       lib.vd_png_unfilter, lib.vd_frame_transform, lib.vd_video_next,
                       lib.vd_mpeg4_decode, lib.vd_mpeg4_flush, lib.vd_mpeg4enc_encode,
                       lib.vd_vp8_decode, lib.vd_vp8_rgb, lib.vd_vp8_planes,
                       lib.vd_vp8l_decode, lib.vd_webp_lossy, lib.vd_gif_lzw,
                       lib.vd_jpeg_decode_as, lib.vd_tiff_decode,
                       lib.vd_h264_decode, lib.vd_h264_probe, lib.vd_h264_rgb,
                       lib.vd_h264_planes, lib.vd_h264_flush, lib.vd_h264_reorder):
                fn.restype = i
            _lib = lib
        return _lib


def _message(err) -> str:
    return err.value.decode(errors="replace")


def _check_size(name: str, width: int, height: int) -> None:
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: {width}x{height} exceeds the decoder's {MAX_PIXELS} pixels")
    if max(width, height) > MAX_SIDE:
        raise ValueError(f"{name}: {width}x{height} exceeds the decoder's {MAX_SIDE} pixels a side")


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB at full scale, the raster as stored
    (no EXIF orientation).  ``name`` (a path, a record) goes into the
    messages.  Raises ValueError for bytes that are not a JPEG (a PNG, say),
    for a kind the codec does not read (arithmetic coding, 12-bit,
    lossless) and for a JPEG that is truncated or corrupt."""
    if data[:3] != JPEG_SOI:  # SOI, then a marker
        raise ValueError(f"{name}: not a JPEG")
    lib = library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vd_jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), err, _ERR_LEN):
        raise ValueError(f"{name}: JPEG header: {_message(err)}")
    _check_size(name, w.value, h.value)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.vd_jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value, err, _ERR_LEN):
        raise ValueError(f"{name}: JPEG decode: {_message(err)}")
    return out


def _png_chunks(data: bytes, name: str):
    """(type, payload) of each chunk up to IEND, CRCs checked: a critical
    chunk with a bad one raises, an ancillary one is dropped."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: PNG is truncated (no IEND chunk)")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 8 + length
        if length > 0x7FFFFFFF or end + 4 > len(data):
            raise ValueError(f"{name}: PNG chunk {kind!r} is truncated")
        payload = data[pos + 8 : end]
        (crc,) = struct.unpack_from(">I", data, end)
        if zlib.crc32(kind + payload) == crc:
            yield kind, payload
        elif not kind[0] & 0x20:  # critical: uppercase first letter
            raise ValueError(f"{name}: PNG chunk {kind!r} has a bad CRC")
        # libpng warns of an ancillary chunk with a bad CRC and drops it
        if kind == b"IEND":
            return
        pos = end + 4


def _png_raster(lib, stream: bytes, width: int, height: int, depth: int, color: int,
                interlace: int, palette: bytes, name: str) -> np.ndarray:
    """Inflate and unfilter one image's zlib stream into (height, width, 3) RGB."""
    expected = lib.vd_png_raw_size(width, height, depth, color, interlace)
    try:
        raw = bytearray(zlib.decompressobj().decompress(stream, expected))
    except zlib.error as exc:
        raise ValueError(f"{name}: PNG image data is corrupt ({exc})") from None
    if len(raw) < expected:
        raise ValueError(f"{name}: PNG image data stream is short "
                         f"({len(raw)} of {expected} bytes)")
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    raw_buf = (ctypes.c_char * max(len(raw), 1)).from_buffer(raw) if raw else None
    if lib.vd_png_unfilter(raw_buf, len(raw), width, height, depth, color, interlace,
                           palette or None, len(palette) // 3, out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: PNG decode: {_message(err)}")
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as ``cv2.imdecode(IMREAD_COLOR)``
    gives it: 16-bit samples keep their high byte, grey of 1, 2 or 4 bits
    scales to 8, palettes expand, alpha and tRNS are dropped, gAMA is
    ignored, and the EXIF orientation of the first ``eXIf`` chunk that
    starts with a TIFF header (before or after the image data) is applied.
    An APNG whose default image is not its first frame (its first ``fcTL``
    follows the ``IDAT`` chunks) gives that first frame, on a black canvas
    at its offset.  Raises ValueError for a bad CRC, a short or corrupt
    stream, a missing palette or an unknown critical chunk."""
    from viddet_tpu_torch.utils.image import apply_orientation, tiff_orientation

    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    header, palette, idat, exif = None, b"", [], None
    animated, controls, frame, frame_data = False, 0, None, []
    for kind, payload in _png_chunks(data, name):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError(f"{name}: bad PNG IHDR")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = payload
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"acTL":
            animated = True
        elif kind == b"fcTL":
            controls += 1
            if controls == 1 and idat and animated:  # the first frame is not the default image
                if len(payload) != 26:
                    raise ValueError(f"{name}: bad APNG fcTL chunk")
                frame = struct.unpack_from(">IIII", payload, 4)  # width, height, x, y
        elif kind == b"fdAT":
            if frame is not None and controls == 1:
                frame_data.append(payload[4:])  # after the sequence number
        elif kind == b"eXIf" and exif is None and payload[:4] in (b"II*\0", b"MM\0*"):
            exif = payload  # libpng keeps the first with a TIFF header, as cv2 sees it
        elif kind != b"IEND" and not kind[0] & 0x20:  # critical: uppercase first letter
            raise ValueError(f"{name}: PNG has an unknown critical chunk {kind!r}")
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR")
    width, height, depth, color, compression, filtering, interlace = header
    allowed = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
    if (color not in allowed or depth not in allowed[color] or compression or filtering
            or interlace > 1 or not 0 < width < 2**31 or not 0 < height < 2**31):
        raise ValueError(f"{name}: unsupported PNG header {header}")
    if color == 3 and (not palette or len(palette) % 3):
        raise ValueError(f"{name}: palette PNG without a valid PLTE chunk")
    _check_size(name, width, height)
    lib = library()
    if frame is None:
        out = _png_raster(lib, b"".join(idat), width, height, depth, color, interlace, palette,
                          name)
    else:
        fw, fh, x, y = frame
        if not fw or not fh or x + fw > width or y + fh > height:
            raise ValueError(f"{name}: APNG frame {fw}x{fh}+{x}+{y} leaves the "
                             f"{width}x{height} image")
        out = np.zeros((height, width, 3), np.uint8)
        out[y : y + fh, x : x + fw] = _png_raster(lib, b"".join(frame_data), fw, fh, depth, color,
                                                  interlace, palette, name)
    return out if exif is None else apply_orientation(out, tiff_orientation(exif))


BMP_RGB, BMP_RLE8, BMP_RLE4, BMP_BITFIELDS = range(4)


def _bmp_header(data: bytes, name: str):
    """(width, height, bpp, compression, palette) as OpenCV's ``BmpDecoder``
    reads them: a 12-byte OS/2 core header (3-byte palette entries, always
    bottom-up) or a header of 36 bytes or more, whose planes field is not
    read and whose palette (or 16-bit masks) comes right after it.  bpp 15
    stands for 16-bit 5-5-5.  Raises ValueError for what OpenCV refuses."""
    if len(data) < 18:
        raise ValueError(f"{name}: BMP header is truncated")
    size = struct.unpack_from("<i", data, 14)[0]
    pos = 14 + size
    if size >= 36:
        if len(data) < 50:
            raise ValueError(f"{name}: BMP header is truncated")
        width, height, bpp, compression = struct.unpack_from("<iiIi", data, 18)
        bpp >>= 16
        colours = struct.unpack_from("<i", data, 46)[0]
        if not 0 <= compression <= BMP_BITFIELDS:
            raise ValueError(f"{name}: unsupported BMP compression method {compression}")
        allowed = ((bpp in (1, 4, 8, 16, 24, 32) and compression == BMP_RGB)
                   or (bpp in (16, 32) and compression == BMP_BITFIELDS)
                   or (bpp == 4 and compression == BMP_RLE4)
                   or (bpp == 8 and compression == BMP_RLE8))
        if width <= 0 or height == 0 or not allowed:
            raise ValueError(f"{name}: unsupported BMP (header {size}, {width}x{height}, "
                             f"{bpp} bits, compression {compression})")
        palette = b""
        if bpp <= 8:
            if not 0 <= colours <= 256:
                raise ValueError(f"{name}: bad BMP colour count {colours}")
            count = colours or 1 << bpp
            palette = data[pos : pos + 4 * count]
            if len(palette) < 4 * count:
                raise ValueError(f"{name}: BMP palette is truncated")
        elif bpp == 16 and compression == BMP_BITFIELDS:
            if pos + 12 > len(data):
                raise ValueError(f"{name}: BMP bit fields are truncated")
            red, green, blue = struct.unpack_from("<III", data, pos)
            if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                raise ValueError(f"{name}: unsupported 16-bit BMP bit fields "
                                 f"{(red, green, blue)}")
        elif bpp == 16:
            bpp = 15
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8).reshape(-1, 4)
        pal[: len(entries)] = entries[:, 2::-1]
        return width, height, bpp, compression, pal
    if size == 12:
        if len(data) < 26:
            raise ValueError(f"{name}: BMP header is truncated")
        width, height, _, bpp = struct.unpack_from("<HHHH", data, 18)
        if width <= 0 or height == 0 or bpp not in (1, 4, 8, 24, 32):
            raise ValueError(f"{name}: unsupported OS/2 BMP ({width}x{height}, {bpp} bits)")
        pal = np.zeros((256, 3), np.uint8)
        if bpp <= 8:
            palette = data[pos : pos + 3 * (1 << bpp)]
            if len(palette) < 3 << bpp:
                raise ValueError(f"{name}: BMP palette is truncated")
            pal[: 1 << bpp] = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:, ::-1]
        return width, height, bpp, BMP_RGB, pal
    raise ValueError(f"{name}: unsupported BMP header size {size}")


def _bmp_rle(data: bytes, pos: int, width: int, height: int, four: bool, name: str):
    """The palette indices of a BI_RLE8 or BI_RLE4 bitmap, rows in file
    order, as OpenCV's ``BmpDecoder`` fills them: an end of line, a delta
    and an end of bitmap fill the pixels they pass over with palette entry
    0.  In RLE8 a delta counts dx + dy * width pixels in raster order, an
    end of bitmap fills the rest, a run that ends a row moves to the next
    one and an end of line right after it is skipped; in RLE4 a delta moves
    dx pixels (dy is read and dropped), an end of bitmap ends only the row
    and a run never leaves its row."""
    out = np.zeros(width * height, np.uint8)
    x = y = 0
    after_wrap = False
    n = len(data)

    def fill(count: int) -> None:  # OpenCV's FillUniColor with entry 0
        nonlocal x, y
        while True:
            end = min(x + count, width)
            count -= end - x
            out[y * width + x : y * width + end] = 0
            x = end
            if x >= width:
                x, y = 0, y + 1
                if y >= height:
                    return
            if count <= 0:
                return

    while True:
        if pos + 2 > n:
            raise ValueError(f"{name}: BMP RLE data is truncated")
        run, code = data[pos], data[pos + 1]
        pos += 2
        if run:
            if x + run > width:
                raise ValueError(f"{name}: BMP RLE run passes the end of a row")
            base = y * width + x
            if four:
                out[base : base + run : 2] = code >> 4
                out[base + 1 : base + run : 2] = code & 15
                x += run
            else:
                out[base : base + run] = code
                x += run
                after_wrap = x >= width
                if after_wrap:
                    x, y = 0, y + 1
                    if y >= height:
                        break
        elif code > 2:
            if x + code > width:
                raise ValueError(f"{name}: BMP RLE run passes the end of a row")
            size = ((code + 1) // 2 + 1) & ~1 if four else (code + 1) & ~1
            if pos + size > n:
                raise ValueError(f"{name}: BMP RLE data is truncated")
            raw = np.frombuffer(data, np.uint8, size, pos)
            pos += size
            if four:
                raw = np.stack([raw >> 4, raw & 15], 1).reshape(-1)
            base = y * width + x
            out[base : base + code] = raw[:code]
            x += code
            after_wrap = False
        else:
            if four or code or not after_wrap or x > 0:
                dx, dy = width - x, height - y
                if code == 2:
                    if pos + 2 > n:
                        raise ValueError(f"{name}: BMP RLE data is truncated")
                    dx, dy = data[pos], data[pos + 1]
                    pos += 2
                if not four and y >= height:
                    break
                fill(dx + (dy * width if code and not four else 0))
            after_wrap = False
            if y >= height:
                break
    return out.reshape(height, width)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB, the forms and the results of
    ``cv2.imdecode(IMREAD_COLOR)``: 1-, 4- and 8-bit palettes (a colour
    count of 0 meaning 2^bpp, entries past a short palette black), BI_RLE8
    and BI_RLE4, 16-bit 5-5-5 and (under BI_BITFIELDS) 5-6-5 with each
    channel shifted up and not replicated, 24-bit, 32-bit (the fourth byte
    dropped, bit fields not read), the 12-byte OS/2 core header, bottom-up
    or top-down.  What OpenCV refuses raises ValueError."""
    if data[:2] != b"BM":
        raise ValueError(f"{name}: not a BMP")
    width, height, bpp, compression, palette = _bmp_header(data, name)
    rows = abs(height)
    _check_size(name, width, rows)
    if width * rows * 3 >= 1 << 30:  # the BMP reader's own 1 GiB limit
        raise ValueError(f"{name}: {width}x{rows} BMP exceeds the reader's 1 GiB")
    offset = struct.unpack_from("<i", data, 10)[0]
    if not 0 <= offset <= len(data):
        raise ValueError(f"{name}: BMP pixel data offset {offset} is past the end")
    if compression in (BMP_RLE8, BMP_RLE4):
        rgb = palette[_bmp_rle(data, offset, width, rows, compression == BMP_RLE4, name)]
    else:
        stride = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        if offset + stride * rows > len(data):
            raise ValueError(f"{name}: BMP pixel data is truncated")
        pixels = np.frombuffer(data, np.uint8, stride * rows, offset).reshape(rows, stride)
        if bpp <= 8:
            bits = np.unpackbits(pixels, axis=1) if bpp < 8 else pixels
            if bpp == 4:
                bits = bits.reshape(rows, -1, 4)
                bits = (bits[..., 0] << 3 | bits[..., 1] << 2 | bits[..., 2] << 1
                        | bits[..., 3])
            rgb = palette[bits[:, :width]]
        elif bpp in (15, 16):
            t = pixels[:, : 2 * width].view("<u2").astype(np.uint16)
            if bpp == 15:
                b, g, r = t << 3, (t >> 2) & 0xF8, (t >> 7) & 0xF8
            else:
                b, g, r = t << 3, (t >> 3) & 0xFC, (t >> 8) & 0xF8
            rgb = np.stack([r, g, b], -1).astype(np.uint8)
        else:
            channels = bpp // 8
            rgb = pixels[:, : width * channels].reshape(rows, width, channels)[..., 2::-1]
    if height > 0:  # bottom-up
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> the JPEG bytes ``cv2.imencode(".jpg", bgr,
    [IMWRITE_JPEG_QUALITY, quality])`` writes: baseline, JFIF, 4:2:0, the
    standard tables scaled by ``quality``."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    # headers, plus the worst case of every coefficient at 16+16 bits,
    # doubled for byte stuffing
    capacity = 1024 + ((w + 15) // 16) * ((h + 15) // 16) * 6 * 64 * 8
    out = np.empty(capacity, np.uint8)
    size = ctypes.c_ulong()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().vd_jpeg_encode(rgb.ctypes.data, w, h, int(quality), out.ctypes.data, capacity,
                                ctypes.byref(size), err, _ERR_LEN):
        raise ValueError(f"JPEG encode: {_message(err)}")
    return out[: size.value].tobytes()


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> an 8-bit truecolour PNG, every row filter type
    0, deflated by ``zlib``; ``decode_png`` gives the pixels back exactly."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def frame_transform(rgb: np.ndarray, size, letterbox: bool = True,
                    normalize: bool = True):
    """``ValTransform(size, letterbox, normalize)(rgb)`` in C++: (x, affine),
    x uint8 or normalized float32 (h, w, 3), equal to the Python transform's
    bit for bit."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"frame_transform takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = size
    out = np.empty((h, w, 3), np.float32 if normalize else np.uint8)
    affine = np.empty(4, np.float32)
    if library().vd_frame_transform(rgb.ctypes.data, rgb.shape[0], rgb.shape[1], out.ctypes.data,
                                    h, w, int(letterbox), int(normalize), affine.ctypes.data):
        raise MemoryError("frame_transform: out of memory")
    return out, affine


# codec.cpp's kBug* bits: libavcodec's workaround_bugs flags the decoder follows
MPEG4_WORKAROUNDS = {"edge": 1, "dc_clip": 2, "qpel_chroma": 4, "qpel_chroma2": 8,
                     "std_qpel": 16}


class Mpeg4Decoder:
    """An MPEG-4 Part 2 decoder (Simple and Advanced Simple Profile: B-VOPs,
    MPEG quantisation and quarter-sample vectors; not interlace or global
    motion compensation): ``config`` is the decoder configuration (the VOS
    / VO / VOL headers of an MP4's ``esds`` or at the head of an AVI's first
    frame), ``fourcc`` the container's tag of the stream (an AVI's or a VfW
    Matroska track's, ``mp4v`` in MP4), and ``decode(sample)`` decodes one
    sample's VOP.  As libavcodec does, the decoder reads who wrote the
    stream from its user data (``XviD####``, ``DivX###b####``, ``Lavc``)
    and the fourcc (``XVID`` alone means an early XviD, ``DIVX`` with a bare
    VOL DivX 4), and decodes such a stream with that encoder's IDCT and
    workarounds.  Pictures come out in display order, each the (H, W, 3)
    uint8 RGB frame that ``cv2.VideoCapture``'s FFmpeg backend returns:
    unless the VOL says low_delay, a reference (I or P) picture is held
    until the next one arrives and shown then, a B-VOP's picture is shown
    at once, and ``flush()`` gives the one still held at the end.  A
    feature the decoder does not have raises ValueError naming it, at
    ``__init__`` for one the VOL announces and at ``decode`` for an
    S-VOP."""

    def __init__(self, config: bytes, name: str = "<stream>", fourcc: str = ""):
        self._lib = library()
        self.name = name
        err = ctypes.create_string_buffer(_ERR_LEN)
        w, h = ctypes.c_int(), ctypes.c_int()
        self._handle = self._lib.vd_mpeg4_open(config, len(config),
                                               fourcc.encode("latin-1")[:4],
                                               ctypes.byref(w), ctypes.byref(h), err, _ERR_LEN)
        if not self._handle:
            raise ValueError(f"{name}: MPEG-4 decoder configuration: {_message(err)}")
        self.width, self.height = w.value, h.value  # the VOL's

    def decode(self, sample: bytes, name: str = "", rgb: bool = True):
        """Decode one sample.  Returns the picture that is now ready to show
        as an RGB frame (True when ``rgb`` is False: a frame skipped, still
        decoded for the ones after it), or None when none is: a reference
        picture held for display order, or a B-VOP libavcodec drops (one
        before two references)."""
        err = ctypes.create_string_buffer(_ERR_LEN)
        out = np.empty((self.height, self.width, 3), np.uint8) if rgb else None
        rc = self._lib.vd_mpeg4_decode(self._handle, sample, len(sample),
                                       out.ctypes.data if rgb else None, err, _ERR_LEN)
        if rc < 0:
            raise ValueError(f"{name or self.name}: MPEG-4 decode: {_message(err)}")
        return None if not rc else out if rgb else True

    def flush(self, rgb: bool = True):
        """At the end of the stream: the picture still held, as ``decode``
        returns it, or None."""
        out = np.empty((self.height, self.width, 3), np.uint8) if rgb else None
        if not self._lib.vd_mpeg4_flush(self._handle, out.ctypes.data if rgb else None):
            return None
        return out if rgb else True

    def planes(self):
        """The (Y, U, V) planes of the picture shown last, H x W and two of
        H/2 x W/2."""
        y = np.empty((self.height, self.width), np.uint8)
        u = np.empty((self.height // 2, self.width // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.vd_mpeg4_planes(self._handle, y.ctypes.data, u.ctypes.data, v.ctypes.data)
        return y, u, v

    @property
    def stream_info(self) -> dict:
        """What the decoder has read so far of the stream and its encoder:
        ``quarter_sample``, ``xvid_build``, ``divx_version``, ``divx_build``
        and ``lavc_build`` (None where unknown), the libavcodec
        ``workarounds`` in force (``MPEG4_WORKAROUNDS``' names) and the
        ``idct`` ("simple" or "xvid")."""
        info = np.empty(7, np.int32)
        self._lib.vd_mpeg4_info(self._handle, info.ctypes.data)
        q, xvid, divx, divx_build, lavc, bugs, xvid_idct = info.tolist()
        known = lambda v: None if v == -1 else v  # noqa: E731
        return {"quarter_sample": bool(q), "xvid_build": known(xvid),
                "divx_version": known(divx), "divx_build": known(divx_build),
                "lavc_build": known(lavc),
                "workarounds": [n for n, bit in MPEG4_WORKAROUNDS.items() if bugs & bit],
                "idct": "xvid" if xvid_idct else "simple"}

    def close(self) -> None:
        if self._handle:
            self._lib.vd_mpeg4_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


class Mpeg4Encoder:
    """An MPEG-4 Part 2 Simple Profile encoder (``mpeg4enc.cpp``) of
    ``width`` x ``height`` RGB frames (both even) at ``fps_num / fps_den``
    frames a second: ``config`` is the decoder configuration (VOS, VO and
    VOL headers: an MP4's ``esds``, or the head of an AVI's key frames),
    ``encode(rgb)`` gives one VOP's bytes and whether it is an I-VOP, and
    ``planes()`` the reconstruction of the frame encoded last, which a
    decoder (``Mpeg4Decoder``, FFmpeg) shows bit for bit.  A failure raises
    ValueError naming ``name`` and the frame."""

    def __init__(self, width: int, height: int, fps_num: int, fps_den: int,
                 name: str = "<stream>"):
        self._lib = library()
        self.name, self.width, self.height = name, int(width), int(height)
        self.frames = 0
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._handle = self._lib.vd_mpeg4enc_open(self.width, self.height, int(fps_num),
                                                  int(fps_den), err, _ERR_LEN)
        if not self._handle:
            raise ValueError(f"{name}: MPEG-4 encoder: {_message(err)}")
        n = self._lib.vd_mpeg4enc_config(self._handle, None, 0)
        out = np.empty(n, np.uint8)
        self._lib.vd_mpeg4enc_config(self._handle, out.ctypes.data, n)
        self.config = out.tobytes()
        mbs = ((self.width + 15) // 16) * ((self.height + 15) // 16)
        # every coefficient of every block as a third escape (30 bits), and the headers
        self._out = np.empty(64 + mbs * (8 + 6 * 64 * 4), np.uint8)

    def encode(self, rgb: np.ndarray):
        """One (height, width, 3) uint8 RGB frame -> (VOP bytes, key)."""
        rgb = np.ascontiguousarray(rgb)
        if rgb.dtype != np.uint8 or rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"{self.name} frame {self.frames}: the encoder takes "
                             f"({self.height}, {self.width}, 3) uint8, got {rgb.shape} "
                             f"{rgb.dtype}")
        err = ctypes.create_string_buffer(_ERR_LEN)
        size, key = ctypes.c_ulong(), ctypes.c_int()
        if self._lib.vd_mpeg4enc_encode(self._handle, rgb.ctypes.data, self._out.ctypes.data,
                                        len(self._out), ctypes.byref(size), ctypes.byref(key),
                                        err, _ERR_LEN):
            raise ValueError(f"{self.name} frame {self.frames}: MPEG-4 encode: {_message(err)}")
        self.frames += 1
        return self._out[: size.value].tobytes(), bool(key.value)

    def planes(self):
        """The (Y, U, V) planes the frame encoded last decodes to, H x W and
        two of H/2 x W/2."""
        y = np.empty((self.height, self.width), np.uint8)
        u = np.empty((self.height // 2, self.width // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.vd_mpeg4enc_planes(self._handle, y.ctypes.data, u.ctypes.data, v.ctypes.data)
        return y, u, v

    def close(self) -> None:
        if self._handle:
            self._lib.vd_mpeg4enc_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def mpeg4_frames(config: bytes, samples, name: str, every: int = 1, fourcc: str = ""):
    """(display index, RGB frame) of every ``every``-th picture of an
    MPEG-4 stream (tagged ``fourcc`` by its container) whose samples (in
    decode order) ``samples`` yields; every sample is decoded, only the
    kept pictures converted to RGB.  A sample that fails raises ValueError
    naming ``name`` and its number."""
    decoder = Mpeg4Decoder(config, name, fourcc)
    shown = 0
    try:
        for i, sample in enumerate(samples):
            frame = decoder.decode(sample, f"{name} frame {i}", rgb=shown % every == 0)
            if frame is not None:
                if shown % every == 0:
                    yield shown, frame
                shown += 1
        frame = decoder.flush(rgb=shown % every == 0)
        if frame is not None and shown % every == 0:
            yield shown, frame
    finally:
        decoder.close()


# vp8.h's Feature bits: what the frames a Vp8Decoder decoded used
VP8_FEATURES = {name: 1 << bit for bit, name in enumerate((
    "key frame", "inter frame", "hidden frame", "B_PRED", "split vectors", "segmentation",
    "segment map update", "token partitions", "golden reference", "alt-ref reference",
    "vectors off the frame", "bilinear filters", "full-pixel chroma", "simple loop filter",
    "sharpness", "loop filter deltas", "no entropy refresh", "intra in inter frames", "new vectors",
    "buffer copies", "sign bias"))}

# vp9.h's Feature bits: what the frames a Vp9Decoder decoded used
VP9_FEATURES = {name: 1 << bit for bit, name in enumerate((
    "key frame", "inter frame", "hidden frame", "superframe", "show existing frame",
    "intra-only frame", "compound prediction", "blocks below 8x8", "tile columns", "tile rows",
    "lossless", "segmentation", "segment map prediction", "segment quantiser",
    "segment loop filter level", "segment reference", "segment skip", "switchable filters",
    "smooth filter", "sharp filter", "bilinear filter", "probability adaptation",
    "error resilient", "frame parallel", "previous frame vectors", "high precision vectors",
    "32x32 transforms", "loop filter deltas", "sharpness", "vectors off the frame",
    "intra in inter frames", "colour information"))}


# h264.h's Feature bits: what the pictures an H264Decoder decoded used
H264_FEATURES = {name: 1 << bit for bit, name in enumerate((
    "IDR picture", "non-IDR I picture", "P slices", "intra 4x4", "intra 16x16", "I_PCM",
    "P 16x16", "P 16x8", "P 8x16", "P_8x8", "P_8x8ref0", "8x4 sub-partitions",
    "4x8 sub-partitions", "4x4 sub-partitions", "skipped macroblocks", "intra in P slices",
    "several references", "reference list modification", "long-term references", "MMCO 1",
    "MMCO 2", "MMCO 3", "MMCO 4", "MMCO 5", "MMCO 6", "non-reference pictures", "POC type 0",
    "POC type 1", "POC type 2", "frame_num wrap", "frame_num gap", "several slices",
    "deblocking off", "deblocking within slices", "deblocking offsets", "constrained intra",
    "cropping", "colour description", "full range", "High profile", "access unit delimiters",
    "SEI", "filler data", "other NAL units", "level escapes", "vectors off the frame",
    "chroma QP offset", "second chroma QP offset", "Annex B", "length prefixes", "timing info",
    "bitstream restriction", "parameter set ids", "QP deltas", "quarter-sample vectors",
    "level prefix 16", "CABAC", "8x8 transform", "intra 8x8", "SPS scaling matrices",
    "PPS scaling matrices", "default scaling lists", "I_PCM in CABAC", "scaling fall-back",
    # h264.h's Feature2 bits, from bit 64
    "B slices", "B_8x8", "spatial direct", "temporal direct", "explicit weights",
    "implicit weights", "reference B pictures", "reordered output", "bi-prediction", "B_Skip",
    "B_Direct_16x16", "B_Direct_8x8", "direct 4x4", "list 1 modification", "intra in B slices",
    "pictures not shown"))}
H264_CONTEXTS = 460  # h264.h's kContexts: the CABAC context variables frame coding uses


class _VpxDecoder:
    """What the VP8 and VP9 decoders share: the C calls ``vd_<prefix>_*``."""

    prefix = ""
    label = ""
    features_by_name: dict = {}

    def __init__(self, name: str = "<stream>"):
        self._lib = library()
        self.name = name
        self._call = lambda fn, *args: getattr(self._lib, f"vd_{self.prefix}_{fn}")(*args)
        self._handle = self._call("open")
        if not self._handle:
            raise MemoryError(f"{name}: cannot allocate a {self.label} decoder")

    @property
    def size(self):
        """(width, height) of the frames (0 before the first)."""
        w, h = ctypes.c_int(), ctypes.c_int()
        self._call("size", self._handle, ctypes.byref(w), ctypes.byref(h))
        return w.value, h.value

    @property
    def features(self) -> set:
        """The names of what the frames decoded so far used."""
        bits = self._call("features", self._handle)
        return {name for name, bit in self.features_by_name.items() if bits & bit}

    def decode(self, frame: bytes, name: str = "", rgb: bool = True):
        """Decode one sample: the RGB frame it shows (True when ``rgb`` is
        False), or None when it shows none."""
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._call("decode", self._handle, frame, len(frame), err, _ERR_LEN)
        if rc < 0:
            raise ValueError(f"{name or self.name}: {self.label} decode: {_message(err)}")
        if not rc:
            return None
        return self._rgb() if rgb else True

    def _rgb(self) -> np.ndarray:
        w, h = self.size
        out = np.empty((h, w, 3), np.uint8)
        self._call("rgb", self._handle, out.ctypes.data)
        return out

    def planes(self):
        """The (Y, U, V) planes of the frame shown last, H x W and two of
        ceil(H/2) x ceil(W/2)."""
        w, h = self.size
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        if self._call("planes", self._handle, y.ctypes.data, u.ctypes.data, v.ctypes.data):
            raise ValueError(f"{self.name}: no {self.label} frame has been shown")
        return y, u, v

    def close(self) -> None:
        if self._handle:
            self._call("free", self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


class Vp8Decoder(_VpxDecoder):
    """A VP8 decoder (RFC 6386, every version and feature), bit for bit the
    reference decoder and so FFmpeg's: ``decode(frame)`` decodes one frame
    (one sample of a WebM / Matroska ``V_VP8`` track) and returns the
    (H, W, 3) uint8 RGB frame ``cv2.VideoCapture``'s FFmpeg backend
    returns, or None for a hidden frame (an alt-ref frame with show_frame
    0, decoded for the frames after it and never shown).  The size is the
    key frame's (``size``: width, height; 0 before the first).  A frame that
    fails (a truncated partition, a bad or changing size, an inter frame
    before any key frame) raises ValueError naming it.  ``features`` names
    (``VP8_FEATURES``) what the frames decoded so far used."""

    prefix, label, features_by_name = "vp8", "VP8", VP8_FEATURES


class Vp9Decoder(_VpxDecoder):
    """A VP9 profile 0 (8-bit 4:2:0) decoder, bit for bit the reference
    decoder and so FFmpeg's: ``decode(sample)`` decodes one sample of a
    WebM / Matroska ``V_VP9`` or MP4 ``vp09`` track (one frame, or a
    superframe: hidden frames and the one shown) and returns the (H, W, 3)
    uint8 RGB frame ``cv2.VideoCapture``'s FFmpeg backend returns, or None
    when the sample shows no frame.  A frame that fails (truncated, a bad
    header, an inter frame before any key frame) or that needs what the port
    does not decode (profiles 1-3, a reference of another size, a change of
    frame size) raises ValueError naming it.  ``features`` names
    (``VP9_FEATURES``) what the frames decoded so far used."""

    prefix, label, features_by_name = "vp9", "VP9", VP9_FEATURES


class H264Decoder(_VpxDecoder):
    """An H.264 decoder of the port's own (``h264.cpp``): I, P and B
    pictures, CAVLC or CABAC, progressive, 8-bit 4:2:0, the 4x4 and 8x8
    transforms, scaling matrices, direct and weighted prediction, bit for bit
    FFmpeg's.  ``config`` is the track's avcC (its NAL length size and
    parameter sets); for Annex B samples (an AVI's), parameter sets with
    start codes or nothing.  ``reorder`` is the reorder depth FFmpeg starts
    from (the container's and its stream probe's: ``mp4.check_h264``).
    ``decode(sample)`` decodes one access unit and returns the (H, W, 3)
    uint8 RGB picture ``cv2.VideoCapture``'s FFmpeg backend returns then,
    cropped and converted with the VUI's colour space and range, or None
    when none is shown (a picture waiting to be reordered, a sample of
    parameter sets or SEI alone); pictures leave in FFmpeg's order, and at
    the end ``flush()`` gives those still waiting.  What the port does not
    decode (SP / SI slices, interlace, ...) and a damaged sample raise
    ValueError naming it.  ``probe(sample)`` reads a sample's parameter sets
    and slice headers only, raising for what ``decode`` would refuse there,
    and ``probed_reorder`` is then the depth FFmpeg's stream probe leaves;
    ``info`` is the active SPS's VUI (matrix_coefficients, full range,
    num_units_in_tick, time_scale); ``features`` names (``H264_FEATURES``)
    what the pictures decoded so far used."""

    prefix, label, features_by_name = "h264", "H.264", H264_FEATURES

    def __init__(self, config: bytes = b"", name: str = "<stream>", reorder: int = 0):
        self._lib = library()
        self.name = name
        self._call = lambda fn, *args: getattr(self._lib, f"vd_h264_{fn}")(*args)
        err = ctypes.create_string_buffer(_ERR_LEN)
        config = bytes(config)
        self._handle = self._lib.vd_h264_open(config or None, len(config), err, _ERR_LEN)
        if not self._handle:
            raise ValueError(f"{name}: H.264 decoder configuration: {_message(err)}")
        self._lib.vd_h264_set_reorder(self._handle, int(reorder))

    @property
    def features(self) -> set:
        words = (ctypes.c_ulonglong * 2)()
        self._lib.vd_h264_features(self._handle, words)
        bits = words[0] | words[1] << 64
        return {name for name, bit in self.features_by_name.items() if bits & bit}

    def flush(self, rgb: bool = True):
        """At the end of the stream: the next picture still waiting (as
        ``decode`` returns it), or None when none is left."""
        if not self._lib.vd_h264_flush(self._handle):
            return None
        return self._rgb() if rgb else True

    @property
    def probed_reorder(self) -> int:
        """After ``probe`` over the samples: the reorder depth FFmpeg's
        avformat_find_stream_info leaves, which its decoder starts from."""
        return self._lib.vd_h264_reorder(self._handle)

    def probe(self, address: int, size: int, name: str = "") -> bool:
        """Read the parameter sets and slice headers of the sample of ``size``
        bytes at memory ``address``: True when it holds a picture."""
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._call("probe", self._handle, address, size, err, _ERR_LEN)
        if rc < 0:
            raise ValueError(f"{name or self.name}: H.264: {_message(err)}")
        return bool(rc)

    @property
    def contexts(self) -> np.ndarray:
        """(``H264_CONTEXTS``,) bool: the CABAC context variables (by
        ctxIdx) that have decoded a bin since the decoder was made."""
        out = np.zeros(H264_CONTEXTS, np.uint8)
        self._call("contexts", self._handle, out.ctypes.data)
        return out.astype(bool)

    @property
    def info(self) -> dict:
        out = (ctypes.c_uint * 4)()
        self._call("info", self._handle, out)
        return {"matrix": out[0], "full_range": bool(out[1]), "num_units_in_tick": out[2],
                "time_scale": out[3]}


def _vpx_frames(decoder: _VpxDecoder, samples, name: str, every: int):
    shown = 0
    try:
        for i, sample in enumerate(samples):
            frame = decoder.decode(sample, f"{name} frame {i}", rgb=shown % every == 0)
            if frame is not None:
                if shown % every == 0:
                    yield shown, frame
                shown += 1
        flush = getattr(decoder, "flush", None)
        while flush is not None:
            frame = flush(rgb=shown % every == 0)
            if frame is None:
                break
            if shown % every == 0:
                yield shown, frame
            shown += 1
    finally:
        decoder.close()


def vp8_frames(samples, name: str, every: int = 1):
    """(display index, RGB frame) of every ``every``-th shown frame of a VP8
    stream whose frames ``samples`` yields; every frame is decoded (a hidden
    one takes no index), only the kept ones converted to RGB.  A frame that
    fails raises ValueError naming ``name`` and its number."""
    yield from _vpx_frames(Vp8Decoder(name), samples, name, every)


def vp9_frames(samples, name: str, every: int = 1):
    """``vp8_frames`` for a VP9 stream: a sample that shows no frame (hidden
    frames alone) takes no index."""
    yield from _vpx_frames(Vp9Decoder(name), samples, name, every)


def h264_frames(config: bytes, samples, name: str, every: int = 1, reorder: int = 0):
    """``vp8_frames`` for an H.264 stream configured by ``config`` (an avcC,
    or empty for Annex B) whose decoder starts at reorder depth ``reorder``:
    the pictures in FFmpeg's output order, the last ones given at the end;
    a sample that shows no picture takes no index."""
    yield from _vpx_frames(H264Decoder(config, name, reorder), samples, name, every)


CODECS = {"jpeg": 0, "mpeg4": 1, "vp8": 2, "vp9": 3, "h264": 4}  # VideoStream's codec numbers


class VideoStream:
    """Frames ``indices`` (ascending) of a video whose samples lie at file
    ``offsets`` / ``sizes`` (one per frame of the file), read, decoded and
    transformed (``frame_transform``) on a C++ thread into a ring of
    ``capacity`` frames; the thread starts here.  ``codec`` "jpeg" decodes
    only the kept frames; "mpeg4" (configured by ``config``, the stream's
    decoder configuration, and ``fourcc``, the container's tag) decodes the
    samples in decode order up to the last kept picture and transforms only
    the kept ones, ``indices`` counting pictures in display order; "vp8",
    "vp9" and "h264" (``reorder``: the depth its decoder starts from) decode
    every sample up to the last kept picture in the same way.  Iterating yields (index, x,
    affine) in order and raises ValueError for a frame that fails to read
    or decode, after the frames before it.  ``close()`` stops the thread
    and ends an iteration blocked in another thread."""

    def __init__(self, path: str, offsets, sizes, indices, size, letterbox: bool = True,
                 normalize: bool = True, capacity: int = 64, codec: str = "jpeg",
                 config: bytes = b"", fourcc: str = "", reorder: int = 0):
        if codec not in CODECS:
            raise ValueError(f"VideoStream decodes jpeg, mpeg4, vp8, vp9 or h264, not {codec!r}")
        self._lib = library()
        offsets = np.ascontiguousarray(offsets, np.int64)
        sizes = np.ascontiguousarray(sizes, np.int64)
        indices = np.ascontiguousarray(indices, np.int32)
        self._h, self._w = size
        self._dtype = np.float32 if normalize else np.uint8
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._lock = threading.Lock()
        self._busy = self._closed = False
        self._handle = self._lib.vd_video_open(
            os.fsencode(path), CODECS[codec], config or None, len(config),
            fourcc.encode("latin-1")[:4], int(reorder), offsets.ctypes.data, sizes.ctypes.data,
            len(offsets), indices.ctypes.data,
            len(indices), self._h, self._w, int(letterbox), int(normalize), int(capacity), err,
            _ERR_LEN)
        if not self._handle:
            raise ValueError(f"{path}: {_message(err)}")

    def __iter__(self):
        err = ctypes.create_string_buffer(_ERR_LEN)
        index = ctypes.c_int()
        try:
            while True:
                with self._lock:
                    if self._closed:
                        return
                    self._busy = True
                x = np.empty((self._h, self._w, 3), self._dtype)
                affine = np.empty(4, np.float32)
                try:
                    rc = self._lib.vd_video_next(self._handle, x.ctypes.data, affine.ctypes.data,
                                                 ctypes.byref(index), err, _ERR_LEN)
                finally:
                    with self._lock:
                        self._busy = False
                        if self._closed:  # closed while this call waited: free it here
                            self._free()
                if rc == 0:
                    return
                if rc < 0:
                    raise ValueError(_message(err))
                yield index.value, x, affine
        finally:
            self.close()

    def _free(self) -> None:
        if self._handle:
            self._lib.vd_video_free(self._handle)
            self._handle = None

    def close(self) -> None:
        with self._lock:
            if self._handle is None:
                return
            self._closed = True
            self._lib.vd_video_stop(self._handle)
            if not self._busy:
                self._free()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
