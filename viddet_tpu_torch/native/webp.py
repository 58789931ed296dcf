"""WebP still images as ``cv2.imdecode(buf, IMREAD_COLOR)`` gives them
(libwebp underneath): the RIFF container walked here, the bitstreams
decoded by ``webp.cpp`` in the port's codec library.

The container's three forms:

* simple lossy: one ``VP8 `` chunk, a VP8 key frame (``vd_vp8::Decoder``
  with libwebp's fancy-upsampled RGB step);
* simple lossless: one ``VP8L`` chunk;
* extended: a ``VP8X`` chunk (flags and canvas size), then ``ICCP``,
  ``ALPH`` (an alpha plane beside a lossy frame), ``EXIF``, ``XMP `` and
  unknown chunks, and either one image or, under the animation flag, an
  ``ANIM`` chunk and ``ANMF`` frames.

Alpha is dropped as ``IMREAD_COLOR`` drops it (libwebp's RGB does not
depend on it).  An animated file gives its first frame as libwebp's
``WebPAnimDecoder`` composites it: the frame's pixels at its offset on a
canvas of transparent black, the background colour and the blend and
dispose flags unread (they act from the second frame on).  The EXIF
orientation of an ``EXIF`` chunk is applied (``utils.image``) when the
``VP8X`` flags announce it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

# webp.cpp's Feature bits: what a VP8L bitstream used
VP8L_FEATURES = {name: 1 << bit for bit, name in enumerate((
    "predictor", "cross-colour", "subtract-green", "colour-indexing", "bundle 2",
    "bundle 4", "bundle 8", "colour cache", "backward references", "meta prefix codes",
    "simple codes", "normal codes", "repeated code lengths", "max symbol", "cache hits"))}

RIFF_LIMIT = (1 << 32) - 2  # libwebp's MAX_CHUNK_PAYLOAD
VP8X_ANIMATION, VP8X_EXIF = 0x02, 0x08


def _chunks(data: bytes, start: int, end: int, name: str):
    """(tag, payload, payload offset) of each chunk in data[start:end],
    padded to even sizes."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise ValueError(f"{name}: WebP chunk header is truncated")
        tag = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        if pos + 8 + size > end:
            raise ValueError(f"{name}: WebP chunk {tag!r} is truncated")
        yield tag, data[pos + 8 : pos + 8 + size], pos + 8
        pos += 8 + size + (size & 1)


def _u24(b: bytes, pos: int) -> int:
    return b[pos] | b[pos + 1] << 8 | b[pos + 2] << 16


def vp8l_size(payload: bytes, name: str):
    """(width, height) from a VP8L header."""
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError(f"{name}: not a VP8L bitstream")
    (bits,) = struct.unpack_from("<I", payload, 1)
    if bits >> 29:
        raise ValueError(f"{name}: VP8L version {bits >> 29} is not 0")
    return (bits & 0x3FFF) + 1, (bits >> 14 & 0x3FFF) + 1


def vp8_size(payload: bytes, name: str):
    """(width, height) from a VP8 key frame's header."""
    if len(payload) < 10 or payload[0] & 1 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: not a VP8 key frame")
    w, h = struct.unpack_from("<HH", payload, 6)
    return w & 0x3FFF, h & 0x3FFF


def decode_vp8l(stream: bytes, name: str, features: dict | None = None) -> np.ndarray:
    """A VP8L bitstream (from its header on) -> (H, W, 3) uint8 RGB.
    ``features``, when given, gets ``"features"`` (names of
    ``VP8L_FEATURES``) and ``"predictor_modes"`` (the set of modes used)."""
    from viddet_tpu_torch.native import _ERR_LEN, _check_size, _message, library

    width, height = vp8l_size(stream, name)
    _check_size(name, width, height)
    out = np.empty((height, width, 3), np.uint8)
    bits, modes = ctypes.c_uint(), ctypes.c_uint()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().vd_vp8l_decode(stream, len(stream), width, height, out.ctypes.data,
                                ctypes.byref(bits), ctypes.byref(modes), err, _ERR_LEN):
        raise ValueError(f"{name}: WebP lossless: {_message(err)}")
    if features is not None:
        features["features"] = {n for n, b in VP8L_FEATURES.items() if bits.value & b}
        features["predictor_modes"] = {m for m in range(16) if modes.value >> m & 1}
    return out


def decode_vp8(stream: bytes, name: str) -> np.ndarray:
    """A VP8 key frame (from its frame tag on; its last token partition runs
    to the end) -> (H, W, 3) uint8 RGB, libwebp's fancy upsampling."""
    from viddet_tpu_torch.native import _ERR_LEN, _check_size, _message, library

    width, height = vp8_size(stream, name)
    if not width or not height:
        raise ValueError(f"{name}: VP8 frame of size {width}x{height}")
    _check_size(name, width, height)
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if library().vd_webp_lossy(stream, len(stream), width, height, out.ctypes.data, err,
                               _ERR_LEN):
        raise ValueError(f"{name}: WebP lossy: {_message(err)}")
    return out


def _image(chunks, name: str, features, rest: bytes | None = None):
    """The RGB of the first VP8 / VP8L chunk among ``chunks`` (an ALPH
    before a VP8 is skipped).  ``rest``, when given, is the whole input:
    libwebp decodes a still image's bitstream out of everything from the
    chunk's payload on, so a corrupt stream may read past its chunk."""
    for tag, payload, offset in chunks:
        stream = payload if rest is None else rest[offset:]
        if tag == b"VP8L":
            return decode_vp8l(stream, name, features)
        if tag == b"VP8 ":
            return decode_vp8(stream, name)
    raise ValueError(f"{name}: WebP holds no VP8 or VP8L image")


def decode_webp(data: bytes, name: str = "<bytes>", features: dict | None = None) -> np.ndarray:
    """WebP bytes -> upright (H, W, 3) uint8 RGB, as ``cv2.imdecode``
    (IMREAD_COLOR) and a BGR-to-RGB swap give it.  ``features`` as for
    ``decode_vp8l`` (left empty for a lossy image).  Raises ValueError for a
    truncated or corrupt file."""
    from viddet_tpu_torch.native import _check_size
    from viddet_tpu_torch.utils.image import apply_orientation, tiff_orientation

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: not a WebP (RIFF ... WEBP) file")
    (riff_size,) = struct.unpack_from("<I", data, 4)
    if riff_size < 12 or riff_size > RIFF_LIMIT:
        raise ValueError(f"{name}: bad WebP RIFF size {riff_size}")
    if riff_size + 8 > len(data):
        raise ValueError(f"{name}: WebP file is truncated ({len(data)} of {riff_size + 8} bytes)")
    chunks = list(_chunks(data, 12, riff_size + 8, name))
    if not chunks:
        raise ValueError(f"{name}: WebP holds no chunk")
    tag, payload, _ = chunks[0]
    if tag != b"VP8X":
        return _image(chunks[:1], name, features, data)
    if len(payload) < 10:
        raise ValueError(f"{name}: WebP VP8X chunk is truncated")
    flags = payload[0]
    width, height = _u24(payload, 4) + 1, _u24(payload, 7) + 1
    _check_size(name, width, height)
    # the chunk counts only under the header's EXIF flag, as libwebp's demuxer reads it
    exif = next((p for t, p, _ in chunks if t == b"EXIF"), None) if flags & VP8X_EXIF else None
    if flags & VP8X_ANIMATION:
        frame = next((p for t, p, _ in chunks if t == b"ANMF"), None)
        if frame is None:
            raise ValueError(f"{name}: animated WebP holds no frame")
        if len(frame) < 16:
            raise ValueError(f"{name}: WebP ANMF chunk is truncated")
        x, y = 2 * _u24(frame, 0), 2 * _u24(frame, 3)
        fw, fh = _u24(frame, 6) + 1, _u24(frame, 9) + 1
        if x + fw > width or y + fh > height:
            raise ValueError(f"{name}: WebP frame {fw}x{fh}+{x}+{y} leaves the "
                             f"{width}x{height} canvas")
        rgb = _image(_chunks(frame, 16, len(frame), name), name, features)
        if rgb.shape[:2] != (fh, fw):
            raise ValueError(f"{name}: WebP frame image {rgb.shape[1]}x{rgb.shape[0]} is not "
                             f"its {fw}x{fh}")
        image = np.zeros((height, width, 3), np.uint8)
        image[y : y + fh, x : x + fw] = rgb
    else:
        image = _image(chunks[1:], name, features, data)
        if image.shape[:2] != (height, width):
            raise ValueError(f"{name}: WebP image {image.shape[1]}x{image.shape[0]} is not the "
                             f"{width}x{height} canvas")
    return image if exif is None else apply_orientation(image, tiff_orientation(exif))
