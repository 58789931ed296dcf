"""TIFF still images as ``cv2.imdecode(buf, IMREAD_COLOR)`` gives them:
OpenCV's TIFF decoder reads the first page through libtiff's RGBA interface
(``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``) and turns it upright by its
Orientation tag.  The container and its tags are read here, Deflate is
inflated with Python's ``zlib``, JPEG strips and tiles go to the port's JPEG
decoder (``codec.cpp``) with their ``JPEGTables`` spliced in, and
``tiff.cpp`` expands LZW, PackBits and CCITT, undoes the predictor and
converts the samples to RGB.

What OpenCV and libtiff read, and so this module:

* classic TIFF and BigTIFF, either byte order; the first IFD only (a
  multi-page file gives its first page);
* compression none, LZW (and libtiff's old LSB-first form), Deflate (8 and
  32946), PackBits, JPEG (7) and CCITT of 1-bit samples: modified Huffman
  (2, rows on a byte), Group 3 (3: an EOL before every row, fill bits, 2-D
  rows under T4Options bit 0) and Group 4 (4), as tif_fax3.c decodes them;
  horizontal predictor 2 at 8 and 16 bits under LZW and Deflate (the tag
  means nothing to the other schemes); FillOrder 2 reverses the bits of
  every stored byte;
* strips, and tiles with the edge tiles cropped; PlanarConfiguration 1 and
  2;
* Photometric MinIsWhite / MinIsBlack of 1, 8 and 16 bits (16-bit grey
  keeps its high byte; MinIsWhite inverted); Palette of 1, 4 and 8 bits (a
  16-bit colour map cut to 8 bits by ``>> 8`` unless every entry is below
  256); RGB of 8 and 16 bits (16 to 8 by ``(v + 128) // 257``); CMYK of
  8 bits under InkSet 1 as ``(255 - c)(255 - k) // 255``; YCbCr of 8 bits
  at the subsamplings libtiff draws, through libtiff's own conversion, or
  under JPEG converted by the JPEG decoder as libtiff's JPEGCOLORMODE_RGB
  has libjpeg convert it; CIELab of three 8- or 16-bit samples through
  tif_color.c's float conversion (WhitePoint, D50 without it);
* signed samples (SampleFormat 2) as unsigned ones, as libtiff's RGBA
  read takes them;
* alpha: associated (ExtraSamples 1, or an unspecified extra sample beside
  three colours) dropped, unassociated (2) premultiplied as
  ``(c * a + 127) // 255``; separate grey planes are taken as RGB, so their
  alpha premultiplies and MinIsWhite is not inverted;
* Orientation 1-8 applied as ``cv2.imdecode`` applies it: where it mirrors
  left to right, libtiff mirrors each tile in place, so a tiled image comes
  out mirrored tile by tile.

What it refuses, with a ValueError naming the file, "TIFF" and the feature,
before any pixel is decoded: the compressions CCITT RLEW (32771, which
libtiff reads in part), old JPEG (6), LZMA, ZSTD, WebP, JBIG, LERC, SGILog,
PixarLog, NeXT, ThunderScan and any other; float samples; bit depths other
than those above; Photometric CIELab other than above, ICCLab, ITULab,
LogL, LogLuv and any other; InkSet 2; more than 4 samples a pixel; a tag
out of range; a strip or tile past the end of the file; missing byte
counts; and any strip whose data ends short.  A CCITT stream with a bad
code word, a row of the wrong length, an early EOFB or uncompressed mode
(which libtiff does not decode either) raises naming the scheme and the
row; cv2 keeps what libtiff decoded before it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from viddet_tpu_torch.utils.image import apply_orientation

TIFF_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")

# Tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
T4_OPTIONS, PLANAR, PREDICTOR, WHITE_POINT, COLORMAP = 292, 284, 317, 318, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
INKSET, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 332, 338, 339, 347
YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BW = 529, 530, 532

# Field types: (size, numpy code); RATIONAL and SRATIONAL are pairs of 4-byte words
_TYPES = {1: (1, "u1"), 2: (1, "u1"), 3: (2, "u2"), 4: (4, "u4"), 5: (8, "u4"), 6: (1, "i1"),
          7: (1, "u1"), 8: (2, "i2"), 9: (4, "i4"), 10: (8, "i4"), 11: (4, "f4"),
          12: (8, "f8"), 13: (4, "u4"), 16: (8, "u8"), 17: (8, "i8"), 18: (8, "u8")}

READ_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32946, 32773)
CCITT = {2: "CCITT modified Huffman", 3: "CCITT Group 3", 4: "CCITT Group 4"}
REFUSED_COMPRESSIONS = {
    6: "old-style JPEG", 32771: "CCITT RLEW", 32766: "NeXT", 32809: "ThunderScan",
    32908: "PixarLog",
    32909: "PixarLog", 32947: "Kodak DCS", 34661: "JBIG", 34676: "SGILog", 34677: "SGILog24",
    34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
}
PHOTOMETRIC_NAMES = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "Palette",
                     4: "Transparency mask", 5: "Separated", 6: "YCbCr", 8: "CIELab",
                     9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
# tiff.cpp's put routines
GREY, PALETTE, RGB, CMYK, YCBCR, SEPARATE_RGB, SEPARATE_CMYK, SEPARATE_YCBCR, CIELAB = range(9)
NO_ALPHA, ASSOCIATED, UNASSOCIATED = 0, 1, 2
MAX_TILE_BYTES = 1 << 30  # OpenCV's "TIFF tile size is too large" limit
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
_DEFAULT_LUMA = (0.299, 0.587, 0.114)
_DEFAULT_REFERENCE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)


class _Ifd:
    """The first IFD's entries, read as libtiff reads them."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        self.order = "<" if data[:2] == b"II" else ">"
        self.big = struct.unpack_from(self.order + "H", data, 2)[0] == 43
        if self.big:
            size, zero, first = struct.unpack_from(self.order + "HHQ", data, 4)
            if size != 8 or zero:
                raise self.error(f"BigTIFF header names {size}-byte offsets")
        else:
            first = struct.unpack_from(self.order + "I", data, 4)[0]
        count_size, entry_size = (8, 20) if self.big else (2, 12)
        if first < 8 or first + count_size > len(data):
            raise self.error(f"first IFD at byte {first} lies past the file's {len(data)} bytes")
        count = struct.unpack_from(self.order + ("Q" if self.big else "H"), data, first)[0]
        if first + count_size + count * entry_size > len(data):
            raise self.error(f"IFD of {count} entries runs past the end of the file")
        self.entries = {}
        for k in range(count):
            at = first + count_size + k * entry_size
            if self.big:
                tag, kind, n = struct.unpack_from(self.order + "HHQ", data, at)
            else:
                tag, kind, n = struct.unpack_from(self.order + "HHI", data, at)
            if kind not in _TYPES or tag in self.entries:
                continue  # libtiff skips fields of unknown type and later duplicates
            size = _TYPES[kind][0] * n
            inline = 8 if self.big else 4
            if size <= inline:
                offset = at + (12 if self.big else 8)
            else:
                offset = struct.unpack_from(self.order + ("Q" if self.big else "I"), data,
                                            at + (12 if self.big else 8))[0]
                if offset + size > len(data):
                    raise self.error(f"tag {tag} holds {n} values past the end of the file")
            self.entries[tag] = (kind, n, offset)

    def error(self, what: str) -> ValueError:
        return ValueError(f"{self.name}: TIFF {what}")

    def values(self, tag: int, default=None) -> np.ndarray | None:
        """The tag's values as an array (rationals as float32 quotients, as
        libtiff reads them), or ``default``."""
        if tag not in self.entries:
            return None if default is None else np.asarray(default)
        kind, n, offset = self.entries[tag]
        size, code = _TYPES[kind]
        if kind in (5, 10):
            pairs = np.frombuffer(self.data, self.order + code, 2 * n, offset).astype(np.float32)
            num, den = pairs[0::2], pairs[1::2]
            return np.where(den == 0, np.float32(0), num / np.where(den == 0, 1, den))
        return np.frombuffer(self.data, self.order + code, n, offset)

    def raw(self, tag: int) -> bytes | None:
        if tag not in self.entries:
            return None
        kind, n, offset = self.entries[tag]
        return self.data[offset : offset + _TYPES[kind][0] * n]

    def number(self, tag: int, default: int | None = None) -> int:
        v = self.values(tag)
        if v is None or not len(v):
            if default is None:
                raise self.error(f"lacks tag {tag}")
            return default
        if v.dtype.kind == "f":
            raise self.error(f"tag {tag} is not an integer")
        return int(v[0])

    def same(self, tag: int, default: int) -> int:
        """A per-sample tag whose values must all be equal (libtiff's
        TIFFReadDirEntryPersampleShort)."""
        v = self.values(tag)
        if v is None or not len(v):
            return default
        if len(set(v.tolist())) != 1:
            raise self.error(f"tag {tag} holds different values per sample")
        return int(v[0])


def _lib():
    from viddet_tpu_torch.native import library

    return library()


def _inflate(chunk: bytes, reverse: bool, need: int, name: str) -> bytes:
    """A Deflate chunk -> its first ``need`` bytes (libtiff decodes no more)."""
    if reverse:
        chunk = chunk.translate(_REVERSED)
    try:
        raw = zlib.decompressobj().decompress(chunk, need)
    except zlib.error as exc:
        raise ValueError(f"{name}: TIFF Deflate data: {exc}") from exc
    if len(raw) < need:
        raise ValueError(f"{name}: TIFF Deflate data ends {need - len(raw)} bytes short of the "
                         f"chunk's {need}")
    return raw


def _jpeg(chunk: bytes, tables: bytes | None, space: int, components: int, width: int,
          rows: int, full: int, name: str) -> np.ndarray:
    """One abbreviated JPEG strip or tile, its JPEGTables spliced in after
    its SOI, decoded in the colour space libtiff picks -> (rows, width, c).
    Its frame is ``width`` by ``rows``, or by ``full`` rows (a last strip
    coded at the whole RowsPerStrip, which libtiff cuts)."""
    from viddet_tpu_torch.native import _ERR_LEN, _message

    if chunk[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: TIFF JPEG strip does not start with SOI")
    if tables:
        body = tables[2:] if tables[:2] == b"\xff\xd8" else tables
        body = body[:-2] if body[-2:] == b"\xff\xd9" else body
        chunk = chunk[:2] + body + chunk[2:]
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.vd_jpeg_header(chunk, len(chunk), ctypes.byref(w), ctypes.byref(h), err, _ERR_LEN):
        raise ValueError(f"{name}: TIFF JPEG header: {_message(err)}")
    if w.value != width or h.value not in (rows, full):  # tif_jpeg.c JPEGPreDecode
        raise ValueError(f"{name}: TIFF JPEG strip of {w.value}x{h.value} where {width}x{rows} "
                         f"is wanted")
    channels = 3 if space == 1 else components
    out = np.empty((h.value, w.value, channels), np.uint8)
    if lib.vd_jpeg_decode_as(chunk, len(chunk), out.ctypes.data, w.value, h.value, space,
                             components, err, _ERR_LEN):
        raise ValueError(f"{name}: TIFF JPEG strip: {_message(err)}")
    return out[:rows]


class _Layout:
    """What the tags say of the raster, checked as OpenCV and libtiff check
    it."""

    def __init__(self, ifd: _Ifd):
        from viddet_tpu_torch.native import _check_size

        err = ifd.error
        self.width, self.height = ifd.number(WIDTH), ifd.number(LENGTH)
        if self.width <= 0 or self.height <= 0:
            raise err(f"image of size {self.width}x{self.height}")
        _check_size(ifd.name, self.width, self.height)
        self.compression = ifd.number(COMPRESSION, 1)
        if self.compression in REFUSED_COMPRESSIONS:
            raise err(f"compression {REFUSED_COMPRESSIONS[self.compression]} "
                      f"({self.compression}) is not decoded by the port")
        if self.compression not in READ_COMPRESSIONS:
            raise err(f"compression {self.compression} is not decoded by the port")
        if PHOTOMETRIC not in ifd.entries:
            raise err("lacks its Photometric tag")
        self.photometric = ifd.number(PHOTOMETRIC)
        self.spp = ifd.number(SPP, 1)
        self.bps = ifd.same(BITS, 1)
        fmt = ifd.same(SAMPLE_FORMAT, 1)
        if fmt not in (1, 2):  # libtiff's RGBA read takes signed samples as unsigned
            what = {3: "floating-point"}.get(fmt, f"sample format {fmt}")
            raise err(f"{what} samples are not decoded by the port")
        if not 1 <= self.spp <= 4:
            raise err(f"of {self.spp} samples a pixel (OpenCV reads 1 to 4)")
        photo = PHOTOMETRIC_NAMES.get(self.photometric, str(self.photometric))
        if self.photometric not in (0, 1, 2, 3, 5, 6, 8):
            raise err(f"Photometric {photo} is not decoded by the port")
        self.planar = ifd.number(PLANAR, 1)
        if self.planar not in (1, 2):
            raise err(f"PlanarConfiguration {self.planar}")
        self.contig = not (self.planar == 2 and self.spp > 1)
        extra = ifd.values(EXTRA_SAMPLES)
        colours = {0: 1, 1: 1, 3: 1, 2: 3, 6: 3, 8: 3, 5: 4}[self.photometric]
        if extra is None:  # TIFFReadDirectory: samples past the colours are extra samples
            extra = np.zeros(max(self.spp - colours, 0), np.int64)
        if len(extra) > self.spp:
            raise err(f"names {len(extra)} extra samples of {self.spp}")
        self.colours = self.spp - len(extra)
        self.alpha = NO_ALPHA
        if len(extra):  # TIFFRGBAImageBegin
            if extra[0] == 0 and self.spp > 3:
                self.alpha = ASSOCIATED
            elif extra[0] in (1, 2):
                self.alpha = int(extra[0])
        self.orientation = ifd.number(ORIENTATION, 1)
        if not 1 <= self.orientation <= 8:
            self.orientation = 1  # libtiff refuses the value and keeps its default
        self.fill_reverse = ifd.number(FILL_ORDER, 1) == 2
        self.predictor = ifd.number(PREDICTOR, 1) if self.compression in (5, 8, 32946) else 1
        self.t4_options = 0
        if self.compression in CCITT:
            self._ccitt(ifd)
        self.sub = (1, 1)
        self.jpeg_space = 0
        self._kind(ifd, photo)
        self._chunks(ifd)

    def _ccitt(self, ifd: _Ifd) -> None:
        """tif_fax3.c's checks: 1-bit samples, one a pixel; Group 3's 2-D
        rows under T4Options bit 0.  The options' uncompressed-mode bit
        changes nothing; a stream that enters that mode raises in
        ``tiff.cpp``, as libtiff does not decode it either."""
        if self.bps != 1 or self.spp != 1:
            raise ifd.error(f"compression {CCITT[self.compression]} of {self.spp} "
                            f"{self.bps}-bit samples a pixel")
        if self.compression == 3:
            self.t4_options = ifd.number(T4_OPTIONS, 0) & 1

    def _kind(self, ifd: _Ifd, photo: str) -> None:
        """The put routine tif_getimage.c's PickContigCase / PickSeparateCase
        picks, or a refusal where it picks none."""
        err, bps, ph = ifd.error, self.bps, self.photometric
        if bps not in (1, 4, 8, 16) or (bps == 4 and ph != 3):
            raise err(f"{photo} of {bps}-bit samples is not decoded by the port")
        if self.compression == 7:
            if bps != 8 or not self.contig or ph not in (0, 1, 2, 5, 6):
                raise err(f"JPEG compression of {bps}-bit {photo}"
                          f"{'' if self.contig else ' in planes'} is not decoded by the port")
            self.jpeg_space = 1 if ph == 6 else 5  # JPEGCOLORMODE_RGB, else as they are
        if self.predictor not in (1, 2) or (self.predictor == 2 and bps not in (8, 16)):
            raise err(f"predictor {self.predictor} with {bps}-bit samples is not decoded by the "
                      f"port")
        if ph in (0, 1, 3) and self.contig and self.spp != 1 and bps < 8:
            raise err(f"{photo} of {bps}-bit samples with {self.spp} samples a pixel")
        if ph == 2 and self.colours < 3:
            raise err(f"RGB with {self.colours} colour samples")
        if ph == 5:
            if ifd.number(INKSET, 1) != 1:
                raise err(f"InkSet {ifd.number(INKSET)} is not decoded by the port")
            if self.spp != 4 or bps != 8:
                raise err(f"Separated of {self.spp} {bps}-bit samples is not decoded by the "
                          f"port")
        if ph == 3 and bps == 16:
            raise err("Palette of 16-bit samples is not decoded by the port")
        if ph == 6 and self.compression != 7:
            if bps != 8 or self.spp != 3:
                raise err(f"YCbCr of {self.spp} {bps}-bit samples is not decoded by the port")
            sub = ifd.values(YCBCR_SUBSAMPLING, (2, 2))
            self.sub = (int(sub[0]), int(sub[1]) if len(sub) > 1 else int(sub[0]))
            allowed = ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2))
            if self.sub not in allowed or (not self.contig and self.sub != (1, 1)):
                raise err(f"YCbCr subsampling {self.sub[0]}x{self.sub[1]}"
                          f"{'' if self.contig else ' in planes'} is not decoded by the port")
        if ph == 6 and self.compression == 7 and self.spp != 3:
            raise err(f"YCbCr JPEG of {self.spp} samples")
        if ph == 8 and (self.spp != 3 or self.colours != 3 or bps not in (8, 16)
                        or not self.contig):
            raise err(f"CIELab of {self.spp} {bps}-bit samples"
                      f"{'' if self.contig else ' in planes'} is not decoded by the port")
        if self.jpeg_space == 1:
            self.kind = RGB  # the JPEG decoder gives RGB
        elif self.contig:
            self.kind = {0: GREY, 1: GREY, 2: RGB, 3: PALETTE, 5: CMYK, 6: YCBCR, 8: CIELAB}[ph]
        else:
            if bps not in (8, 16) or ph == 3 or (bps == 16 and ph in (5, 6)):
                raise err(f"{photo} of {bps}-bit samples in planes is not decoded by the port")
            self.kind = {0: SEPARATE_RGB, 1: SEPARATE_RGB, 2: SEPARATE_RGB, 5: SEPARATE_CMYK,
                         6: SEPARATE_YCBCR}[ph]
        self.colormap = None
        if ph == 3:
            cmap = ifd.values(COLORMAP)
            n = 1 << bps
            if cmap is None or len(cmap) != 3 * n:  # libtiff drops a map of another size
                raise err("Palette lacks its ColorMap")
            cmap = cmap.astype(np.int64).reshape(3, n)
            if (cmap >= 256).any():  # checkcmap: a 16-bit map, else "Assuming 8-bit colormap"
                cmap = cmap >> 8
            self.colormap = np.zeros((3, 256), np.uint8)
            self.colormap[:, :n] = cmap & 255
        self.ycbcr = None
        if ph == 8:  # the WhitePoint and whether the tag is there, for tiff.cpp's CieLab
            white = ifd.values(WHITE_POINT)
            given = white is not None and len(white) >= 2
            self.ycbcr = np.zeros(9, np.float32)
            self.ycbcr[:3] = (*white[:2], 1) if given else (0, 0, 0)
            if given and (not np.isfinite(self.ycbcr).all() or self.ycbcr[1] == 0):
                raise err("CIELab WhitePoint out of range")
        if ph == 6:
            luma = ifd.values(YCBCR_COEFFICIENTS)
            luma = _DEFAULT_LUMA if luma is None or len(luma) < 3 else luma[:3]
            ref = ifd.values(REFERENCE_BW)
            ref = _DEFAULT_REFERENCE if ref is None or len(ref) < 6 else ref[:6]
            self.ycbcr = np.asarray([*luma, *ref], np.float32)
            # initYCbCrConversion refuses NaN and a zero green; past 2^24 its
            # integer casts have no defined value
            if (not np.isfinite(self.ycbcr).all() or self.ycbcr[1] == 0
                    or np.abs(self.ycbcr).max() > 1 << 24):
                raise err("YCbCr coefficients or ReferenceBlackWhite out of range")

    def _chunks(self, ifd: _Ifd) -> None:
        err = ifd.error
        self.tiled = TILE_WIDTH in ifd.entries or TILE_OFFSETS in ifd.entries
        if self.tiled:
            self.chunk_w, self.chunk_h = ifd.number(TILE_WIDTH), ifd.number(TILE_LENGTH)
            if self.chunk_w <= 0 or self.chunk_h <= 0:
                raise err(f"tiles of {self.chunk_w}x{self.chunk_h}")
            offsets_tag, counts_tag = TILE_OFFSETS, TILE_COUNTS
            across = -(-self.width // self.chunk_w)
            down = -(-self.height // self.chunk_h)
        else:
            self.chunk_w = self.width
            rows = ifd.number(ROWS_PER_STRIP, 0xFFFFFFFF)
            if rows <= 0:
                raise err(f"RowsPerStrip {rows}")
            self.chunk_h = min(rows, self.height)
            offsets_tag, counts_tag = STRIP_OFFSETS, STRIP_COUNTS
            across, down = 1, -(-self.height // self.chunk_h)
        samples_per_chunk = self.spp if self.contig else 1
        chunk_bytes = self.chunk_w * self.chunk_h * samples_per_chunk * max(1, self.bps // 8)
        if chunk_bytes >= MAX_TILE_BYTES:
            raise err(f"chunk of {self.chunk_w}x{self.chunk_h} is too large")
        if self.sub != (1, 1) and self.chunk_h % self.sub[1] and down > 1:
            raise err(f"strips of {self.chunk_h} rows under {self.sub[0]}x{self.sub[1]} "
                      f"subsampling")
        self.across, self.down = across, down
        planes = 1 if self.contig else self.spp
        need = across * down * planes
        offsets, counts = ifd.values(offsets_tag), ifd.values(counts_tag)
        if offsets is None:
            raise err("lacks its strip or tile offsets")
        if counts is None:
            raise err("lacks its strip or tile byte counts")
        if len(offsets) < need or len(counts) < need:
            raise err(f"holds {min(len(offsets), len(counts))} of its {need} strips or tiles")
        self.offsets = offsets[:need].astype(np.int64).reshape(planes, down * across)
        self.counts = counts[:need].astype(np.int64).reshape(planes, down * across)
        if ((self.offsets < 0) | (self.counts < 0)
                | (self.offsets + self.counts > len(ifd.data))).any():
            raise err("strip or tile lies past the end of the file")
        if self.sub != (1, 1):
            h, v = self.sub
            self.row_bytes = -(-self.chunk_w // h) * (h * v + 2)  # a row of data units
            self.scanline = self.row_bytes // v  # TIFFScanlineSize, the predictor's row
        else:
            self.row_bytes = -(-self.chunk_w * samples_per_chunk * self.bps // 8)
            self.scanline = self.row_bytes

    def chunk_rows(self, down: int) -> int:
        """Rows of the stored chunk at band ``down`` (tiles are whole)."""
        if self.tiled:
            return self.chunk_h
        return min(self.chunk_h, self.height - down * self.chunk_h)

    def chunk_bytes(self, rows: int) -> int:
        if self.sub != (1, 1):
            return -(-rows // self.sub[1]) * self.row_bytes
        return rows * self.row_bytes


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """TIFF bytes -> (H, W, 3) uint8 RGB of the first page, upright, as
    ``cv2.imdecode`` (IMREAD_COLOR) and a BGR-to-RGB swap give it.  Raises
    ValueError for what the port does not read and for a truncated or
    corrupt file."""
    from viddet_tpu_torch.native import _ERR_LEN, _message

    if len(data) < 8 or data[:4] not in TIFF_SIGNATURES:
        raise ValueError(f"{name}: not a TIFF (II*, MM*, II+ or MM+)")
    if len(data) < 16 and data[2:4] in (b"+\0", b"\0+"):
        raise ValueError(f"{name}: TIFF is truncated")
    ifd = _Ifd(data, name)
    lay = _Layout(ifd)
    tables = ifd.raw(JPEG_TABLES)
    # the plane that feeds each of tiff.cpp's four plane pointers
    if lay.contig:
        slots = [0, None, None, None]
    elif lay.kind == SEPARATE_RGB:  # grey planes are taken as RGB, alpha after the colours
        alpha = lay.colours if lay.alpha != NO_ALPHA and lay.colours < lay.spp else None
        slots = ([0, 0, 0] if lay.colours < 3 else [0, 1, 2]) + [alpha]
    else:
        slots = [0, 1, 2, 3 if lay.kind == SEPARATE_CMYK else None]
    wanted = sorted({p for p in slots if p is not None})
    planes = 1 if lay.contig else lay.spp
    offsets, counts = lay.offsets.astype(np.uint64), lay.counts.astype(np.uint64)
    if (lay.counts[wanted] == 0).any():
        raise ValueError(f"{name}: TIFF strip or tile is empty")
    compression, reverse, spp = lay.compression, lay.fill_reverse, lay.spp
    if compression in (7, 8, 32946):
        # Python's zlib, or the JPEG decoder, expands each chunk; tiff.cpp takes
        # them as stored
        pieces, at = [], 0
        offsets, counts = np.zeros_like(offsets), np.zeros_like(counts)
        for p in wanted:
            for k in range(lay.across * lay.down):
                chunk = data[int(lay.offsets[p, k]) : int(lay.offsets[p, k] + lay.counts[p, k])]
                rows = lay.chunk_rows(k // lay.across)
                if compression == 7:  # libjpeg reads the bytes as stored (TIFF_NOBITREV)
                    raw = _jpeg(chunk, tables, lay.jpeg_space, lay.spp, lay.chunk_w, rows,
                                lay.chunk_h, name).tobytes()
                else:
                    raw = _inflate(chunk, reverse, lay.chunk_bytes(rows), name)
                offsets[p, k], counts[p, k] = at, len(raw)
                pieces.append(raw)
                at += len(raw)
        data, compression, reverse = b"".join(pieces), 1, False
    params = (ctypes.c_int * 23)(
        compression, int(reverse), lay.predictor, int(ifd.order == ">"), lay.bps, spp, lay.kind,
        lay.alpha, lay.width, lay.height, lay.chunk_w, lay.chunk_h, lay.across, lay.down,
        int(lay.tiled), lay.sub[0], lay.sub[1], int(lay.photometric == 0 and lay.kind == GREY),
        planes, lay.row_bytes, lay.scanline,
        (lay.spp if lay.contig else 1) if lay.sub == (1, 1) else 3, lay.t4_options)
    cmap = lay.colormap if lay.colormap is not None else np.zeros((3, 256), np.uint8)
    ycc = lay.ycbcr if lay.ycbcr is not None else np.zeros(9, np.float32)
    out = np.empty((lay.height, lay.width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().vd_tiff_decode(data, len(data), offsets.ctypes.data, counts.ctypes.data, params,
                             (ctypes.c_int * 4)(*(-1 if p is None else p for p in slots)),
                             cmap.ctypes.data, ycc.ctypes.data, out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: TIFF {_message(err)}")
    orientation = lay.orientation
    if orientation in (2, 3, 6, 7):
        # libtiff's FLIP_HORIZONTALLY mirrors each strip or tile where it lies
        # (a tile's visible columns); OpenCV turns the rest of the way
        for x0 in range(0, lay.width, lay.chunk_w):
            out[:, x0 : x0 + lay.chunk_w] = out[:, x0 : x0 + lay.chunk_w][:, ::-1]
        orientation = {2: 1, 3: 4, 6: 7, 7: 6}[orientation]
    return apply_orientation(out, orientation)
