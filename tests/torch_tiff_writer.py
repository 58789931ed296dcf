"""The tests' own TIFF writer (Python, numpy, ``zlib`` and cv2's JPEG
encoder).  Nothing in the port imports it.

PIL writes the common TIFF forms through libtiff; the forms it does not
write (BigTIFF, big-endian files, FillOrder 2, old-style LZW, planar tiles,
predictor 2 at 16 bits, every YCbCr subsampling, abbreviated JPEG strips
with their ``JPEGTables``, a colour map of 8-bit values, forged tags) are
laid out here, so that the tests can hold the port's decoder to
``cv2.imdecode`` on them.

``tiff(samples, ...)`` writes one page (``pages`` repeats it with other
content after the first), ``samples`` an (H, W, S) array of sample values
(any integer dtype; values below ``1 << bps``).  Chunks (strips of
``rows_per_strip`` rows, or ``tile=(width, length)`` tiles padded at the
edges) are filled plane by plane under ``planar=2``, differenced by
``predictor=2``, compressed (``compression`` 1 none, 5 LZW, 8 / 32946
Deflate, 32773 PackBits, 7 JPEG; any other number writes the raw samples
under that tag) and bit-reversed under ``fill_order=2``.  Photometric
YCbCr with ``subsampling=(h, v)`` packs ``samples`` (full-size Y, Cb, Cr)
into data units, the chroma of each block its top-left sample.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

BYTE, ASCII, SHORT, LONG, RATIONAL, UNDEFINED, FLOAT, LONG8 = 1, 2, 3, 4, 5, 7, 11, 16
_SIZES = {BYTE: 1, ASCII: 1, SHORT: 2, LONG: 4, RATIONAL: 8, UNDEFINED: 1, FLOAT: 4, LONG8: 8}
_CODES = {BYTE: "B", ASCII: "B", SHORT: "H", LONG: "I", UNDEFINED: "B", FLOAT: "f", LONG8: "Q"}

WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
PLANAR, PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = (
    284, 317, 320, 322, 323, 324, 325)
INKSET, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 332, 338, 339, 347
YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BW = 529, 530, 532

REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def lzw(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW: 9- to 12-bit codes, most significant bit first, the width
    growing one code early (``old``: libtiff's first form, least
    significant bit first, growing on time), a clear code first and before
    the table fills, an end code last."""
    out, acc, nbits = bytearray(), 0, 0
    width = 9

    def put(code: int) -> None:
        nonlocal acc, nbits
        if old:
            acc |= code << nbits
            nbits += width
            while nbits >= 8:
                out.append(acc & 255)
                acc >>= 8
                nbits -= 8
        else:
            acc = acc << width | code
            nbits += width
            while nbits >= 8:
                nbits -= 8
                out.append(acc >> nbits & 255)

    def grow(next_code: int) -> None:
        nonlocal width
        if next_code >= (1 << width) + old and width < 12:
            width += 1

    table, next_code = {}, 258
    put(256)
    prefix = b""
    for byte in data:
        s = prefix + bytes([byte])
        if not prefix or s in table:
            prefix = s
            continue
        put(table[prefix] if len(prefix) > 1 else prefix[0])
        if next_code == 4094:  # the table is full: a clear code at the current width
            put(256)
            table, next_code, width = {}, 258, 9
        else:
            table[s] = next_code
            next_code += 1
            grow(next_code)
        prefix = bytes([byte])
    if prefix:
        put(table[prefix] if len(prefix) > 1 else prefix[0])
        grow(next_code + 1)
    put(257)
    if nbits:
        out.append((acc << (8 - nbits) if not old else acc) & 255)
    return bytes(out)


def packbits(data: bytes, rng=None) -> bytes:
    """PackBits: runs of 2-128 equal bytes as a repeat, the rest literal;
    ``rng`` also puts in no-op bytes (-128) and splits literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        if rng is not None and rng.random() < 0.05:
            out.append(0x80)
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        limit = 128 if rng is None else int(rng.integers(1, 129))
        while j < n and j - i < limit and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def pack(rows: np.ndarray, bps: int, order: str) -> bytes:
    """(R, N) sample values -> each row packed at ``bps`` bits, most
    significant first, padded to a byte; 16-bit words in ``order``."""
    rows = np.asarray(rows)
    if bps in (16, 32):
        return rows.astype(f"{order}u{bps // 8}").tobytes()
    if bps == 8:
        return rows.astype(np.uint8).tobytes()
    bits = (rows[..., None] >> np.arange(bps - 1, -1, -1)) & 1  # (R, N, bps), high bit first
    bits = bits.reshape(rows.shape[0], -1).astype(np.uint8)
    return np.packbits(bits, axis=1).tobytes()


def ycbcr_units(samples: np.ndarray, h: int, v: int) -> np.ndarray:
    """Full-size (R, W, 3) Y, Cb, Cr -> (ceil(R / v), ceil(W / h) * (h*v + 2))
    data units: h*v luma samples (edge samples repeated), then Cb and Cr."""
    rows, width = samples.shape[:2]
    by, bx = -(-rows // v), -(-width // h)
    ys = np.minimum(np.arange(by * v), rows - 1)
    xs = np.minimum(np.arange(bx * h), width - 1)
    full = samples[ys][:, xs].astype(np.int64)
    luma = full[..., 0].reshape(by, v, bx, h).transpose(0, 2, 1, 3).reshape(by, bx, h * v)
    chroma = full[::v, ::h, 1:]
    return np.concatenate([luma, chroma], 2).reshape(by, -1)


def jpeg_chunk(samples: np.ndarray, quality: int, sampling) -> bytes:
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    image = samples.astype(np.uint8)
    image = image[..., 0] if image.shape[2] == 1 else image[..., ::-1]  # cv2 takes BGR
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(image), params)
    assert ok
    return buf.tobytes()


def jpeg_segments(data: bytes) -> list:
    """(marker, whole segment) up to the start of scan, then (0xDA, the rest)."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if marker == 0xDA:
            out.append((marker, data[pos:]))
            return out
        out.append((marker, data[pos : pos + 2 + length]))
        pos += 2 + length


def abbreviate(streams: list) -> tuple:
    """Whole JPEG streams -> (JPEGTables of the first one's DQT and DHT
    segments, each stream without its tables and APPn segments)."""
    first = jpeg_segments(streams[0])
    tables = b"\xff\xd8" + b"".join(s for m, s in first if m in (0xDB, 0xC4)) + b"\xff\xd9"
    out = [b"\xff\xd8" + b"".join(s for m, s in jpeg_segments(d)
                                  if m not in (0xDB, 0xC4) and not 0xE0 <= m <= 0xEF)
           for d in streams]
    return tables, out


def _entry(tag: int, kind: int, values, order: str) -> tuple:
    if isinstance(values, (bytes, bytearray)):
        payload, count = bytes(values), len(values) // _SIZES[kind]
    elif kind == RATIONAL:
        pairs = [v if isinstance(v, tuple) else (int(round(v * 10000)), 10000) for v in values]
        payload = b"".join(struct.pack(order + "II", *p) for p in pairs)
        count = len(pairs)
    else:
        values = [int(v) if kind != FLOAT else float(v) for v in values]
        payload = struct.pack(order + _CODES[kind] * len(values), *values)
        count = len(values)
    return tag, kind, count, payload


def layout(pages: list, order: str = "<", big: bool = False) -> bytes:
    """Pages of (tags {tag: (type, values)}, chunks, offsets tag, counts tag)
    -> the file: header, every chunk, then the IFDs with their values."""
    head = (b"II" if order == "<" else b"MM")
    head += struct.pack(order + "HHHQ", 43, 8, 0, 0) if big else struct.pack(order + "HI", 42, 0)
    body = bytearray(head)
    placed = []
    for tags, chunks, offsets_tag, counts_tag in pages:
        offsets = []
        for chunk in chunks:
            offsets.append(len(body))
            body += chunk
            body += bytes(len(body) % 2)
        tags = dict(tags)
        kind = LONG8 if big else LONG
        if offsets_tag is not None:
            tags.setdefault(offsets_tag, (kind, offsets))
        if counts_tag is not None:
            tags.setdefault(counts_tag, (kind, [len(c) for c in chunks]))
        placed.append({k: v for k, v in tags.items() if v is not None})
    inline = 8 if big else 4
    ifd_offsets = []
    for tags in placed:
        entries = [_entry(tag, kind, values, order) for tag, (kind, values) in sorted(tags.items())]
        body += bytes(len(body) % 2)
        ifd_offsets.append(len(body))
        entry_size = 20 if big else 12
        table_size = (8 if big else 2) + entry_size * len(entries) + (8 if big else 4)
        extra_at = len(body) + table_size
        table, extra = bytearray(), bytearray()
        table += struct.pack(order + ("Q" if big else "H"), len(entries))
        for tag, kind, count, payload in entries:
            table += struct.pack(order + ("HHQ" if big else "HHI"), tag, kind, count)
            if len(payload) <= inline:
                table += payload + bytes(inline - len(payload))
            else:
                table += struct.pack(order + ("Q" if big else "I"), extra_at + len(extra))
                extra += payload + bytes(len(payload) % 2)
        table += bytes(8 if big else 4)  # the next IFD, patched below
        body += table + extra
    for k, at in enumerate(ifd_offsets):
        pointer = 8 if big else 4
        if k == 0:
            struct.pack_into(order + ("Q" if big else "I"), body, pointer, at)
        else:
            prev = ifd_offsets[k - 1]
            count = struct.unpack_from(order + ("Q" if big else "H"), body, prev)[0]
            next_at = prev + (8 if big else 2) + (20 if big else 12) * count
            struct.pack_into(order + ("Q" if big else "I"), body, next_at, at)
    return bytes(body)


def page(samples: np.ndarray, *, bps: int = 8, photometric: int = 2, order: str = "<",
         compression: int = 1, predictor: int = 1, fill_order: int = 1, planar: int = 1,
         rows_per_strip=None, tile=None, extra_samples=None, colormap=None, orientation=None,
         sample_format=None, subsampling=None, coefficients=None, reference=None, inkset=None,
         quality: int = 90, jpeg_sampling=None, old_lzw: bool = False, rng=None,
         tags=None) -> tuple:
    """One page's (tags, chunks, offsets tag, counts tag); see ``tiff``."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    height, width, spp = samples.shape
    sub = subsampling if photometric == 6 and compression != 7 else None
    if sub is not None and tuple(sub) == (1, 1):
        sub = None
    if tile is None:
        rows = height if rows_per_strip is None else rows_per_strip
        boxes = [(0, y, width, min(rows, height - y), width, min(rows, height - y))
                 for y in range(0, height, rows)]
    else:
        tw, tl = tile
        boxes = [(x, y, tw, tl, min(tw, width - x), min(tl, height - y))
                 for y in range(0, height, tl) for x in range(0, width, tw)]
    planes = [samples[..., [s]] for s in range(spp)] if planar == 2 else [samples]
    raws, jpeg_streams = [], []
    for plane in planes:
        for x, y, cw, ch, vw, vh in boxes:
            block = np.zeros((ch, cw, plane.shape[2]), np.int64)
            block[:vh, :vw] = plane[y : y + vh, x : x + vw]
            if vh < ch or vw < cw:  # edge tiles: repeat the edge, as encoders pad
                block[vh:, :vw] = block[vh - 1 : vh, :vw]
                block[:, vw:] = block[:, vw - 1 : vw]
            if compression == 7:
                jpeg_streams.append(jpeg_chunk(block, quality, jpeg_sampling))
                continue
            if sub is not None:
                rows_ = ycbcr_units(block, *sub)
            else:
                rows_ = block.reshape(ch, -1)
                if predictor == 2:
                    stride = block.shape[2]
                    diff = rows_.copy()
                    diff[:, stride:] = rows_[:, stride:] - rows_[:, :-stride]
                    rows_ = diff % (1 << bps)
            raws.append(pack(rows_, bps, order))
    if compression == 7:
        tables, chunks = abbreviate(jpeg_streams)
    else:
        chunks = []
        for raw in raws:
            if compression == 5:
                raw = lzw(raw, old_lzw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw, 6)
            elif compression == 32773:
                raw = packbits(raw, rng)
            chunks.append(raw)
    if fill_order == 2:
        chunks = [c.translate(REVERSED) for c in chunks]
    t = {WIDTH: (LONG, [width]), LENGTH: (LONG, [height]), BITS: (SHORT, [bps] * spp),
         COMPRESSION: (SHORT, [compression]), PHOTOMETRIC: (SHORT, [photometric]),
         SPP: (SHORT, [spp]), PLANAR: (SHORT, [planar])}
    if tile is None:
        t[ROWS_PER_STRIP] = (LONG, [height if rows_per_strip is None else rows_per_strip])
    else:
        t[TILE_WIDTH], t[TILE_LENGTH] = (LONG, [tile[0]]), (LONG, [tile[1]])
    if predictor != 1:
        t[PREDICTOR] = (SHORT, [predictor])
    if fill_order != 1:
        t[FILL_ORDER] = (SHORT, [fill_order])
    if extra_samples is not None:
        t[EXTRA_SAMPLES] = (SHORT, list(extra_samples))
    if colormap is not None:
        t[COLORMAP] = (SHORT, np.asarray(colormap).T.reshape(-1).tolist())  # R..., G..., B...
    if orientation is not None:
        t[ORIENTATION] = (SHORT, [orientation])
    if sample_format is not None:
        t[SAMPLE_FORMAT] = (SHORT, [sample_format] * spp)
    if subsampling is not None:
        t[YCBCR_SUBSAMPLING] = (SHORT, list(subsampling))
    if coefficients is not None:
        t[YCBCR_COEFFICIENTS] = (RATIONAL, list(coefficients))
    if reference is not None:
        t[REFERENCE_BW] = (RATIONAL, list(reference))
    if inkset is not None:
        t[INKSET] = (SHORT, [inkset])
    if compression == 7:
        t[JPEG_TABLES] = (UNDEFINED, tables)
    t.update(tags or {})
    if tile is None:
        return t, chunks, STRIP_OFFSETS, STRIP_COUNTS
    return t, chunks, TILE_OFFSETS, TILE_COUNTS


def tiff(samples: np.ndarray, *, order: str = "<", big: bool = False, pages: int = 1,
         **options) -> bytes:
    """A TIFF file of ``samples`` (see the module's docstring).  ``tags``
    ({tag: (type, values)}, a value of None drops the tag) adds or
    replaces entries; later pages hold the samples turned upside down."""
    first = page(samples, order=order, **options)
    more = [page(np.asarray(samples)[::-1], order=order, **options) for _ in range(pages - 1)]
    return layout([first, *more], order, big)
