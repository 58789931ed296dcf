"""JPEG 2000 still images (JP2 and raw J2K codestreams) as
``cv2.imdecode(buf, IMREAD_COLOR)`` gives them: OpenCV decodes them through
OpenJPEG and turns the components into 8-bit BGR.  The JP2 boxes and every
marker segment of the codestream are read here; ``j2k.cpp`` decodes the
packets, the code-blocks, the inverse transforms and OpenCV's step to 8
bits in one call an image, from the plan this module writes.

What OpenCV and OpenJPEG read, and so this module:

* a JP2 file (signature, ``ftyp``, ``jp2h`` with ``ihdr``, ``colr`` and
  optionally ``pclr`` + ``cmap`` and ``cdef``, then ``jp2c``) or a raw
  codestream (``FF4F FF51``);
* the marker segments SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, TLM,
  PLM, PLT, CRG and COM, and tile-parts (SOT ... SOD) of every tile, in
  order;
  COD / COC / QCD / QCC resolved as OpenJPEG resolves them (a COD or QCD
  sets every component, a COC or QCC one, a tile's first tile-part header
  overrides the main header's); a tile's POC entries follow the main
  header's, as OpenJPEG appends them; packet headers packed apart in PPT
  (a tile's, in index order) or PPM (Nppm chunks, one a tile-part in
  codestream order);
* 1 to 4 unsigned components of 8 to 16 bits, not subsampled, the image
  and its tiles at the origin; the reversible 5/3 and irreversible 9/7
  transforms, with and without the component transform; any number of
  layers and resolutions, precincts, code-blocks of 4 to 1,024 a side,
  every code-block style of Part 1 (selective arithmetic coding bypass,
  context reset, termination on each pass, vertically causal context,
  predictable termination, segmentation symbols); an ROI's max-shift
  (RGN); the five progression orders; SOP markers;
* the channels as OpenJPEG builds them: a palette applied through cmap
  (indices clamped to its last entry; a pclr without cmap ignored), then
  cdef's swaps of colour channels to their associations;
* colour as OpenCV turns it to BGR: enumerated sRGB (3 or 4 channels,
  alpha dropped), greyscale (the first channel in all three), sYCC (3
  channels through cvtColor's ``COLOR_YUV2BGR``); an ICC profile, another
  enumerated space and a raw codestream taken as sRGB (so of 3 or 4
  channels: OpenCV refuses 1 or 2); each sample shifted right by the
  largest precision past 8 (``x >> 8`` at 16 bits), a palette entry past 8
  bits cut to its low byte.

What it refuses, with a ValueError naming the file, "JPEG 2000" and the
feature, before any pixel is decoded: signed components, subsampled
components, an image offset, more than 4 components and precisions below 8
(OpenCV refuses them too) or above 16; Part 2 and HTJ2K (Rsiz bits 15 and
14, the CAP and CPF markers, code-block style bit 6); an RGN style other
than the implicit max-shift; PPM over tile-parts out of tile order, and
PPM beside PPT; EPH markers; a palette over sYCC or over components past 8 bits, and
the cmap and cdef boxes OpenJPEG refuses; the colour spaces CMYK and
e-sYCC (OpenCV refuses them too) and a colour specification method past 2;
tile-parts out of order; a marker segment, box or tile-part that runs past
the data; and a file cut short.  A tile the codestream lacks decodes as
OpenJPEG leaves it, zero in every component; the component transform over
fewer than three components is skipped, as OpenJPEG skips it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
CBLK_STYLES = ("selective arithmetic coding bypass", "context reset", "termination on each pass",
               "vertically causal context", "predictable termination",
               "segmentation symbols", "HTJ2K (high-throughput) code-blocks")
DECODED_STYLES = 63  # every style of Part 1; HTJ2K's bit 6 is refused
# Markers (the second byte): those read, those skipped and those refused
SOC, SOT, SOD, EOC = 0x4F, 0x90, 0x93, 0xD9
SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT = 0x51, 0x52, 0x53, 0x5C, 0x5D, 0x5E, 0x5F, 0x60, 0x61
SKIPPED = {0x55: "TLM", 0x57: "PLM", 0x58: "PLT", 0x63: "CRG", 0x64: "COM"}
REFUSED = {0x50: "CAP (HTJ2K capabilities)", 0x59: "CPF (HTJ2K profile)"}


def _lib():
    from viddet_tpu_torch.native import library

    return library()


class _Reader:
    """Big-endian fields of the codestream, each read checked against its end."""

    def __init__(self, data: bytes, name: str, start: int = 0, end: int | None = None):
        self.data, self.name, self.pos = data, name, start
        self.end = len(data) if end is None else end

    def error(self, what: str) -> ValueError:
        return ValueError(f"{self.name}: JPEG 2000 {what}")

    def take(self, fmt: str):
        size = struct.calcsize(">" + fmt)
        if self.pos + size > self.end:
            raise self.error("is cut short")
        values = struct.unpack_from(">" + fmt, self.data, self.pos)
        self.pos += size
        return values if len(values) > 1 else values[0]


def _boxes(data: bytes, start: int, end: int, name: str):
    """(type, payload start, payload end) of each box in data[start:end]."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise ValueError(f"{name}: JPEG 2000 box header is cut short")
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise ValueError(f"{name}: JPEG 2000 box header is cut short")
            length = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError(f"{name}: JPEG 2000 box {kind!r} runs past the end of the file "
                             f"(the file is cut short)")
        yield kind, pos + head, pos + length
        pos += length


_BOXES = {b"pclr": "palette", b"cmap": "cmap", b"cdef": "cdef"}


class _Colour:
    """What the jp2h box says of colour: the space, and OpenJPEG's palette
    (``pclr`` entries, channel precisions and signs, ``cmap``) and channel
    definition (``cdef``)."""

    def __init__(self):
        self.space = None
        self.palette = self.sizes = self.cmap = self.cdef = None


def _jp2(data: bytes, name: str) -> tuple:
    """The JP2 boxes -> (codestream start, end, _Colour, (width, height,
    components))."""
    err = lambda what: ValueError(f"{name}: JPEG 2000 {what}")
    boxes = list(_boxes(data, 0, len(data), name))
    if len(boxes) < 2 or boxes[1][0] != b"ftyp":
        raise err("file lacks its ftyp box after the signature")
    kind, start, end = boxes[1]
    brand = data[start : start + 4]
    compatible = [data[i : i + 4] for i in range(start + 8, end - 3, 4)]
    if brand != b"jp2 " and b"jp2 " not in compatible:
        raise err(f"file of brand {brand!r} (JPX and other Part 2 files are not decoded by "
                  f"the port)")
    header = codestream = None
    for kind, start, end in boxes[2:]:
        if kind == b"jp2h" and header is None:
            header = (start, end)
        elif kind == b"jp2c":
            if header is None:
                raise err("codestream comes before its jp2h box")
            codestream = (start, end)
            break
    if header is None or codestream is None:
        raise err("file lacks its jp2h or jp2c box")
    inner = list(_boxes(data, header[0], header[1], name))
    if not inner or inner[0][0] != b"ihdr" or inner[0][2] - inner[0][1] < 14:
        raise err("jp2h box lacks its ihdr box")
    height, width, components = struct.unpack_from(">IIH", data, inner[0][1])
    colour = _Colour()
    for kind, start, end in inner[1:]:
        r = _Reader(data, name, start, end)
        if kind in (b"pclr", b"cmap", b"cdef") and getattr(colour, _BOXES[kind]) is not None:
            raise r.error(f"jp2h box holds a second {kind.decode()} box")
        if kind == b"pclr":  # opj_jp2_read_pclr
            entries, channels = r.take("HB")
            if not 1 <= entries <= 1024 or not channels:
                raise r.error(f"palette of {entries} entries and {channels} channels")
            colour.sizes = [((b & 0x7F) + 1, b >> 7)
                            for b in (r.take("B") for _ in range(channels))]
            colour.palette = np.zeros((entries, channels), np.int64)
            for e in range(entries):
                for c, (bits, _) in enumerate(colour.sizes):
                    size = (bits + 7) >> 3
                    if size > 4:
                        raise r.error(f"palette channel of {bits} bits")
                    v = int.from_bytes(r.take(f"{size}s"), "big")
                    colour.palette[e, c] = v - (1 << 32) if v >> 31 else v  # OPJ_INT32
        elif kind == b"cmap":  # opj_jp2_read_cmap
            if colour.palette is None:
                raise r.error("cmap box before its pclr box")
            colour.cmap = [r.take("HBB") for _ in range(colour.palette.shape[1])]
        elif kind == b"cdef":  # opj_jp2_read_cdef
            n = r.take("H")
            if not n:
                raise r.error("cdef box of no channel")
            colour.cdef = [list(r.take("HHH")) for _ in range(n)]
        elif kind == b"colr" and colour.space is None:
            colour.space = _colour(data, start, end, err)
    if colour.space is None:
        raise err("jp2h box lacks its colr box")
    return codestream[0], codestream[1], colour, (width, height, components)


def _colour(data: bytes, start: int, end: int, err) -> str:
    """The first colr box as OpenJPEG maps it and OpenCV converts it: sRGB,
    grey and sYCC by name, an ICC profile or any other enumerated space
    as "unknown", which OpenCV takes as sRGB; CMYK and e-sYCC OpenCV
    refuses."""
    if end - start < 3:
        raise err("colr box is cut short")
    method = data[start]
    if method == 2:
        return "sRGB"
    if method != 1:
        raise err(f"colour specification method {method} is not decoded by the port")
    if end - start < 7:
        raise err("colr box is cut short")
    enumcs = struct.unpack_from(">I", data, start + 3)[0]
    if enumcs in (12, 24):
        raise err(f"colour space {'CMYK' if enumcs == 12 else 'e-sYCC'} (OpenCV refuses it)")
    return {17: "grey", 18: "sYCC"}.get(enumcs, "sRGB")


def _channels(colour: _Colour, ncomp: int, err) -> list:
    """The channels OpenJPEG hands OpenCV, in order: ("comp", c) a
    component as decoded, ("palette", c, k) column k of the palette looked
    up by component c.  opj_jp2_check_color's checks, then
    opj_jp2_apply_pclr and opj_jp2_apply_cdef."""
    channels = [("comp", c) for c in range(ncomp)]
    if colour.palette is not None and colour.cmap is not None:
        n = len(colour.cmap)
        used = [False] * n
        for i, (cmp, mtyp, pcol) in enumerate(colour.cmap):
            if cmp >= ncomp:
                raise err(f"cmap names component {cmp} of {ncomp}")
            if mtyp not in (0, 1) or pcol >= n or (used[pcol] and mtyp == 1) \
                    or (mtyp == 0 and pcol) or (mtyp == 1 and pcol != i):
                raise err(f"cmap entry {i} ({cmp}, {mtyp}, {pcol}) that OpenJPEG refuses")
            used[pcol] = True
        if any(not used[i] and colour.cmap[i][1] for i in range(n)):
            raise err("cmap leaves a palette column unmapped")
        if ncomp == 1 and not all(used):  # OpenJPEG's "Trying to correct"
            colour.cmap = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(colour.cmap)]
        channels = [("comp", cmp) if mtyp == 0 else ("palette", cmp, pcol)
                    for cmp, mtyp, pcol in colour.cmap]
    if colour.cdef is not None:
        n, info = len(channels), colour.cdef
        for cn, _, asoc in info:
            if cn >= n or (asoc not in (0, 65535) and asoc - 1 >= n):
                raise err(f"cdef names channel {max(cn, asoc - 1)} of {n}")
        if any(all(cn != k for cn, _, _ in info) for k in range(n)):
            raise err("cdef does not define every channel")
        for i, (cn, kind, asoc) in enumerate(info):
            if asoc in (0, 65535) or kind != 0 or cn == asoc - 1:
                continue
            acn = asoc - 1
            channels[cn], channels[acn] = channels[acn], channels[cn]
            for later in info[i + 1 :]:  # later entries follow the swap
                later[0] = acn if later[0] == cn else cn if later[0] == acn else later[0]
    return channels


class _Codestream:
    """The main header, and each tile-part's header and data, as OpenJPEG
    reads them; ``plan`` is what ``j2k.cpp`` takes."""

    def __init__(self, data: bytes, start: int, end: int, name: str):
        from viddet_tpu_torch.native import _check_size

        self.name = name
        r = _Reader(data, name, start, end)
        if r.take("H") != 0xFF4F:
            raise r.error("codestream does not start with SOC")
        if r.take("H") != 0xFF51:
            raise r.error("codestream lacks its SIZ marker after SOC")
        seg = self._segment(r)
        (rsiz, xsiz, ysiz, xo, yo, self.tile_w, self.tile_h, xto, yto,
         ncomp) = seg.take("HIIIIIIIIH")
        if rsiz & 0x8000:
            raise r.error("Part 2 codestream (Rsiz bit 15) is not decoded by the port")
        if rsiz & 0x4000:
            raise r.error("HTJ2K codestream (Rsiz bit 14) is not decoded by the port")
        if xo or yo or xto or yto:
            raise r.error(f"image offset ({xo}, {yo}) and tile offset ({xto}, {yto}): OpenCV "
                          f"reads images at the origin only")
        if not 1 <= ncomp <= 4:
            raise r.error(f"of {ncomp} components (OpenCV reads 1 to 4)")
        self.width, self.height = xsiz - xo, ysiz - yo
        if self.width <= 0 or self.height <= 0 or self.tile_w <= 0 or self.tile_h <= 0:
            raise r.error(f"image of {self.width}x{self.height} in tiles of "
                          f"{self.tile_w}x{self.tile_h}")
        _check_size(name, self.width, self.height)
        self.prec = []
        for c in range(ncomp):
            ssiz, dx, dy = seg.take("BBB")
            if ssiz & 0x80:
                raise r.error(f"component {c} is signed (OpenCV refuses signed components)")
            if dx != 1 or dy != 1:
                raise r.error(f"component {c} is subsampled {dx}x{dy} (OpenCV refuses "
                              f"subsampled components)")
            prec = (ssiz & 0x7F) + 1
            if not 8 <= prec <= 16:
                raise r.error(f"component {c} of {prec} bits is not decoded by the port")
            self.prec.append(prec)
        self.ncomp = ncomp
        self.tiles_x = -(-self.width // self.tile_w)
        self.tiles_y = -(-self.height // self.tile_h)
        if self.tiles_x * self.tiles_y > 65535:
            raise r.error(f"of {self.tiles_x * self.tiles_y} tiles")
        self.main = {"comps": [{} for _ in range(ncomp)]}
        self.ppm, self.order = [], []  # PPM segments (Zppm, start, length); tile-parts' tiles
        while True:
            marker = r.take("H")
            if marker == 0xFF00 | SOT:
                break
            if marker == 0xFF00 | EOC:
                raise r.error("codestream holds no tile")
            self._marker(marker, self._segment(r), self.main)
        self.tiles = {}
        self._tile_parts(data, r, marker)

    def _segment(self, r: _Reader) -> _Reader:
        length = r.take("H")
        if length < 2 or r.pos + length - 2 > r.end:
            raise r.error("marker segment runs past the end of the codestream")
        seg = _Reader(r.data, r.name, r.pos, r.pos + length - 2)
        r.pos += length - 2
        return seg

    def _marker(self, marker: int, seg: _Reader, params: dict) -> None:
        """One main or tile-part header marker into ``params``."""
        m = marker & 0xFF
        if marker >> 8 != 0xFF:
            raise seg.error(f"marker {marker:#06x} is not a marker")
        if m in SKIPPED:
            return
        if m in REFUSED:
            raise seg.error(f"marker {REFUSED[m]} is not decoded by the port")
        comps = params["comps"]
        if m == COD:
            scod, progression, layers, mct = seg.take("BBHB")
            if scod & ~7:
                raise seg.error(f"COD coding style {scod:#x} is not decoded by the port")
            if scod & 4:
                raise seg.error("EPH markers are not decoded by the port")
            if progression > 4:
                raise seg.error(f"progression order {progression}")
            if not layers:
                raise seg.error("of 0 layers")
            if mct > 1:
                raise seg.error(f"multiple component transform {mct} (Part 2) is not decoded "
                                f"by the port")
            params.update(sop=bool(scod & 2), progression=progression, layers=layers, mct=mct)
            coding = self._coding(seg, scod & 1)
            for c in comps:  # opj_j2k_copy_tile_component_parameters
                c.update(coding)
        elif m == COC:
            c = seg.take("H" if self.ncomp >= 257 else "B")
            if c >= self.ncomp:
                raise seg.error(f"COC of component {c}")
            scoc = seg.take("B")
            comps[c].update(self._coding(seg, scoc & 1))
        elif m in (QCD, QCC):
            c = None
            if m == QCC:
                c = seg.take("H" if self.ncomp >= 257 else "B")
                if c >= self.ncomp:
                    raise seg.error(f"QCC of component {c}")
            quant = self._quantisation(seg)
            for k in range(self.ncomp) if c is None else [c]:  # QCD: every component
                comps[k].update(quant)
        elif m == RGN:  # opj_j2k_read_rgn: an implicit ROI, its max-shift
            c = seg.take("H" if self.ncomp >= 257 else "B")
            kind, shift = seg.take("BB")
            if c >= self.ncomp:
                raise seg.error(f"RGN of component {c}")
            if kind != 0:
                raise seg.error(f"RGN style {kind} is not decoded by the port")
            comps[c]["roishift"] = shift
        elif m in (PPM, PPT):  # packed packet headers: (index, start, length) a segment
            if (m == PPM) != (params is self.main):
                raise seg.error(f"{'PPM' if m == PPM else 'PPT'} marker out of place")
            z = seg.take("B")
            if m == PPM:
                self.ppm.append((z, seg.pos, seg.end - seg.pos))
            else:
                params["ppt"] = params.get("ppt", []) + [(z, seg.pos, seg.end - seg.pos)]
        elif m == POC:  # opj_j2k_read_poc: appended to what the main header gave
            room = 2 if self.ncomp >= 257 else 1
            entry = f"B{'H' if room == 2 else 'B'}HB{'H' if room == 2 else 'B'}B"
            count = (seg.end - seg.pos) // (5 + 2 * room)
            if not count or (seg.end - seg.pos) % (5 + 2 * room):
                raise seg.error("POC marker of a bad length")
            for _ in range(count):
                r0, c0, l1, r1, c1, prog = seg.take(entry)
                if prog > 4:
                    raise seg.error(f"POC progression order {prog}")
                params["pocs"] = params.get("pocs", []) + [
                    (r0, c0, min(l1, params.get("layers", l1)), r1, min(c1, self.ncomp), prog)]
        elif m in (SOT, SOD, EOC, SOC, SIZ):
            raise seg.error(f"marker {marker:#06x} out of place")
        else:
            raise seg.error(f"marker {marker:#06x} is not decoded by the port")

    def _coding(self, seg: _Reader, precincts: int) -> dict:
        levels, xcb, ycb, style, transform = seg.take("BBBBB")
        if levels > 32:
            raise seg.error(f"of {levels} decomposition levels")
        if xcb > 8 or ycb > 8 or xcb + ycb > 8:
            raise seg.error(f"code-blocks of 2^{xcb + 2}x2^{ycb + 2}")
        if style & ~DECODED_STYLES:
            names = [n for b, n in enumerate(CBLK_STYLES)
                     if (style & ~DECODED_STYLES) >> b & 1] or [f"{style:#x}"]
            raise seg.error(f"code-block style {', '.join(names)} is not decoded by the port")
        if transform > 1:
            raise seg.error(f"wavelet transform {transform} (Part 2) is not decoded by the "
                            f"port")
        sizes = [(15, 15)] * (levels + 1)
        if precincts:
            sizes = [(b & 15, b >> 4) for b in (seg.take("B") for _ in range(levels + 1))]
            if any(min(s) == 0 for s in sizes[1:]):
                raise seg.error("precinct of 2^0 above the lowest resolution")
        return {"numres": levels + 1, "cblk": (xcb + 2, ycb + 2), "qmfbid": transform,
                "style": style, "precincts": sizes}

    def _quantisation(self, seg: _Reader) -> dict:
        sq = seg.take("B")
        style, guard = sq & 0x1F, sq >> 5
        left = seg.end - seg.pos
        if style == 0:
            steps = [(b >> 3, 0) for b in seg.data[seg.pos : seg.end]]
        elif style in (1, 2):
            words = [seg.take("H") for _ in range(1 if style == 1 else left // 2)]
            steps = [(w >> 11, w & 0x7FF) for w in words]
            if style == 1:  # scalar derived: opj_j2k_read_SQcd_SQcc
                e0, m0 = steps[0]
                steps = [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, 97)]
        else:
            raise seg.error(f"quantisation style {style} is not decoded by the port")
        if not steps:
            raise seg.error("quantisation of no band")
        return {"guard": guard, "steps": steps[:97]}

    def _tile_parts(self, data: bytes, r: _Reader, marker: int) -> None:
        while marker == 0xFF00 | SOT:
            at = r.pos - 2
            seg = self._segment(r)
            index, psot, part, _ = seg.take("HIBB")
            if index >= self.tiles_x * self.tiles_y:
                raise r.error(f"tile-part of tile {index} of {self.tiles_x * self.tiles_y}")
            if index not in self.tiles:
                if part != 0:
                    raise r.error(f"tile {index} starts at its tile-part {part}")
                params = {k: v for k, v in self.main.items() if k != "comps"}
                params["comps"] = [dict(c) for c in self.main["comps"]]
                self.tiles[index] = {"params": params, "ranges": [], "parts": 0}
            tile = self.tiles[index]
            if part != tile["parts"]:
                raise r.error(f"tile {index}'s tile-part {part} out of order")
            end = r.end if psot == 0 else at + psot
            if psot and (psot < 14 or end > r.end):
                raise r.error(f"tile-part of tile {index} runs past the end of the codestream "
                              f"(the file is cut short)")
            while True:
                marker = r.take("H")
                if marker == 0xFF00 | SOD:
                    break
                m = marker & 0xFF
                if part and m in (COD, COC, QCD, QCC):
                    raise r.error(f"marker {marker:#06x} after the first tile-part of tile "
                                  f"{index} is not decoded by the port")
                self._marker(marker, self._segment(r), tile["params"])
            if r.pos > end:
                raise r.error(f"tile-part header of tile {index} runs past its tile-part")
            if psot == 0:  # to the end of the codestream, its EOC excluded
                end = r.end - 2 if data[r.end - 2 : r.end] == b"\xff\xd9" else r.end
            tile["ranges"].append((r.pos, end - r.pos))
            tile["parts"] += 1
            self.order.append(index)
            r.pos = end
            if r.pos + 2 > r.end:
                raise r.error("codestream ends without its EOC marker (the file is cut short)")
            marker = r.take("H")
        if marker != 0xFF00 | EOC:
            raise r.error(f"marker {marker:#06x} where SOT or EOC belongs")
        for tile in self.tiles.values():
            if "ppt" in tile["params"]:
                if self.ppm:
                    raise r.error("codestream holds both PPM and PPT markers")
                tile["headers"] = _ordered_ranges(tile["params"]["ppt"], r.error)
        if self.ppm:
            self._assign_ppm(data, r.error)

    def _assign_ppm(self, data: bytes, err) -> None:
        """PPM's Nppm-prefixed header chunks, in Zppm order, to the tile-parts
        in codestream order (OpenJPEG reads them from one buffer, tile by
        tile, so the tile-parts must come tile by tile, in index order)."""
        if self.order != sorted(self.order):
            raise err("PPM over tile-parts out of tile order is not decoded by the port")
        ranges = _ordered_ranges(self.ppm, err)
        stream = b"".join(data[a : a + n] for a, n in ranges)
        starts = np.cumsum([0] + [n for _, n in ranges])

        def real(a: int, b: int) -> list:  # the stream's bytes [a, b) in the file
            out = []
            for (off, n), s0 in zip(ranges, starts):
                lo, hi = max(a, s0), min(b, s0 + n)
                if lo < hi:
                    out.append((off + lo - s0, hi - lo))
            return out

        pos = 0
        for index in self.order:
            if pos + 4 > len(stream):
                raise err("PPM holds fewer packet header chunks than the codestream's tile-parts")
            n = struct.unpack_from(">I", stream, pos)[0]
            if pos + 4 + n > len(stream):
                raise err("PPM packet header chunk runs past its marker segments")
            self.tiles[index].setdefault("headers", []).extend(real(pos + 4, pos + 4 + n))
            pos += 4 + n

    def plan(self) -> np.ndarray:
        out = [self.ncomp, self.width, self.height, self.tile_w, self.tile_h, self.tiles_x,
               self.tiles_y, len(self.tiles), *self.prec]
        for index in sorted(self.tiles):
            tile = self.tiles[index]
            p = tile["params"]
            if "layers" not in p:
                raise ValueError(f"{self.name}: JPEG 2000 codestream lacks its COD marker")
            out += [index, p["progression"], p["layers"], p["mct"], 2 if p["sop"] else 0,
                    len(tile["ranges"])]
            for offset, length in tile["ranges"]:
                out += [offset, length]
            headers = tile.get("headers")
            out += [int(headers is not None), len(headers or ())]
            for offset, length in headers or ():
                out += [offset, length]
            pocs = p.get("pocs", [])
            if len(pocs) > 255:
                raise ValueError(f"{self.name}: JPEG 2000 tile {index} of {len(pocs)} progression "
                                 f"changes")
            out.append(len(pocs))
            for entry in pocs:
                out += entry
            for c, comp in enumerate(p["comps"]):
                if "steps" not in comp:
                    raise ValueError(f"{self.name}: JPEG 2000 component {c} lacks its "
                                     f"quantisation (QCD)")
                bands = 3 * comp["numres"] - 2
                if len(comp["steps"]) < bands:
                    raise ValueError(f"{self.name}: JPEG 2000 quantisation of "
                                     f"{len(comp['steps'])} bands where {bands} are coded")
                out += [comp["numres"], *comp["cblk"], comp["qmfbid"], comp["guard"],
                        comp["style"], comp.get("roishift", 0)]
                for ppx, ppy in comp["precincts"]:
                    out += [ppx, ppy]
                for expn, mant in comp["steps"][:bands]:
                    out += [expn, mant]
        return np.asarray(out, np.int32)


def _ordered_ranges(segments: list, err) -> list:
    """(start, length) of PPM or PPT segments' data in their index order
    (opj_j2k_merge_ppm / _ppt); an index given twice is refused."""
    indices = [z for z, _, _ in segments]
    if len(set(indices)) != len(indices):
        raise err("packed packet header segment index given twice")
    return [(start, length) for _, start, length in sorted(segments)]


def decode_jpeg2000(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JP2 or J2K bytes -> (H, W, 3) uint8 RGB as ``cv2.imdecode``
    (IMREAD_COLOR) and a BGR-to-RGB swap give it.  Raises ValueError for
    what the port does not read and for a truncated or corrupt file."""
    from viddet_tpu_torch.native import _ERR_LEN, _message

    err = lambda what: ValueError(f"{name}: JPEG 2000 {what}")
    if data[:12] == JP2_SIGNATURE:
        start, end, colour, (width, height, components) = _jp2(data, name)
    elif data[:4] == J2K_SIGNATURE:
        start, end, colour, components = 0, len(data), _Colour(), None
        colour.space = "sRGB"
    else:
        raise ValueError(f"{name}: not a JPEG 2000 file (JP2 or J2K codestream)")
    cs = _Codestream(data, start, end, name)
    if components is not None and (components, width, height) != (cs.ncomp, cs.width,
                                                                   cs.height):
        raise err(f"ihdr box ({width}x{height}, {components} components) disagrees with the "
                  f"codestream's SIZ")
    channels = _channels(colour, cs.ncomp, err)
    space, n = colour.space, len(channels)
    if space != "grey" and n != (3 if space == "sYCC" else 3 + (n == 4)):
        raise err(f"{space} of {n} channels (OpenCV refuses it"
                  f"{'' if components else '; a raw codestream is taken as sRGB'})")
    wanted = channels[:1] * 3 if space == "grey" else channels[:3]  # OpenCV's R, G, B
    palette = any(ch[0] == "palette" for ch in wanted)
    if palette and (space == "sYCC" or max(cs.prec) != 8):
        raise err(f"palette over {space} or {max(cs.prec)}-bit components is not decoded by "
                  f"the port")
    # with a palette, the index components themselves (8 bits, so shifted by 0)
    rgb = [ch[1] for ch in wanted]
    plan = cs.plan()
    out = np.empty((cs.height, cs.width, 3), np.uint8)
    message = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().vd_j2k_decode(data, len(data), plan.ctypes.data, len(plan),
                            (ctypes.c_int * 3)(*rgb), max(cs.prec) - 8, int(space == "sYCC"),
                            out.ctypes.data, message, _ERR_LEN):
        raise ValueError(f"{name}: {_message(message)}")
    if palette:  # opj_jp2_apply_pclr; OpenCV keeps the low byte of an entry past 8 bits
        top = len(colour.palette) - 1
        for k, ch in enumerate(wanted):
            if ch[0] == "palette":
                out[..., k] = colour.palette[np.minimum(out[..., k], top), ch[2]] & 255
    return out
