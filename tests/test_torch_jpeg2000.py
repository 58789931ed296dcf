"""JPEG 2000 stills (JP2 and raw J2K codestreams) as ``cv2.imdecode`` reads
them through OpenJPEG, through the port's ``data.base.decode_rgb``, against
the JAX package's decode (cv2), bit for bit.

The files come from seeded content through PIL (OpenJPEG's encoder: every
option it offers), through ``cv2.imencode`` at several
``IMWRITE_JPEG2000_COMPRESSION_X1000`` values, through OpenJPEG's encoder
driven by ``ctypes`` (``opj_encode``: the code-block styles and the ROI
that PIL does not pass on), and through a small
codestream editor below (``parse`` / ``build``) that changes what needs no
re-encoding: comments, TLM, PLM, CRG, tile-parts split at the packet
boundaries PLT gives, SOP markers, coding and quantisation moved into tile
headers, the colour box and the precision.  Where OpenJPEG's own output is the question
(the 9/7 transform), PIL's decode, a later OpenJPEG, is held to cv2's too.
What the port refuses raises ValueError naming the file, "JPEG 2000" and
the feature, whether cv2 reads the file or not.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.test_torch_image_formats import (  # noqa: F401 (detect_weights: a fixture)
    _detect_both, cv2_rgb, detect_weights, photo,
)
from viddet_tpu_torch.data.base import decode_rgb


def rng_for(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(("jpeg2000",) + key).encode()))


def assert_equals_cv2(data: bytes, what: str) -> np.ndarray:
    want = cv2_rgb(data)
    assert want is not None, f"{what}: cv2 refuses the file"
    got = decode_rgb(data, what)
    assert got.dtype == np.uint8 and got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)
    return got


def pil_jp2(image: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG2000", **options)
    return buf.getvalue()


def cv2_jp2(rgb: np.ndarray, x1000: int) -> bytes:
    image = rgb[..., ::-1] if rgb.ndim == 3 and rgb.shape[2] >= 3 else rgb
    if image.ndim == 3 and image.shape[2] == 4:
        image = rgb[..., [2, 1, 0, 3]]
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(image),
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
    assert ok
    return buf.tobytes()


# ---------------------------------------------------------------------------
# a codestream editor


def split_jp2(data: bytes) -> tuple:
    """(the bytes before the jp2c box, the codestream, the bytes after); a
    raw codestream gives (b"", data, b"")."""
    if data[:2] == b"\xff\x4f":
        return b"", data, b""
    pos = 0
    while pos < len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = len(data) if length == 0 else pos + length
        if kind == b"jp2c":
            return data[:pos], data[pos + 8 : end], data[end:]
        pos = end
    raise ValueError("no jp2c box")


def join_jp2(before: bytes, codestream: bytes, after: bytes) -> bytes:
    if not before:
        return codestream
    return before + struct.pack(">I4s", 8 + len(codestream), b"jp2c") + codestream + after


def parse(cs: bytes) -> tuple:
    """A codestream -> (main header [(marker, payload)], tile-parts [{index,
    part, parts, segments, data}]) of its SIZ ... SOT ... EOC."""
    pos, main = 2, []
    while struct.unpack_from(">H", cs, pos)[0] != 0xFF90:
        marker, length = struct.unpack_from(">HH", cs, pos)
        main.append((marker, cs[pos + 4 : pos + 2 + length]))
        pos += 2 + length
    parts = []
    while struct.unpack_from(">H", cs, pos)[0] == 0xFF90:
        start = pos
        index, psot, part, count = struct.unpack_from(">HIBB", cs, pos + 4)
        pos += 12
        segments = []
        while struct.unpack_from(">H", cs, pos)[0] != 0xFF93:
            marker, length = struct.unpack_from(">HH", cs, pos)
            segments.append((marker, cs[pos + 4 : pos + 2 + length]))
            pos += 2 + length
        end = start + psot if psot else len(cs) - 2
        parts.append({"index": index, "part": part, "parts": count, "segments": segments,
                      "data": cs[pos + 2 : end]})
        pos = end
    return main, parts


def build(main: list, parts: list, eoc: bool = True) -> bytes:
    out = bytearray(b"\xff\x4f")
    for marker, payload in main:
        out += struct.pack(">HH", marker, len(payload) + 2) + payload
    for tp in parts:
        head = b"".join(struct.pack(">HH", m, len(p) + 2) + p for m, p in tp["segments"])
        psot = 14 + len(head) + len(tp["data"])
        out += struct.pack(">HHHIBB", 0xFF90, 10, tp["index"], psot, tp["part"], tp["parts"])
        out += head + b"\xff\x93" + tp["data"]
    return bytes(out + (b"\xff\xd9" if eoc else b""))


def edit(data: bytes, change) -> bytes:
    """``change(main, parts) -> (main, parts)`` applied to a file's codestream."""
    before, cs, after = split_jp2(data)
    return join_jp2(before, build(*change(*parse(cs))), after)


def plt_lengths(payload: bytes) -> list:
    """The packet lengths of a PLT segment (after its index)."""
    out, value = [], 0
    for b in payload[1:]:
        value = value << 7 | (b & 0x7F)
        if not b & 0x80:
            out.append(value)
            value = 0
    return out


def segment(main: list, marker: int) -> bytes:
    return next(p for m, p in main if m == marker)


def replace(main: list, marker: int, payload: bytes) -> list:
    return [(m, payload if m == marker else p) for m, p in main]


def jp2_file(codestream: bytes, width: int, height: int, components: int, colr: bytes,
             extra: bytes = b"") -> bytes:
    """A JP2 around a codestream: signature, ftyp, jp2h (ihdr, colr, extra
    boxes), jp2c."""
    box = lambda kind, payload: struct.pack(">I4s", 8 + len(payload), kind) + payload
    ihdr = struct.pack(">IIHBBBB", height, width, components, 7, 7, 0, 0)
    return (b"\0\0\0\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", colr) + extra)
            + box(b"jp2c", codestream))


# ---------------------------------------------------------------------------
# PIL's and cv2's files

OPTIONS = {
    "default": {}, "layers_rates": {"quality_mode": "rates", "quality_layers": [40, 10, 1]},
    "layers_db": {"quality_mode": "dB", "quality_layers": [30, 40, 50]},
    "tiles_32": {"tile_size": (32, 32)}, "tiles_64x48_r4": {"tile_size": (64, 48),
                                                             "num_resolutions": 4},
    "cblk_16": {"codeblock_size": (16, 16)}, "cblk_64x16": {"codeblock_size": (64, 16)},
    "cblk_4": {"codeblock_size": (4, 4)}, "precincts_64": {"precinct_size": (64, 64)},
    "precincts_32_cblk_16": {"precinct_size": (32, 32), "codeblock_size": (16, 16)},
    "no_mct": {"mct": 0}, "plt": {"plt": True}, "j2k": {"no_jp2": True},
    **{f"progression_{p}": {"progression": p} for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"all_{p}": {"progression": p, "precinct_size": (32, 32), "tile_size": (64, 64),
                    "quality_mode": "rates", "quality_layers": [30, 10, 1],
                    "codeblock_size": (16, 16)}
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
@pytest.mark.parametrize("transform", ["5-3", "9-7"])
def test_pil_options(transform, case):
    """Every option of PIL's writer, reversible and irreversible; the 9/7
    files are held to PIL's decode as well."""
    rng = rng_for("options", transform, case)
    data = pil_jp2(photo(rng, 110, 130), irreversible=transform == "9-7", **OPTIONS[case])
    got = assert_equals_cv2(data, f"{transform} {case}")
    if transform == "9-7":
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
                                      got)


@pytest.mark.parametrize("size", [(61, 77), (33, 100), (1, 5), (7, 2)], ids=str)
@pytest.mark.parametrize("resolutions", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("transform", ["5-3", "9-7"])
def test_resolutions_and_odd_sizes(transform, resolutions, size):
    """1-6 resolutions (as many as the size allows) at odd sizes, one and two
    samples wide included."""
    h, w = size
    resolutions = min(resolutions, 1 + int(np.log2(min(h, w))))
    rng = rng_for("resolutions", transform, resolutions, size)
    data = pil_jp2(photo(rng, h, w), irreversible=transform == "9-7",
                   num_resolutions=resolutions)
    assert_equals_cv2(data, f"{transform} r{resolutions} {size}")


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("tiles", [None, (48, 40)], ids=["one_tile", "tiles"])
@pytest.mark.parametrize("rate", [4, 20, 80])
def test_irreversible_at_rates_tiles_and_layers(rate, tiles, layers):
    """The 9/7 at several compression rates, one or three layers, one tile
    or tiles of odd placement: cv2's OpenJPEG and PIL's agree with the
    port's scalar float32 lifting."""
    rng = rng_for("rates", rate, tiles, layers)
    rates = [rate * 4, rate * 2, rate][3 - layers :]
    data = pil_jp2(photo(rng, 101, 131), irreversible=True, quality_mode="rates",
                   quality_layers=rates, tile_size=tiles, num_resolutions=4 if tiles else 6)
    got = assert_equals_cv2(data, f"rate {rate} {tiles} {layers}")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), got)


@pytest.mark.parametrize("x1000", [1000, 900, 500, 100, 10])
def test_cv2_files(x1000):
    """cv2's own writer: lossless at 1000, the 9/7 below."""
    rng = rng_for("cv2", x1000)
    assert_equals_cv2(cv2_jp2(photo(rng, 97, 131), x1000), f"cv2 {x1000}")


@pytest.mark.parametrize("case", ["grey", "grey16", "rgb16", "bgra", "grey16_lossy"])
def test_cv2_grey_16_bits_and_alpha(case):
    """Grey in all three channels; 16 bits as x >> 8; alpha dropped."""
    rng = rng_for("cv2 kinds", case)
    if case == "grey":
        image = photo(rng, 130, 131)[..., 0]
    elif case == "bgra":
        image = photo(rng, 64, 80, 4)
    else:
        image = rng.integers(0, 65536, (140, 150)).astype(np.uint16)
        if case == "rgb16":
            image = np.stack([image, image[::-1], image[:, ::-1]], -1)
    assert_equals_cv2(cv2_jp2(image, 300 if case == "grey16_lossy" else 1000), case)


@pytest.mark.parametrize("case", ["rgba", "rgba_j2k", "grey", "la", "grey16"])
def test_pil_components(case):
    """PIL's RGBA (alpha dropped), grey and LA (the first component) and
    16-bit grey."""
    rng = rng_for("pil components", case)
    if case == "grey16":
        image = Image.fromarray(rng.integers(0, 65536, (70, 90)).astype(np.uint16))
    elif case.startswith("rgba"):
        image = Image.fromarray(photo(rng, 60, 70, 4))
    else:
        image = Image.fromarray(photo(rng, 60, 70)[..., 0]).convert("LA" if case == "la" else "L")
    buf = io.BytesIO()
    image.save(buf, "JPEG2000", no_jp2=case == "rgba_j2k")
    assert_equals_cv2(buf.getvalue(), case)


# ---------------------------------------------------------------------------
# edited codestreams


def _split_parts(main, parts):
    """Each tile in three tile-parts, cut at packet boundaries PLT gives."""
    out = []
    for p in parts:
        lengths = [n for m, s in p["segments"] if m == 0xFF58 for n in plt_lengths(s)]
        assert sum(lengths) == len(p["data"])
        cuts = [0, sum(lengths[: len(lengths) // 3]), sum(lengths[: 2 * len(lengths) // 3]),
                len(p["data"])]
        for k in range(3):
            segments = p["segments"] if k == 0 else []
            out.append({"index": p["index"], "part": k, "parts": 3, "segments": segments,
                        "data": p["data"][cuts[k] : cuts[k + 1]]})
    return main, out


def _with_sop(main, parts):
    """An SOP marker before every packet, and COD's Scod bit 1."""
    out = []
    for p in parts:
        lengths = [n for m, s in p["segments"] if m == 0xFF58 for n in plt_lengths(s)]
        at, data = 0, bytearray()
        for i, n in enumerate(lengths):
            data += struct.pack(">HHH", 0xFF91, 4, i) + p["data"][at : at + n]
            at += n
        out.append(dict(p, segments=[s for s in p["segments"] if s[0] != 0xFF58], data=bytes(data)))
    cod = segment(main, 0xFF52)
    return replace(main, 0xFF52, bytes([cod[0] | 2]) + cod[1:]), out


def _tlm(main, parts):
    entries = b"".join(struct.pack(">BI", p["index"], 14 + sum(4 + len(s) for _, s in p["segments"])
                                   + len(p["data"])) for p in parts)
    return main + [(0xFF55, bytes([0, 0x50]) + entries)], parts


def _plm(main, parts):
    """The tile-parts' PLT segments moved into one PLM in the main header."""
    body = bytearray([0])
    for p in parts:
        lengths = b"".join(s[1:] for m, s in p["segments"] if m == 0xFF58)
        assert len(lengths) < 256
        body += bytes([len(lengths)]) + lengths
    return main + [(0xFF57, bytes(body))], [
        dict(p, segments=[s for s in p["segments"] if s[0] != 0xFF58]) for p in parts]


def _tile_qcd(main, parts):
    """Each tile's first tile-part holds the QCD; the main header's is wrong."""
    qcd = segment(main, 0xFF5C)
    wrong = bytes([qcd[0]]) + bytes((b + 8) & 0xFF for b in qcd[1:])
    return replace(main, 0xFF5C, wrong), [dict(p, segments=[(0xFF5C, qcd)] + p["segments"])
                                          for p in parts]


def _tile_cod(main, parts):
    """Each tile's COD holds the true progression; the main header's another."""
    cod = segment(main, 0xFF52)
    other = bytes([cod[0], (cod[1] + 2) % 5]) + cod[2:]
    return replace(main, 0xFF52, other), [dict(p, segments=[(0xFF52, cod)] + p["segments"])
                                          for p in parts]


def _coc_qcc(main, parts):
    """COC and QCC for component 1, equal to COD and QCD."""
    cod, qcd = segment(main, 0xFF52), segment(main, 0xFF5C)
    return main + [(0xFF53, bytes([1, cod[0] & 1]) + cod[5:]), (0xFF5D, bytes([1]) + qcd)], parts


EDITS = {
    "comments": lambda m, p: (m + [(0xFF64, b"\0\1main")],
                              [dict(t, segments=t["segments"] + [(0xFF64, b"\0\1tile")])
                               for t in p]),
    "tile_parts": _split_parts,
    "tile_parts_unnumbered": lambda m, p: (m, [dict(t, parts=0) for t in _split_parts(m, p)[1]]),
    "tile_parts_interleaved": lambda m, p: (m, sorted(_split_parts(m, p)[1],
                                                      key=lambda t: (t["part"], t["index"]))),
    "tlm": lambda m, p: _tlm(*_split_parts(m, p)),
    "plm": _plm,
    "crg": lambda m, p: (m + [(0xFF63, bytes(4 * 3))], p),
    "sop": _with_sop,
    "qcd_in_tiles": _tile_qcd,
    "cod_in_tiles": _tile_cod,
    "coc_qcc": _coc_qcc,
    "precision_9": lambda m, p: (_precision(m, 9), p),
    "precision_12": lambda m, p: (_precision(m, 12), p),
}


def _precision(main, bits):
    siz = bytearray(segment(main, 0xFF51))
    for c in range(siz[35]):
        siz[36 + 3 * c] = bits - 1
    return replace(main, 0xFF51, bytes(siz))


@pytest.mark.parametrize("transform", ["5-3", "9-7"])
@pytest.mark.parametrize("case", sorted(EDITS))
def test_edited_codestreams(case, transform):
    """Edits that need no re-encoding; cv2 reads each."""
    rng = rng_for("edit", case, transform)
    data = pil_jp2(photo(rng, 90, 110), irreversible=transform == "9-7", plt=True,
                   tile_size=(64, 64), quality_mode="rates", quality_layers=[20, 5, 1])
    assert_equals_cv2(edit(data, EDITS[case]), f"{case} {transform}")


def _poc(entries) -> bytes:
    """A POC segment's payload: (first resolution, first component, layer end,
    resolution end, component end, progression) an entry."""
    return b"".join(struct.pack(">BBHBBB", *e) for e in entries)


POCS = {  # case: (the stream's progression, where the POC goes, its entries)
    "lrcp_layers": ("LRCP", "main", [(0, 0, 1, 6, 3, 0), (0, 0, 3, 6, 3, 0)]),
    "rlcp_resolutions": ("RLCP", "main", [(0, 0, 3, 2, 3, 1), (2, 0, 3, 6, 3, 1)]),
    "cprl_components": ("CPRL", "tile", [(0, 0, 3, 6, 1, 4), (0, 1, 3, 6, 3, 4)]),
    "rpcl_past_the_ends": ("RPCL", "tile", [(0, 0, 9, 3, 7, 2), (3, 0, 9, 33, 7, 2)]),
    "pcrl_then_repeat": ("PCRL", "main", [(0, 0, 3, 6, 3, 3), (0, 0, 3, 6, 3, 0)]),
    "cod_says_lrcp": ("RPCL", "main", [(0, 0, 3, 6, 3, 2)]),
}


@pytest.mark.parametrize("case", sorted(POCS))
def test_progression_order_changes(case):
    """POC entries that split a stream's own progression by layers,
    resolutions or components (ends past the last clamped, a repeated
    entry adding nothing), in the main header or a tile's: packets run as
    opj_pi walks each entry in turn, each packet once."""
    progression, where, entries = POCS[case]
    rng = rng_for("poc", case)
    data = pil_jp2(photo(rng, 90, 110), progression=progression, tile_size=(64, 64),
                   precinct_size=(32, 32), quality_mode="rates", quality_layers=[20, 5, 1])

    def change(main, parts):
        if case == "cod_says_lrcp":  # only the POC gives the stream's order
            cod = segment(main, 0xFF52)
            main = replace(main, 0xFF52, cod[:1] + b"\0" + cod[2:])
        if where == "main":
            return main + [(0xFF5F, _poc(entries))], parts
        return main, [dict(p, segments=p["segments"] + [(0xFF5F, _poc(entries))]) for p in parts]

    assert_equals_cv2(edit(data, change), case)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["cinema2k-24", "cinema4k-24"])
def test_digital_cinema_profiles(mode):
    """PIL's digital cinema files: 2K (2048x1080, CPRL, tile-parts by
    component, TLM) and 4K (4096x2160, whose tile-part headers change the
    progression with POC)."""
    from tests.test_torch_image_formats import texture

    h, w = (1080, 2048) if mode == "cinema2k-24" else (2160, 4096)
    image = cv2.resize(texture(rng_for("cinema", mode), h // 8, w // 8), (w, h))
    assert_equals_cv2(pil_jp2(image, cinema_mode=mode), mode)


class _Bits:
    """Packet header bits as opj_bio reads them: 7 after a 0xFF byte."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.buf, self.ct = data, pos, 0, 0

    def _byte(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < len(self.data):
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._byte()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit()
        return v

    def align(self) -> int:
        self.ct = 0
        if self.buf & 0xFF == 0xFF:
            self._byte()
        return self.pos


def _tag(node: dict, bits: _Bits, threshold: int) -> bool:
    """A one-leaf tag tree (a band of one code-block)."""
    while node["low"] < threshold and node["low"] < node["value"]:
        if bits.bit():
            node["value"] = node["low"]
        else:
            node["low"] += 1
    return node["value"] < threshold


def split_packets(data: bytes, x0: int, y0: int, x1: int, y1: int, resolutions: int,
                  layers: int, components: int) -> list:
    """An LRCP tile's packets as (header, body), for a tile whose bands hold
    one code-block and one precinct each (64x64 code-blocks, no precincts)."""
    def bands(r):
        if r == 0:
            n = resolutions - 1
            side = lambda a, b: -(-b // (1 << n)) - -(-a // (1 << n))
            return [side(x0, x1) * side(y0, y1)]
        n = resolutions - r
        out = []
        for xob, yob in ((1, 0), (0, 1), (1, 1)):
            w = -(-(x1 - (xob << (n - 1))) // (1 << n)) - -(-(x0 - (xob << (n - 1))) // (1 << n))
            h = -(-(y1 - (yob << (n - 1))) // (1 << n)) - -(-(y0 - (yob << (n - 1))) // (1 << n))
            out.append(w * h)
        return out

    state, packets, pos = {}, [], 0
    for layer in range(layers):
        for r in range(resolutions):
            for c in range(components):
                bits, lengths = _Bits(data, pos), []
                if bits.bit():
                    for b, area in enumerate(bands(r)):
                        if not area:
                            continue
                        st = state.setdefault((r, c, b), {"in": False, "incl": {
                            "value": 999, "low": 0}, "imsb": {"value": 999, "low": 0}})
                        if not (bits.bit() if st["in"] else _tag(st["incl"], bits, layer + 1)):
                            continue
                        if not st["in"]:
                            i = 0
                            while not _tag(st["imsb"], bits, i):
                                i += 1
                            st["in"], st["lblock"] = True, 3
                        passes = 1
                        if bits.bit():
                            passes = 2
                            if bits.bit():
                                passes = 3 + bits.bits(2)
                                if passes == 6:
                                    passes = 6 + bits.bits(5)
                                    if passes == 37:
                                        passes = 37 + bits.bits(7)
                        while bits.bit():
                            st["lblock"] += 1
                        lengths.append(bits.bits(st["lblock"] + passes.bit_length() - 1))
                end = bits.align()
                packets.append((data[pos:end], data[end : end + sum(lengths)]))
                pos = end + sum(lengths)
    assert pos == len(data), (pos, len(data))
    return packets


def _packed(kind: str, transform: str) -> bytes:
    """PIL's LRCP stream, 3 layers, its packet headers moved into PPT (in two
    segments given in reverse index order) or PPM (Nppm chunks, one a
    tile-part, the segments cut inside a chunk)."""
    rng = rng_for("packed", kind, transform)
    tiled = kind.endswith("_tiles")
    w, h, res = 64, 48, (4 if tiled else 6)
    data = pil_jp2(photo(rng, h, w), irreversible=transform == "9-7", quality_mode="rates",
                   quality_layers=[20, 5, 1], num_resolutions=res,
                   tile_size=(32, 32) if tiled else None)
    main, parts = parse(split_jp2(data)[1])
    out_parts, chunks = [], []
    for tp in parts:
        t = tp["index"]
        tx0, ty0 = (t % 2) * 32, (t // 2) * 32
        box = (tx0, ty0, min(tx0 + 32, w), min(ty0 + 32, h)) if tiled else (0, 0, w, h)
        packets = split_packets(tp["data"], *box, res, 3, 3)
        cut = len(packets) // 2 if kind.startswith("ppm") else len(packets)
        for k, group in enumerate((packets[:cut], packets[cut:])):
            if not group:
                continue
            heads = b"".join(hd for hd, _ in group)
            segments = list(tp["segments"]) if k == 0 else []
            if kind.startswith("ppt"):
                half = len(heads) // 2
                segments += [(0xFF61, b"\1" + heads[half:]), (0xFF61, b"\0" + heads[:half])]
            chunks.append(struct.pack(">I", len(heads)) + heads)
            out_parts.append({"index": t, "part": k, "parts": 0, "segments": segments,
                              "data": b"".join(body for _, body in group)})
    if kind.startswith("ppm"):
        stream = b"".join(chunks)
        third = len(stream) // 3
        main = main + [(0xFF60, b"\0" + stream[:third]), (0xFF60, b"\1" + stream[third:])]
    before, _, after = split_jp2(data)
    return join_jp2(before, build(main, out_parts), after)


@pytest.mark.parametrize("transform", ["5-3", "9-7"])
@pytest.mark.parametrize("kind", ["ppt", "ppt_tiles", "ppm", "ppm_tiles"])
def test_packed_packet_headers(kind, transform):
    """Packet headers moved out of the packets into PPT or PPM, with no
    re-encoding (``split_packets`` finds each header's end)."""
    assert_equals_cv2(_packed(kind, transform), f"{kind} {transform}")


# ---------------------------------------------------------------------------
# OpenJPEG's own encoder, through ctypes: the options PIL does not pass on


def opj_encode(image: np.ndarray, mode: int = 0, irreversible: bool = False, rates=None,
               roi=None, resolutions: int = 4, cblk: int = 16) -> bytes:
    """A raw codestream of (H, W, C) uint8 samples by the OpenJPEG that PIL
    bundles, with its code-block style ``mode``, the 9/7, layers at
    ``rates`` and an ROI ``(component, shift)``; the fields are set at their
    offsets in opj_cparameters_t, which the stream's COD and RGN confirm."""
    import ctypes
    import glob
    import os
    import tempfile

    import PIL

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                             "libopenjp2-*.so*"))[0])

    class Component(ctypes.Structure):  # opj_image_cmptparm_t
        _fields_ = [(n, ctypes.c_uint32) for n in
                    ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]

    class ImageComp(ctypes.Structure):  # opj_image_comp_t
        _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec",
                                                    "bpp", "sgnd", "resno_decoded", "factor")]
        _fields_ += [("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]

    class Image(ctypes.Structure):  # opj_image_t
        _fields_ = [(n, ctypes.c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")]
        _fields_ += [("color_space", ctypes.c_int), ("comps", ctypes.POINTER(ImageComp))]

    h, w, nc = image.shape
    lib.opj_image_create.restype = ctypes.POINTER(Image)
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    comps = (Component * nc)(*[Component(1, 1, w, h, 0, 0, 8, 8, 0)] * nc)
    img = lib.opj_image_create(nc, comps, 1 if nc >= 3 else 2)
    img.contents.x1, img.contents.y1 = w, h
    for c in range(nc):
        plane = np.ascontiguousarray(image[..., c], np.int32)
        ctypes.memmove(img.contents.comps[c].data, plane.ctypes.data, plane.nbytes)
    params = ctypes.create_string_buffer(1 << 16)  # past sizeof(opj_cparameters_t)
    lib.opj_set_default_encoder_parameters(params)
    # numresolution, cblockw_init, cblockh_init, mode, irreversible, roi_compno, roi_shift
    struct.pack_into("<7i", params, 5600, resolutions, cblk, cblk, mode, int(irreversible),
                     *(roi or (-1, 0)))
    if rates:  # cp_disto_alloc; tcp_numlayers, tcp_rates
        struct.pack_into("<i", params, 20, 1)
        struct.pack_into(f"<i{len(rates)}f", params, 4796, len(rates), *rates)
    codec = ctypes.c_void_p(lib.opj_create_compress(0))  # OPJ_CODEC_J2K
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        stream = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(path.encode(), 0))
        ok = (lib.opj_setup_encoder(codec, params, img) and lib.opj_start_compress(codec, img, stream)
              and lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        with open(path, "rb") as f:
            data = f.read()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        os.remove(path)
    assert ok
    main, _ = parse(data)
    cod = segment(main, 0xFF52)
    assert (cod[8], cod[9], cod[3]) == (mode, int(not irreversible), len(rates or [1]))
    assert (roi is None) == all(m != 0xFF5E for m, _ in main)
    return data


OPJ_STYLES = {"bypass": 1, "termall": 4, "bypass_termall": 5, "bypass_reset": 3,
              "bypass_vsc": 9, "bypass_segsym": 33, "termall_segsym": 36, "all_six": 63}


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("transform", ["5-3", "9-7"])
@pytest.mark.parametrize("case", sorted(OPJ_STYLES))
def test_code_block_styles_from_openjpeg(case, transform, layers):
    """OpenJPEG's encoder with each code-block style: bypass's raw passes
    from the fifth bit-plane and its segments of 10, then 2 and 1 passes;
    termination on each pass, one segment a pass; with the other styles."""
    rng = rng_for("opj styles", case, transform, layers)
    data = opj_encode(photo(rng, 61, 77), OPJ_STYLES[case], transform == "9-7",
                      [30, 8, 1] if layers == 3 else None)
    assert_equals_cv2(data, f"{case} {transform} {layers}")


@pytest.mark.parametrize("transform", ["5-3", "9-7"])
@pytest.mark.parametrize("shift", [1, 3, 6])
def test_region_of_interest(shift, transform):
    """RGN's implicit max-shift, as OpenJPEG's encoder writes it over a
    component: its coefficients decode shifted up, then back down."""
    rng = rng_for("roi", shift, transform)
    data = opj_encode(photo(rng, 61, 77), irreversible=transform == "9-7", rates=[20, 5, 1],
                      roi=(1, shift))
    assert_equals_cv2(data, f"roi {shift} {transform}")


STYLES = {"reset": 2, "vertically_causal": 8, "predictable_termination": 16,
          "segmentation_symbols": 32, "all_four": 2 | 8 | 16 | 32}


@pytest.mark.parametrize("transform", ["5-3", "9-7"])
@pytest.mark.parametrize("case", sorted(STYLES))
def test_code_block_styles(case, transform):
    """COD's code-block style bits set on a style-0 stream: OpenJPEG then
    resets the contexts after each pass, codes each stripe's last row
    without the row below, or reads four segmentation symbols after each
    cleanup pass (a different picture, held to cv2's); predictable
    termination changes nothing a decoder reads."""
    rng = rng_for("styles", case, transform)
    data = pil_jp2(photo(rng, 60, 77), irreversible=transform == "9-7", quality_mode="rates",
                   quality_layers=[20, 5, 1])
    style = STYLES[case]
    assert_equals_cv2(edit(data, lambda m, p: (replace(m, 0xFF52, (lambda c: c[:8] + bytes(
        [style]) + c[9:])(segment(m, 0xFF52))), p)), f"{case} {transform}")


COLOURS = {  # case: (colr payload, components) of a JP2 around PIL's codestream
    "srgb": (b"\1\0\0\0\0\0\x10", 3), "sycc": (b"\1\0\0\0\0\0\x12", 3),
    "unknown_space": (b"\1\0\0\0\0\0\x63", 3), "icc": (b"\2\0\0" + bytes(128), 3),
    "grey_of_rgb": (b"\1\0\0\0\0\0\x11", 3), "srgb_alpha": (b"\1\0\0\0\0\0\x10", 4),
    "sycc_16": (b"\1\0\0\0\0\0\x12", 3),
}


@pytest.mark.parametrize("case", sorted(COLOURS))
def test_colour_specifications(case):
    """sRGB; sYCC through cvtColor's YUV2BGR; an ICC profile or an unknown
    enumerated space taken as sRGB; greyscale of a three-component
    codestream (its first component)."""
    rng = rng_for("colour", case)
    colr, components = COLOURS[case]
    if case == "sycc_16":
        image = rng.integers(0, 65536, (50, 60, 3)).astype(np.uint16)
        cs = split_jp2(cv2_jp2(image, 1000))[1]
    else:
        cs = pil_jp2(photo(rng, 50, 60, components), no_jp2=True, mct=0)
    assert_equals_cv2(jp2_file(cs, 60, 50, components, colr), case)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _pclr(table: np.ndarray, bits) -> bytes:
    """A pclr box: the (entries, columns) table at the columns' precisions."""
    out = struct.pack(">HB", *table.shape) + bytes(b - 1 for b in bits)
    for row in table:
        out += b"".join(int(v).to_bytes((b + 7) // 8, "big") for v, b in zip(row, bits))
    return _box(b"pclr", out)


def _cmap(entries) -> bytes:
    return _box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def _cdef(entries) -> bytes:
    return _box(b"cdef", struct.pack(">H", len(entries))
                + b"".join(struct.pack(">HHH", *e) for e in entries))


SRGB, GREY = b"\1\0\0\0\0\0\x10", b"\1\0\0\0\0\0\x11"


def _paletted(case: str, rng) -> bytes:
    """A JP2 of PIL's one- or three-component codestream with pclr / cmap /
    cdef boxes."""
    grey = pil_jp2(photo(rng, 40, 52)[..., 0], no_jp2=True)
    rgb = pil_jp2(photo(rng, 40, 52), no_jp2=True, mct=0)
    rgba = pil_jp2(photo(rng, 40, 52, 4), no_jp2=True, mct=0)
    table = rng.integers(0, 256, (256, 3))
    full = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
    return {
        "palette": lambda: jp2_file(grey, 52, 40, 1, SRGB, _pclr(table, [8] * 3) + _cmap(full)),
        "palette_16_bits": lambda: jp2_file(grey, 52, 40, 1, SRGB, _pclr(np.column_stack(
            [rng.integers(0, 65536, (256, 2)), table[:, 2]]), [16, 16, 8]) + _cmap(full)),
        "palette_short": lambda: jp2_file(grey, 52, 40, 1, SRGB, _pclr(table[:100], [8] * 3)
                                          + _cmap(full)),
        "palette_grey": lambda: jp2_file(grey, 52, 40, 1, GREY, _pclr(table[:, :1], [8])
                                         + _cmap([(0, 1, 0)])),
        "palette_without_cmap": lambda: jp2_file(grey, 52, 40, 1, GREY, _pclr(table, [8] * 3)),
        "cmap_corrected": lambda: jp2_file(grey, 52, 40, 1, SRGB, _pclr(table, [8] * 3)
                                           + _cmap([(0, 0, 0), (0, 0, 0), (0, 1, 2)])),
        "palette_cdef": lambda: jp2_file(grey, 52, 40, 1, SRGB, _pclr(table, [8] * 3)
                                         + _cmap(full) + _cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "cdef_swap_r_b": lambda: jp2_file(rgb, 52, 40, 3, SRGB,
                                          _cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        "cdef_rotate": lambda: jp2_file(rgb, 52, 40, 3, SRGB,
                                        _cdef([(0, 0, 2), (1, 0, 3), (2, 0, 1)])),
        "cdef_alpha_first": lambda: jp2_file(rgba, 52, 40, 4, SRGB, _cdef(
            [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])),
        "cdef_grey_of_third": lambda: jp2_file(rgb, 52, 40, 3, GREY,
                                               _cdef([(2, 0, 1), (0, 0, 3), (1, 0, 2)])),
    }[case]()


PALETTES = ["palette", "palette_16_bits", "palette_short", "palette_grey",
            "palette_without_cmap", "cmap_corrected", "palette_cdef", "cdef_swap_r_b",
            "cdef_rotate", "cdef_alpha_first", "cdef_grey_of_third"]


@pytest.mark.parametrize("case", PALETTES)
def test_palettes_and_channel_definitions(case):
    """opj_jp2_apply_pclr (indices clamped to the last entry, entries past
    8 bits cut to their low byte by OpenCV, a pclr without cmap ignored, OpenJPEG's
    "trying to correct" of a one-component cmap) and opj_jp2_apply_cdef
    (colour channels swapped to their association, in order)."""
    assert_equals_cv2(_paletted(case, rng_for("palette", case)), case)


MISSING = {  # case: (dropped tiles, colour box, transform)
    "first_5_3": ((0,), SRGB, False), "last_9_7": ((3,), SRGB, True),
    "two_of_four": ((1, 2), SRGB, False), "sycc": ((0,), b"\1\0\0\0\0\0\x12", True),
    "grey_box": ((2,), GREY, False),
}


@pytest.mark.parametrize("case", sorted(MISSING) + ["palette", "mct_over_grey"])
def test_missing_tiles_and_a_transform_over_one_component(case):
    """A tile the codestream lacks: OpenJPEG leaves its samples 0, which
    OpenCV converts as any others (sYCC's black is not black; a palette
    looks up entry 0). MCT over one component: OpenJPEG skips it."""
    rng = rng_for("missing", case)
    if case == "mct_over_grey":
        data = edit(pil_jp2(photo(rng, 40, 48)[..., 0]), lambda m, p: (replace(
            m, 0xFF52, (lambda c: c[:4] + b"\1" + c[5:])(segment(m, 0xFF52))), p))
    elif case == "palette":
        cs = pil_jp2(photo(rng, 40, 48)[..., 0], no_jp2=True, tile_size=(32, 32))
        cs = build(*(lambda m, p: (m, p[1:]))(*parse(cs)))
        data = jp2_file(cs, 48, 40, 1, SRGB, _pclr(rng.integers(0, 256, (256, 3)), [8] * 3)
                        + _cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)]))
    else:
        dropped, colr, irreversible = MISSING[case]
        cs = pil_jp2(photo(rng, 40, 48), no_jp2=True, tile_size=(32, 32), mct=0,
                     irreversible=irreversible)
        cs = build(*(lambda m, p: (m, [t for t in p if t["index"] not in dropped]))(*parse(cs)))
        data = jp2_file(cs, 48, 40, 3, colr)
    assert_equals_cv2(data, case)


# ---------------------------------------------------------------------------
# refusals


def _refused(case: str) -> bytes:
    rng = rng_for("refused", case)
    base = pil_jp2(photo(rng, 40, 48), plt=True)
    cs = split_jp2(base)[1]
    siz = lambda change: edit(base, lambda m, p: (replace(m, 0xFF51, change(
        bytearray(segment(m, 0xFF51)))), p))

    def with_siz(offset, fmt, value):
        def change(s):
            struct.pack_into(fmt, s, offset, value)
            return bytes(s)
        return siz(change)

    def cod_byte(offset, value):
        return edit(base, lambda m, p: (replace(m, 0xFF52, (lambda c: bytes(
            c[:offset]) + bytes([value]) + bytes(c[offset + 1 :]))(segment(m, 0xFF52))), p))

    def insert(marker, payload):
        return edit(base, lambda m, p: (m + [(marker, payload)], p))

    if case == "signed":
        return pil_jp2(photo(rng, 40, 48), signed=True)
    if case == "cut_90":
        return base[: len(base) * 9 // 10]
    if case == "cut_50_j2k":
        return cs[: len(cs) // 2]
    if case == "no_eoc_j2k_cut":
        return cs[:-3]
    if case == "precision_7":
        return edit(base, lambda m, p: (_precision(m, 7), p))
    if case == "subsampled":
        return with_siz(37, ">B", 2)
    if case == "image_offset":
        return with_siz(10, ">I", 4)
    if case == "part2_rsiz":
        return with_siz(0, ">H", 0x8000)
    if case == "htj2k_rsiz":
        return with_siz(0, ">H", 0x4000)
    if case == "cap":
        return insert(0xFF50, b"\0\2\0\0\0\0")
    if case == "style_6":
        return cod_byte(8, 1 << 6)
    if case == "eph":
        return cod_byte(0, 4)
    if case == "wavelet_part2":
        return cod_byte(9, 2)
    if case == "rgn_style_1":
        return insert(0xFF5E, b"\0\1\3")
    if case == "poc_bad_length":
        return insert(0xFF5F, b"\0\0\0\1\1\0")
    if case == "ppm_beside_ppt":
        return edit(_packed("ppt", "5-3"), lambda m, p: (m + [(0xFF60, b"\0\0\0\0\0")], p))
    if case == "no_tile":
        return edit(base, lambda m, p: (m, []))
    if case in ("cmyk", "e_sycc"):
        return jp2_file(cs, 48, 40, 3, b"\1\0\0\0\0\0" + (b"\x0c" if case == "cmyk" else b"\x18"))
    if case == "cdef_incomplete":
        return jp2_file(cs, 48, 40, 3, SRGB, _cdef([(0, 0, 1), (1, 0, 2)]))
    if case == "cmap_twice":
        return jp2_file(split_jp2(pil_jp2(photo(rng, 40, 48)[..., 0]))[1], 48, 40, 1, SRGB,
                        _pclr(rng.integers(0, 256, (16, 3)), [8] * 3)
                        + _cmap([(0, 1, 0), (0, 1, 0), (0, 1, 2)]))
    if case == "cmap_first":
        return jp2_file(cs, 48, 40, 3, SRGB, _cmap([(0, 1, 0)]))
    if case == "grey_j2k":
        return pil_jp2(photo(rng, 40, 48)[..., 0], no_jp2=True)
    raise KeyError(case)


REFUSALS = {  # case: (what the message names, whether cv2 reads the file)
    "signed": ("component 0 is signed", False),
    "cut_90": ("cut short", False),
    "cut_50_j2k": ("cut short", False),
    "no_eoc_j2k_cut": ("cut short", False),
    "precision_7": ("component 0 of 7 bits", False),
    "subsampled": ("component 0 is subsampled 2x1", False),
    "image_offset": ("image offset", False),
    "part2_rsiz": ("Part 2 codestream", None),
    "htj2k_rsiz": ("HTJ2K codestream", None),
    "cap": ("CAP", None),
    "style_6": ("code-block style HTJ2K", None),
    "eph": ("EPH markers", None),
    "wavelet_part2": ("wavelet transform 2", None),
    "rgn_style_1": ("RGN style 1", None),
    "poc_bad_length": ("POC marker of a bad length", None),
    "ppm_beside_ppt": ("both PPM and PPT", None),
    "no_tile": ("codestream holds no tile", None),
    "cmyk": ("colour space CMYK", False),
    "e_sycc": ("colour space e-sYCC", False),
    "cdef_incomplete": ("cdef does not define every channel", False),
    "cmap_twice": ("cmap entry 1", False),
    "cmap_first": ("cmap box before its pclr box", False),
    "grey_j2k": ("sRGB of 1 channels", False),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_the_file_jpeg2000_and_the_feature(case):
    """Refused before any pixel, naming the feature; True / False: whether
    cv2 reads the file; None: not asserted (OpenJPEG reads some of these
    with warnings, or as garbage)."""
    data = _refused(case)
    feature, cv2_reads = REFUSALS[case]
    if cv2_reads is not None:
        assert (cv2_rgb(data) is not None) == cv2_reads, case
    with pytest.raises(ValueError, match=f"^refused.jp2: JPEG 2000 .*{feature}"):
        decode_rgb(data, "refused.jp2")


def test_damaged_files_raise_value_error_or_decode():
    """Seeded bit flips, byte edits and cuts of reversible, irreversible,
    tiled and layered files: ValueError or an image, never another error."""
    rng = rng_for("damaged")
    seeds = [pil_jp2(photo(rng, 40, 48), irreversible=True, tile_size=(32, 32)),
             pil_jp2(photo(rng, 37, 29), quality_mode="rates", quality_layers=[20, 5, 1],
                     progression="CPRL", no_jp2=True),
             cv2_jp2(photo(rng, 33, 35), 200)]
    decoded = 0
    for i in range(150):
        data = bytearray(seeds[i % len(seeds)])
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(2, len(data)))
            e = rng.random()
            if e < 0.6:
                data[pos] ^= 1 << int(rng.integers(0, 8))
            elif e < 0.9:
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


def test_detect_reads_a_single_jp2_as_jax(detect_weights, tmp_path, monkeypatch):
    """One 9/7 JP2 given alone as --input: its .txt equal to JAX's, which
    reads it with cv2.imread."""
    rng = rng_for("detect")
    single = tmp_path / "scene.jp2"
    single.write_bytes(pil_jp2(photo(rng, 80, 120), irreversible=True, tile_size=(64, 64)))
    assert _detect_both(str(single), tmp_path / "one", detect_weights, monkeypatch) == [
        "scene.txt"]
