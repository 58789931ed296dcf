"""Write the MPEG-4 Part 2 fixtures (run from the repository root):

    python -m tests.fixtures.make_mp4_fixture

* ``mp4v_640x480.mp4``: 48 frames at 640x480, 25 fps, written by
  ``cv2.VideoWriter`` (FFmpeg's mpeg4 encoder, ``mp4v`` in MP4, as the JAX
  package's ``VideoWriter`` writes), from seeded numpy content; and
  ``mp4v_640x480.json``, each frame's SHA-256 of the Y plane and of the
  RGB frame as ``cv2.VideoCapture`` (FFmpeg) decodes them.  The card
  machine has no OpenCV the port may use: ``chip_smoke.py`` holds the
  port's decoder to these digests there.
* ``mpeg4_features.mp4`` and ``mpeg4_dark.mp4``: streams that
  ``cv2.VideoWriter`` cannot make, encoded by the libavcodec inside the
  opencv-python wheel through ``ctypes`` (its public ``avcodec_*`` calls;
  ``AVFrame`` and ``AVPacket`` fields by their fixed offsets) and laid out
  by ``tests.torch_mp4_helpers.write_mp4``.  ``features``: four motion
  vectors a macroblock (``+mv4``), AC prediction (``+aic``), a quantiser
  that changes per macroblock (the adaptive-quantisation masks, so DQUANT
  and rescaled AC predictors) and video packets after resync markers
  (``ps``), at 200x136 (partial macroblocks).  ``dark``: luma and chroma
  samples of 0 under half-sample vectors with rounding type 1, where
  libavcodec's x86 averages differ from the exact ones.  The tests hold
  the port to OpenCV's decode of these files live.
* ``xvid_bf2_640x480.avi``: 48 frames at 640x480, 25 fps, two B-VOPs
  between references (``bf`` 2), encoded by the same libavcodec route and
  laid out as an ``XVID`` AVI by ``tests.torch_mp4_helpers.write_avi``;
  and ``xvid_bf2_640x480.json``, its digests as OpenCV decodes them, for
  the card (``chip_smoke.py``'s ``mpeg4_bvop`` phase).
* ``xvid_qpel_640x480.avi``: 48 frames at 640x480, 25 fps, quarter-sample
  vectors and four vectors a macroblock (``+qpel+mv4``) with two B-VOPs
  between references, from the same libavcodec route, its ``Lavc`` user
  data replaced by XviD's ``XviD0050`` (so FFmpeg, and the port, decode it
  with the XviD IDCT), as an ``XVID`` AVI; and ``xvid_qpel_640x480.json``,
  its digests as OpenCV decodes them, for the card (``chip_smoke.py``'s
  ``mpeg4_bvop`` phase).  Remake only it with ``python -m
  tests.fixtures.make_mp4_fixture xvid_qpel``: it is written only where
  OpenCV reads every frame and the port's decoder equals it.

* ``vp8_640x480.webm``: 48 frames at 640x480, 25 fps, VP8 from the same
  libavcodec's libvpx encoder in two passes (alt-ref frames, hidden), four
  token partitions and a key frame every 24 frames, laid out as a WebM by
  ``tests.torch_mkv_helpers.write_mkv``; and ``vp8_640x480.json``, its
  digests as OpenCV decodes them, for the card (``chip_smoke.py``'s
  ``webm`` phase).  The port's decoder checks that the stream uses split
  vectors, the golden and alt-ref frames, hidden frames and token
  partitions.  Remake only it with ``python -m
  tests.fixtures.make_mp4_fixture webm``.

* ``mpeg4_damaged.mp4``: 26 frames at 200x136 from the same libavcodec
  route with four vectors a macroblock (``+mv4``), the adaptive
  quantisation masks and two B-VOPs between references (``bf`` 2).
  libavcodec's own decoder finds an ``mb_type`` code that 14496-2 does
  not have in its tenth sample ("illegal MB_type") and conceals the rest;
  the port raises there (ROADMAP Queue 3, item B).  Remake only
  it with ``python -m tests.fixtures.make_mp4_fixture damaged``.

The B-VOP streams of the CPU tests come from the same route at test time
(``lavc_stream``, ``write_lavc_mp4``, ``write_lavc_avi``), as do the VP8
streams (``tests.torch_mkv_helpers.vp8_packets``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CHIP_VIDEO = os.path.join(HERE, "mp4v_640x480.mp4")
CHIP_DIGESTS = os.path.join(HERE, "mp4v_640x480.json")
FEATURES = os.path.join(HERE, "mpeg4_features.mp4")
CHIP_QPEL_VIDEO = os.path.join(HERE, "xvid_qpel_640x480.avi")
CHIP_QPEL_DIGESTS = os.path.join(HERE, "xvid_qpel_640x480.json")
USER_DATA, VOP = b"\x00\x00\x01\xb2", b"\x00\x00\x01\xb6"
DARK = os.path.join(HERE, "mpeg4_dark.mp4")
CHIP_BVOP_VIDEO = os.path.join(HERE, "xvid_bf2_640x480.avi")
CHIP_BVOP_DIGESTS = os.path.join(HERE, "xvid_bf2_640x480.json")
CHIP_WEBM_VIDEO = os.path.join(HERE, "vp8_640x480.webm")
CHIP_WEBM_DIGESTS = os.path.join(HERE, "vp8_640x480.json")
CHIP_VP9_VIDEO = os.path.join(HERE, "vp9_640x480.webm")
CHIP_VP9_DIGESTS = os.path.join(HERE, "vp9_640x480.json")
DAMAGED = os.path.join(HERE, "mpeg4_damaged.mp4")


def moving_scene(n: int, w: int, h: int, seed: int):
    """BGR frames: a gradient, a black band, textured squares that move
    across the frame's edges, a marker that moves every frame (no two
    frames alike), and a cut (every frame inverted) at frame 9 of every 17,
    which makes intra macroblocks in P-VOPs."""
    rng = np.random.default_rng(seed)
    texture = cv2.GaussianBlur(rng.integers(0, 256, (h + 64, w + 64, 3), dtype=np.uint8),
                               (0, 0), 3)
    texture = ((texture.astype(int) - 128) * 4 + 128).clip(0, 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        f[..., 0] = xx * 255 // max(w - 1, 1)
        f[..., 1] = yy * 255 // max(h - 1, 1)
        f[: h // 8] = 0
        for k in range(3):
            s = max(8, min(w, h) // 6) + 8 * k
            x = int((i * (5 + 3 * k) + 40 * k) % (w + 2 * s)) - s
            y = int(h / 2 + (h / 2 + s) * np.sin(i / (6 + k) + k)) - s // 2
            x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + s, w), min(y + s, h)
            if x1 > x0 and y1 > y0:
                f[y0:y1, x0:x1] = texture[y0 + 5:y1 + 5, x0 + 7 * k:x1 + 7 * k]
        x = (i * 11) % max(w - 16, 1)  # a marker that moves every frame
        f[h - 12:h - 4, x:x + 16] = (40, 200, 240)
        if i % 17 == 9:
            f[:] = 255 - f
        frames.append(f)
    return frames


def write_digests(video: str, out: str, width: int, height: int, count: int) -> None:
    """Each frame's SHA-256 of the Y plane and of the RGB frame as
    ``cv2.VideoCapture`` (FFmpeg) decodes ``video``, into ``out``."""
    digests = []
    ys = cv2.VideoCapture(video, cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])
    bgr = cv2.VideoCapture(video, cv2.CAP_FFMPEG)
    while True:
        ok_y, y = ys.read()
        ok_c, c = bgr.read()
        if not (ok_y and ok_c):
            break
        rgb = np.ascontiguousarray(c[..., ::-1])
        digests.append({"y": hashlib.sha256(y.reshape(height, width).tobytes()).hexdigest(),
                        "rgb": hashlib.sha256(rgb.tobytes()).hexdigest()})
    assert len(digests) == count
    with open(out, "w") as f:
        json.dump({"width": width, "height": height, "frames": digests}, f, indent=0)
        f.write("\n")


def write_chip_fixture() -> None:
    frames = moving_scene(48, 640, 480, seed=0)
    writer = cv2.VideoWriter(CHIP_VIDEO, cv2.VideoWriter_fourcc(*"mp4v"), 25, (640, 480))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    write_digests(CHIP_VIDEO, CHIP_DIGESTS, 640, 480, 48)


def write_chip_bvop_fixture() -> None:
    stream = lavc_stream(moving_scene(48, 640, 480, seed=0), {"bf": 2, "b": 600000})
    assert "B" in stream.types
    write_lavc_avi(CHIP_BVOP_VIDEO, stream, b"XVID")
    write_digests(CHIP_BVOP_VIDEO, CHIP_BVOP_DIGESTS, 640, 480, 48)


QPEL_USER_DATA = b"XviD0050"


def write_chip_qpel_fixture() -> None:
    """The quarter-sample XviD AVI: libavcodec's stream (``+qpel+mv4``, two
    B-VOPs between references) with its own user data replaced by XviD's,
    so FFmpeg reads it as XviD's (its IDCT).  Written only if OpenCV
    reads all 48 frames, and the port's decoder (which reports what it
    read) finds the user data and quarter-sample vectors and gives
    OpenCV's frames: a stream libavcodec's decoder found damaged would
    fail here."""
    from tests.torch_mp4_helpers import cv2_views
    from viddet_tpu_torch.native import Mpeg4Decoder
    from viddet_tpu_torch.native.avi import AviReader

    stream = lavc_stream(moving_scene(48, 640, 480, seed=0),
                         {"bf": 2, "flags": "+qpel+mv4", "b": 600000})
    assert stream.types.count("B") >= 16, stream.types
    write_lavc_avi(CHIP_QPEL_VIDEO, stream.with_user_data(QPEL_USER_DATA), b"XVID")
    want = cv2_views(CHIP_QPEL_VIDEO, "y")
    assert len(want) == 48
    with AviReader(CHIP_QPEL_VIDEO) as reader:
        decoder = Mpeg4Decoder(reader.index.config, CHIP_QPEL_VIDEO, reader.index.fourcc)
        ys = []
        for i in range(len(reader)):
            if decoder.decode(reader.sample(i), rgb=False):
                ys.append(decoder.planes()[0])
        if decoder.flush(rgb=False):
            ys.append(decoder.planes()[0])
    info = decoder.stream_info
    assert info["quarter_sample"] and info["xvid_build"] == 50 and info["idct"] == "xvid", info
    assert info["lavc_build"] is None, info
    assert len(ys) == 48 and all(np.array_equal(y, w.reshape(y.shape)) for y, w in zip(ys, want))
    write_digests(CHIP_QPEL_VIDEO, CHIP_QPEL_DIGESTS, 640, 480, 48)


def write_chip_webm_fixture() -> None:
    from tests.torch_mkv_helpers import vp8_webm
    from viddet_tpu_torch.native import Vp8Decoder
    from viddet_tpu_torch.native.mkv import MkvReader

    vp8_webm(CHIP_WEBM_VIDEO, moving_scene(48, 640, 480, seed=0),
             {"b": 1200000, "auto-alt-ref": 1, "lag-in-frames": 16, "slices": 4, "g": 24},
             two_pass=True)
    decoder = Vp8Decoder(CHIP_WEBM_VIDEO)
    with MkvReader(CHIP_WEBM_VIDEO) as reader:
        for i in range(len(reader.index.offsets)):
            decoder.decode(reader.sample(i), rgb=False)
    need = {"split vectors", "golden reference", "alt-ref reference", "hidden frame",
            "token partitions", "B_PRED", "vectors off the frame"}
    assert need <= decoder.features, need - decoder.features
    write_digests(CHIP_WEBM_VIDEO, CHIP_WEBM_DIGESTS, 640, 480, 48)


class Lavc:
    """FFmpeg's encoders (mpeg4, and libvpx for VP8) from the opencv-python
    wheel's libavcodec."""

    def __init__(self):
        libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                            "opencv_python.libs")
        self.avutil = ctypes.CDLL(glob.glob(libs + "/libavutil-*.so*")[0], mode=ctypes.RTLD_GLOBAL)
        self.avcodec = ctypes.CDLL(glob.glob(libs + "/libavcodec-*.so*")[0])
        p = ctypes.c_void_p
        a, u = self.avcodec, self.avutil
        a.avcodec_find_encoder_by_name.restype = p
        a.avcodec_find_encoder_by_name.argtypes = [ctypes.c_char_p]
        a.avcodec_alloc_context3.restype = p
        a.avcodec_alloc_context3.argtypes = [p]
        a.avcodec_open2.argtypes = [p, p, p]
        a.avcodec_send_frame.argtypes = [p, p]
        a.avcodec_receive_packet.argtypes = [p, p]
        a.avcodec_free_context.argtypes = [p]
        a.av_packet_alloc.restype = p
        a.av_packet_free.argtypes = [p]
        a.av_packet_unref.argtypes = [p]
        u.av_opt_set.argtypes = [p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        u.av_frame_alloc.restype = p
        u.av_frame_get_buffer.argtypes = [p, ctypes.c_int]
        u.av_frame_make_writable.argtypes = [p]
        u.av_frame_free.argtypes = [p]
        u.av_malloc.restype = p
        u.av_malloc.argtypes = [ctypes.c_size_t]
        u.av_opt_find.restype = p
        u.av_opt_find.argtypes = [p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]

    def set_matrices(self, ctx, intra, inter) -> None:
        """AVCodecContext.intra_matrix / inter_matrix (raster order), which no
        AVOption names: the two pointers lie 24 and 16 bytes before
        ``intra_dc_precision`` (option "dc"), after ``mb_decision`` ("mbd")."""
        def offset(name):
            option = self.avutil.av_opt_find(ctx, name, None, 0, 0)
            return ctypes.cast(option, ctypes.POINTER(ctypes.c_int))[4]  # AVOption.offset

        dc, mbd = offset(b"dc"), offset(b"mbd")
        assert (mbd + 4 + 7) // 8 * 8 == dc - 24, (mbd, dc)
        for delta, matrix in ((24, intra), (16, inter)):
            buf = self.avutil.av_malloc(128)  # freed by avcodec_free_context
            ctypes.memmove(buf, (ctypes.c_uint16 * 64)(*matrix), 128)
            ctypes.c_void_p.from_address(ctx + dc - delta).value = buf

    def stats_fields(self, ctx) -> int:
        """The offset of AVCodecContext.stats_out, which no AVOption names:
        it and stats_in are the two pointers before ``workaround_bugs``
        (option "bug")."""
        option = self.avutil.av_opt_find(ctx, b"bug", None, 0, 0)
        return ctypes.cast(option, ctypes.POINTER(ctypes.c_int))[4] - 16

    def encode(self, planes, width: int, height: int, options: dict, matrices=None,
               encoder: str = "mpeg4", stats: bytes = b"", pix_fmt: str = "yuv420p"):
        """(Y, U, V) uint8 planes per frame -> the packets' bytes, in decode
        order; ``self.pts`` gets each packet's presentation time in frames.
        ``matrices``: custom (intra, inter) quantiser matrices, 64 values
        each in raster order (with ``mpeg_quant``); ``encoder``: the
        libavcodec encoder's name ("libvpx" writes VP8, "libvpx-vp9" VP9);
        ``pix_fmt`` the planes' layout ("yuv420p" or "yuv444p").  A first pass
        (``flags`` "+pass1") leaves its statistics in ``self.stats``; a
        second (``flags`` "+pass2") reads them from ``stats``."""
        a, u = self.avcodec, self.avutil
        codec = a.avcodec_find_encoder_by_name(encoder.encode())
        ctx = a.avcodec_alloc_context3(codec)
        if matrices:
            self.set_matrices(ctx, *matrices)
        stats_in = ctypes.create_string_buffer(stats) if stats else None
        if stats:
            ctypes.c_void_p.from_address(ctx + self.stats_fields(ctx) + 8).value = (
                ctypes.addressof(stats_in))
        base = {"video_size": f"{width}x{height}", "pixel_format": pix_fmt,
                "time_base": "1/25"}
        for key, value in {**base, **options}.items():
            if u.av_opt_set(ctx, key.encode(), str(value).encode(), 1) < 0:
                raise RuntimeError(f"libavcodec option {key}={value}")
        if a.avcodec_open2(ctx, codec, None) < 0:
            raise RuntimeError("avcodec_open2 failed")
        frame = u.av_frame_alloc()
        ints = ctypes.cast(frame, ctypes.POINTER(ctypes.c_int))
        ptrs = ctypes.cast(frame, ctypes.POINTER(ctypes.c_void_p))
        # AVFrame width, height, format (AV_PIX_FMT_YUV420P 0, AV_PIX_FMT_YUV444P 5)
        ints[26], ints[27], ints[29] = width, height, {"yuv420p": 0, "yuv444p": 5}[pix_fmt]
        assert u.av_frame_get_buffer(frame, 0) == 0
        pkt = a.av_packet_alloc()
        out, self.pts = [], []

        def drain():
            while a.avcodec_receive_packet(ctx, pkt) >= 0:
                fields = ctypes.cast(pkt, ctypes.POINTER(ctypes.c_void_p))
                size = ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int))[8]  # AVPacket.size
                out.append(ctypes.string_at(fields[3], size))  # AVPacket.data
                self.pts.append(ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int64))[1])
                a.av_packet_unref(pkt)

        for n, yuv in enumerate(planes):
            u.av_frame_make_writable(frame)
            ctypes.cast(frame, ctypes.POINTER(ctypes.c_int64))[17] = n  # AVFrame.pts
            for k, plane in enumerate(yuv):
                stride = ints[16 + k]  # AVFrame.linesize
                for r in range(plane.shape[0]):
                    ctypes.memmove(ptrs[k] + r * stride, plane[r].ctypes.data, plane.shape[1])
            assert a.avcodec_send_frame(ctx, frame) == 0
            drain()
        a.avcodec_send_frame(ctx, None)
        drain()
        out_stats = ctypes.c_char_p.from_address(ctx + self.stats_fields(ctx)).value
        self.stats = out_stats or b""
        if stats:
            ctypes.c_void_p.from_address(ctx + self.stats_fields(ctx) + 8).value = None
        for free, handle in ((a.av_packet_free, pkt), (u.av_frame_free, frame),
                             (a.avcodec_free_context, ctx)):
            free(ctypes.byref(ctypes.c_void_p(handle)))
        return out


def write_lavc(path: str, planes, width: int, height: int, options: dict) -> None:
    from tests.torch_mp4_helpers import write_mp4

    packets = Lavc().encode(planes, width, height, options)
    vop = packets[0].find(b"\x00\x00\x01\xb6")  # the headers before it go in the esds
    write_mp4(path, [packets[0][vop:]] + packets[1:], width, height, config=packets[0][:vop])


@dataclasses.dataclass
class LavcStream:
    """An encoded stream: the packets in decode order, each one's
    presentation time in frames, its VOP type (I, P, B) and the frame size."""

    packets: list
    pts: list
    types: str
    width: int
    height: int

    def with_user_data(self, user_data: bytes = b"", own: bool = False) -> "LavcStream":
        """The stream with ``user_data`` (``XviD0050``, ``DivX503b1393``, ...)
        before the first VOL or GOV, and libavcodec's own (its ``Lavc``
        version, which its decoder reads, before each I-VOP's headers) kept
        only with ``own``."""
        packets = list(self.packets)
        for i, packet in enumerate(packets):
            start = packet.find(USER_DATA, 0, max(packet.find(VOP), 0))
            if not own and start >= 0:
                packets[i] = packet[:start] + packet[packet.find(b"\x00\x00\x01", start + 4):]
        first = packets[0]
        if user_data:
            at = min(i for i in (first.find(b"\x00\x00\x01\xb3"), first.find(VOP))
                     if i >= 0)
            first = first[:at] + USER_DATA + user_data + first[at:]
        return dataclasses.replace(self, packets=[first] + packets[1:])


def lavc_stream(frames, options: dict, matrices=None) -> LavcStream:
    """BGR ``frames`` through libavcodec's mpeg4 encoder (``bf`` B-VOPs,
    ``mpeg_quant``, ``flags``, ...; ``matrices`` as ``Lavc.encode``)."""
    h, w = frames[0].shape[:2]
    lavc = Lavc()
    packets = lavc.encode([i420(f) for f in frames], w, h, options, matrices)
    types = "".join("IPBS"[p[p.find(b"\x00\x00\x01\xb6") + 4] >> 6] for p in packets)
    return LavcStream(packets, lavc.pts, types, w, h)


def write_lavc_mp4(path: str, stream: LavcStream, shift: bool = True,
                   ctts_version: int = 0) -> str:
    """``stream`` in an MP4 laid out as FFmpeg's muxer lays out B-frames: a
    ``ctts`` of each sample's composition offset (512 ticks a frame) and,
    with ``shift``, the edit list that starts the movie at the first
    sample's; version 1 offsets start at 0 (some negative) and need no
    shift."""
    from tests.torch_mp4_helpers import write_mp4

    delay = 0 if ctts_version else max(i - p for i, p in enumerate(stream.pts))
    ctts = [(p - i + delay) * 512 for i, p in enumerate(stream.pts)]
    edits = [(len(ctts) * 40, ctts[0], 1)] if shift else None
    first = stream.packets[0]
    vop = first.find(b"\x00\x00\x01\xb6")  # the headers before it go in the esds
    return write_mp4(path, [first[vop:]] + stream.packets[1:], stream.width, stream.height,
                     config=first[:vop], ctts=ctts, ctts_version=ctts_version, edits=edits)


def write_lavc_avi(path: str, stream: LavcStream, fourcc: bytes = b"XVID",
                   packed: bool = False, user_data: bytes = b"") -> str:
    """``stream`` as the chunks of an AVI (the headers stay at the head of
    the first), packed as DivX packs B-frames with ``packed``, with
    ``user_data`` (for instance DivX's ``DivX503b1393p``) after the VOL,
    beside libavcodec's own."""
    from tests.torch_mp4_helpers import pack_bframes, write_avi

    packets = stream.with_user_data(user_data, own=True).packets
    chunks = pack_bframes(packets, stream.types, 5) if packed else packets
    return write_avi(path, chunks, stream.width, stream.height, fourcc=fourcc)


def i420(bgr):
    h, w = bgr.shape[:2]
    yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
    return yuv[:h], yuv[h:h + h // 4].reshape(h // 2, w // 2), yuv[h + h // 4:].reshape(h // 2,
                                                                                       w // 2)


def write_feature_fixtures() -> None:
    write_lavc(FEATURES, [i420(f) for f in moving_scene(26, 200, 136, seed=3)], 200, 136,
               {"flags": "+mv4+aic", "lumi_mask": 0.6, "dark_mask": 0.6, "p_mask": 0.8,
                "scplx_mask": 0.5, "tcplx_mask": 0.5, "b": 150000, "ps": 400})
    rng = np.random.default_rng(1)
    w, h = 128, 80
    dots = np.where(rng.random((h * 4, w * 4)) < 0.6, 0,
                    rng.integers(1, 100, (h * 4, w * 4)) | 1).astype(np.float32)
    dots = cv2.resize(dots, (w * 2, h * 2), interpolation=cv2.INTER_NEAREST)
    planes = []
    for i in range(12):  # half a sample a frame, across, then down
        dx, dy = (i * 0.5, 0.0) if i < 6 else (3.0, (i - 6) * 0.5)
        shift = np.float32([[1, 0, -dx - 10], [0, 1, -dy - 10]])
        y = np.round(cv2.warpAffine(dots, shift, (w, h))).astype(np.uint8)
        cb = cv2.resize(y, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST)
        planes.append((y, cb, 255 - cb))
    write_lavc(DARK, planes, w, h, {"flags": "+mv4", "qmin": 2, "qmax": 4, "b": 2000000})


DAMAGED_OPTIONS = {"flags": "+mv4", "lumi_mask": 0.6, "dark_mask": 0.6, "p_mask": 0.8,
                   "scplx_mask": 0.5, "tcplx_mask": 0.5, "b": 150000, "bf": 2}


def write_damaged_fixture() -> None:
    write_lavc_mp4(DAMAGED, lavc_stream(moving_scene(26, 200, 136, seed=3), DAMAGED_OPTIONS))


def write_chip_vp9_fixture() -> None:
    """The card's VP9 WebM: 48 shown frames at 25 fps from libvpx-vp9's two
    passes with alt-ref frames (superframes of hidden frames), 2 tile
    columns and backward adaptation (frame-parallel 0); written only if the
    port's decoder reports those features and gives OpenCV's Y planes."""
    from tests.torch_mkv_helpers import vp9_webm
    from tests.torch_mp4_helpers import cv2_views
    from viddet_tpu_torch.native import Vp9Decoder
    from viddet_tpu_torch.native.mkv import MkvReader

    vp9_webm(CHIP_VP9_VIDEO, moving_scene(48, 640, 480, seed=0),
             {"b": 800000, "auto-alt-ref": 1, "lag-in-frames": 25, "tile-columns": 1,
              "frame-parallel": 0, "g": 48}, two_pass=True)
    want = cv2_views(CHIP_VP9_VIDEO, "y")
    decoder, ys = Vp9Decoder(CHIP_VP9_VIDEO), []
    with MkvReader(CHIP_VP9_VIDEO) as reader:
        for i in range(len(reader.index.offsets)):
            if decoder.decode(reader.sample(i), rgb=False):
                ys.append(decoder.planes()[0])
    need = {"superframe", "hidden frame", "compound prediction", "tile columns",
            "probability adaptation"}
    assert need <= decoder.features, need - decoder.features
    assert len(ys) == len(want) == 48
    assert all(np.array_equal(y, w.reshape(-1)[: y.size].reshape(y.shape)) for y, w in zip(ys, want))
    write_digests(CHIP_VP9_VIDEO, CHIP_VP9_DIGESTS, 640, 480, 48)


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["damaged"]:
        write_damaged_fixture()
    elif sys.argv[1:] == ["xvid_qpel"]:
        write_chip_qpel_fixture()
    elif sys.argv[1:] == ["vp9"]:
        write_chip_vp9_fixture()
    else:
        if sys.argv[1:] != ["webm"]:
            write_chip_fixture()
            write_feature_fixtures()
            write_chip_bvop_fixture()
            write_chip_qpel_fixture()
            write_damaged_fixture()
        write_chip_webm_fixture()
    for path in (CHIP_VIDEO, FEATURES, DARK, CHIP_BVOP_VIDEO, CHIP_QPEL_VIDEO, CHIP_WEBM_VIDEO,
                 CHIP_VP9_VIDEO, DAMAGED):
        print(path, os.path.getsize(path), "bytes")
