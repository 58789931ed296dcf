"""The port's JPEG decoder against OpenCV, bit for bit.

``viddet_tpu_torch.native`` decodes with the port's own codec at full scale
and ``data.base.decode_rgb`` applies the EXIF orientation; together they
must equal ``cv2.imdecode(buf, IMREAD_COLOR)`` plus the BGR-to-RGB swap,
and ``imread_rgb`` must equal the JAX package's (``cv2.imread``).  The
JPEGs are written here by ``cv2`` at qualities 50-95, chroma subsampling
4:4:4, 4:2:2 and 4:2:0 and odd sizes, plus greyscale, progressive and (by
Pillow) CMYK files, and EXIF orientations 1-8 spliced into ``cv2``'s bytes
by hand in both byte orders.  Bytes that are no image, a PNG with a
broken CRC, truncated and corrupt JPEGs raise ``ValueError`` (the PNG and
BMP cases that decode are in ``tests/test_torch_codec.py``).
"""

import struct
import threading

import cv2
import numpy as np
import pytest

from viddet_tpu.data.base import imread_rgb as jax_imread_rgb
from viddet_tpu.utils.image import exif_orientation as jax_exif_orientation
from viddet_tpu_torch.data.base import decode_rgb, imread_rgb
from viddet_tpu_torch.native import decode_jpeg
from viddet_tpu_torch.utils.image import exif_orientation

QUALITIES = (50, 75, 90, 95)
SUBSAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
               "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
               "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = ((37, 53), (240, 320), (333, 500), (1, 1), (17, 8))


def _image(h, w, seed=0):
    """Smooth noise, so every DCT band and both chroma planes carry data."""
    rng = np.random.default_rng((seed, h, w))
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 1.5)


def _encode(image, *params):
    ok, buf = cv2.imencode(".jpg", image, list(params))
    assert ok
    return buf.tobytes()


def _cv2_rgb(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _with_exif(data: bytes, orientation: int, endian: str) -> bytes:
    """``data`` with an APP1 EXIF segment holding one Orientation entry
    inserted right after SOI."""
    e = "<" if endian == "II" else ">"
    tiff = (endian.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
def test_colour_jpegs_equal_cv2(quality, sub):
    for h, w in SIZES:
        data = _encode(_image(h, w), cv2.IMWRITE_JPEG_QUALITY, quality,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SUBSAMPLING[sub])
        got = decode_rgb(data, "test")
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, _cv2_rgb(data), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("kind", ["grey", "progressive", "cmyk"])
def test_other_jpeg_kinds_equal_cv2(kind):
    if kind == "grey":
        data = _encode(_image(61, 47)[..., 0])
    elif kind == "progressive":
        data = _encode(_image(64, 80), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    else:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(_image(40, 30)).convert("CMYK").save(buf, "JPEG", quality=90)
        data = buf.getvalue()
    np.testing.assert_array_equal(decode_rgb(data, kind), _cv2_rgb(data))


@pytest.mark.parametrize("endian", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_equals_cv2(orientation, endian, tmp_path):
    data = _with_exif(_encode(_image(30, 50)), orientation, endian)
    want = _cv2_rgb(data)
    assert want.shape == ((50, 30, 3) if orientation >= 5 else (30, 50, 3))
    np.testing.assert_array_equal(decode_rgb(data, "exif"), want)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    assert exif_orientation(str(path)) == jax_exif_orientation(str(path)) == orientation
    np.testing.assert_array_equal(imread_rgb(str(path)), jax_imread_rgb(str(path)))
    # the raw raster ignores the tag
    np.testing.assert_array_equal(decode_jpeg(data), _cv2_rgb(_encode(_image(30, 50))))


def test_imread_equals_jax_imread(tmp_path):
    for i, (h, w) in enumerate(SIZES):
        path = tmp_path / f"{i}.jpg"
        cv2.imwrite(str(path), cv2.cvtColor(_image(h, w, seed=1), cv2.COLOR_RGB2BGR))
        np.testing.assert_array_equal(imread_rgb(str(path)), jax_imread_rgb(str(path)))
    with pytest.raises(FileNotFoundError):
        imread_rgb(str(tmp_path / "missing.jpg"))


def _bad_inputs():
    data = _encode(_image(64, 80))
    sos = data.index(b"\xff\xda")
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, len(data) - sos - 22, dtype=np.uint8).tobytes()
    png = bytearray(cv2.imencode(".png", _image(20, 20))[1].tobytes())
    png[29] ^= 1  # the IHDR chunk's CRC no longer matches
    return {
        "png": bytes(png),
        "empty": b"",
        "soi_only": data[:4],
        "truncated": data[: len(data) // 2],
        "no_eoi": data[:-2],
        "corrupt_scan": data[: sos + 20] + noise + data[-2:],
        "corrupt_header": data[:3] + rng.integers(0, 256, 60, dtype=np.uint8).tobytes()
        + data[63:],
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_bad_input_raises(case):
    with pytest.raises(ValueError, match=case):
        decode_rgb(_bad_inputs()[case], case)


def test_threads_decode_concurrently_and_equal():
    """The loader's worker threads share one library; every decode from
    8 threads equals the serial one."""
    datas = [_encode(_image(120 + i, 90 + i), cv2.IMWRITE_JPEG_QUALITY, 80) for i in range(8)]
    want = [decode_rgb(d, "serial") for d in datas]
    errors = []

    def worker(offset):
        try:
            for rep in range(10):
                i = (offset + rep) % len(datas)
                np.testing.assert_array_equal(decode_rgb(datas[i], "thread"), want[i])
        except Exception as exc:  # noqa: BLE001 -- asserted below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(o,)) for o in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:1]
