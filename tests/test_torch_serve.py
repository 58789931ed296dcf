"""The port's HTTP server (``viddet_tpu_torch.cli.serve``) on the CPU,
mirroring ``tests/integration/test_serve.py``.

A live server on an ephemeral port answers JPEG, PNG and BMP uploads; each
reply equals JAX's ``viddet_tpu.cli.serve.detections_to_json`` over the
port's direct predictor call on the same decoded image, with the image's
size.  ``/healthz`` reports the model, a body that is no image gets a 400
(never a fallback), a bad ``thresh`` a 400 and an unknown path a 404.
``decode_image_bytes`` equals JAX's (``cv2.imdecode``, EXIF applied).
"""

import json
import struct
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from viddet_tpu.cli.serve import decode_image_bytes as jax_decode_image_bytes
from viddet_tpu.cli.serve import detections_to_json as jax_detections_to_json
from viddet_tpu_torch.cli.common import build_model, load_weights_or_seed, make_predictor
from viddet_tpu_torch.cli.common import setup_logging
from viddet_tpu_torch.cli.serve import (
    decode_image_bytes,
    detections_to_json,
    parse_args,
    serve_forever,
)
from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
from viddet_tpu_torch.infer.service import to_device_batch
from viddet_tpu_torch.native import encode_png

SIZE, BATCH = 64, 2


def _with_exif(data: bytes, orientation: int) -> bytes:
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def _uploads():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (60, 90, 3), np.uint8)
    jpeg = cv2.imencode(".jpg", img[:, :, ::-1])[1].tobytes()
    return {
        "jpeg": jpeg,
        "jpeg_exif6": _with_exif(jpeg, 6),
        "png": encode_png(rng.integers(0, 255, (41, 70, 3), np.uint8)),
        "bmp": cv2.imencode(".bmp", rng.integers(0, 255, (33, 20, 3), np.uint8))[1].tobytes(),
    }


@pytest.fixture(scope="module")
def server():
    args = parse_args([
        "--network", "yolo3_tiny_darknet", "--dataset", "voc",
        "--data-shape", str(SIZE), "--batch-size", str(BATCH), "--port", "0",
        "--thresh", "0.0", "--platform", "cpu",
    ])
    srv = serve_forever(args, setup_logging())
    yield srv
    srv.shutdown()
    srv.server_close()
    srv.viddet_service.close()


def _post(port, data, query=""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/detect{query}", data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _status(port, data, query="", path="/detect"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}{query}", data=data,
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(req, timeout=60)
    return info.value.code, json.loads(info.value.read())


def test_http_replies_equal_jax_json_of_the_direct_call(server):
    """One request at a time, so each is alone in its padded batch; the
    direct call pads the same way and gives the same tensors."""
    port = server.server_address[1]
    model, class_names = build_model("yolo3_tiny_darknet", "voc", device="cpu")
    load_weights_or_seed(model, "")
    predictor = make_predictor(model)
    transform = ValTransform(size=(SIZE, SIZE), letterbox_resize=True, normalize=False)
    kept = 0
    for name, data in _uploads().items():
        for thresh in (0.0, 0.3):
            got = _post(port, data, f"?thresh={thresh}")
            rgb = decode_image_bytes(data)
            x, _, affine = transform(rgb)
            ids, scores, boxes = (t.numpy() for t in predictor(
                to_device_batch(x[None], BATCH, torch.device("cpu"))))
            want = jax_detections_to_json(ids[0], scores[0],
                                          invert_affine_to_boxes(boxes[0], affine),
                                          class_names, thresh)
            want["width"], want["height"] = rgb.shape[1], rgb.shape[0]
            assert got == want, f"{name} thresh {thresh}"
            kept += len(got["detections"])
    assert kept > 0
    # EXIF orientation 6 turns the 90x60 upload upright: 60 wide, 90 high
    assert _post(port, _uploads()["jpeg_exif6"])["width"] == 60


def test_healthz_reports_the_model(server):
    port = server.server_address[1]
    _post(port, _uploads()["jpeg"])
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok"
    assert health["network"] == "yolo3_tiny_darknet" and health["num_classes"] == 20
    assert health["batch_size"] == BATCH and health["data_shape"] == SIZE
    assert health["requests_served"] >= 2  # the warm-up request and this one


@pytest.mark.parametrize("body,query,path,code", [
    (b"not an image", "", "/detect", 400),
    (b"\xff\xd8\xff\xe0" + bytes(40), "", "/detect", 400),  # a JPEG cut short
    (b"\x89PNG\r\n\x1a\n" + bytes(30), "", "/detect", 400),  # a broken PNG
    (b"", "", "/detect", 400),
    (None, "?thresh=abc", "/detect", 400),
    (None, "", "/nowhere", 404),
])
def test_bad_requests_get_an_error_not_a_fallback(server, body, query, path, code):
    port = server.server_address[1]
    status, payload = _status(port, _uploads()["jpeg"] if body is None else body, query, path)
    assert status == code and "error" in payload


def test_decode_image_bytes_equals_jax():
    for name, data in _uploads().items():
        np.testing.assert_array_equal(decode_image_bytes(data), jax_decode_image_bytes(data),
                                      err_msg=name)
    with pytest.raises(ValueError):
        decode_image_bytes(b"not an image")


def test_detections_to_json_equals_jax():
    rng = np.random.default_rng(2)
    names = [f"c{i}" for i in range(5)]
    ids = rng.integers(-1, 5, 30)
    scores = rng.random(30).astype(np.float32)
    boxes = (rng.random((30, 4)) * 500).astype(np.float32)
    for thresh in (0.0, 0.25, 0.9, 1.1):
        assert detections_to_json(ids, scores, boxes, names, thresh) == \
            jax_detections_to_json(ids, scores, boxes, names, thresh)
