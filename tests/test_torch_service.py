"""The port's serving path on the CPU: DetectionService, predictor, transform."""

import threading
import time

import numpy as np
import pytest
import torch

from viddet_tpu.data.transforms import ValTransform as JaxValTransform
from viddet_tpu_torch.cli.common import make_predictor
from viddet_tpu_torch.core.precision import FLOAT32_POLICY
from viddet_tpu_torch.data.transforms import ValTransform, invert_affine_to_boxes
from viddet_tpu_torch.infer.service import DetectionService
from viddet_tpu_torch.models.yolo3 import NMSConfig
from viddet_tpu_torch.models.zoo import get_model
from viddet_tpu_torch.weights import init_flat, load_flat

SIZE = 64
NMS = NMSConfig(topk=64, post_nms=16, valid_thresh=0.001)


@pytest.fixture(scope="module")
def predictor():
    model, _ = get_model("yolo3_tiny_darknet_coco", device="cpu", policy=FLOAT32_POLICY)
    load_flat(model, init_flat("yolo3_tiny_darknet_coco", seed=5))
    return make_predictor(model, NMS)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [(48, 80), (64, 64), (90, 50)]
    return [rng.integers(0, 256, sizes[i % 3] + (3,), dtype=np.uint8) for i in range(n)]


def test_concurrent_detect_equals_direct_batched_call(predictor):
    frames = _frames(12)
    transform = ValTransform((SIZE, SIZE), normalize=False)
    answers = [None] * len(frames)
    errors = []
    with DetectionService(predictor, transform, batch_size=4, flush_ms=20.0,
                          device="cpu") as svc:
        def client(offset):
            try:
                for i in range(offset, len(frames), 3):
                    answers[i] = svc.detect(frames[i], timeout=60)
            except Exception as exc:  # noqa: BLE001 -- asserted below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(o,)) for o in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = svc.stats()
    assert not errors
    assert stats["requests_served"] == len(frames)

    prepared = [transform(f) for f in frames]
    batch = torch.from_numpy(np.stack([p[0] for p in prepared]))
    ids, scores, boxes = (t.numpy() for t in predictor(batch))
    assert (ids >= 0).sum() > 0
    for i, (_, _, affine) in enumerate(prepared):
        got = answers[i]
        np.testing.assert_array_equal(got[0], ids[i])
        # one image's detections do not depend on its batch neighbours
        # beyond float32 summation order
        np.testing.assert_allclose(got[1], scores[i], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[2], invert_affine_to_boxes(boxes[i], affine),
                                   rtol=0, atol=1e-3)


def test_uint8_and_float_inputs_agree(predictor):
    frames = _frames(2, seed=3)
    raw = [ValTransform((SIZE, SIZE), normalize=False)(f)[0] for f in frames]
    norm = [ValTransform((SIZE, SIZE), normalize=True)(f)[0] for f in frames]
    a = predictor(torch.from_numpy(np.stack(raw)))
    b = predictor(torch.from_numpy(np.stack(norm)))
    assert torch.equal(a[0], b[0])
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=0, atol=1e-5)


def test_close_fails_waiting_requests():
    release = threading.Event()

    def slow_infer(images):
        release.wait(10)
        b = images.shape[0]
        return (torch.full((b, 4), -1.0), torch.full((b, 4), -1.0), torch.full((b, 4, 4), -1.0))

    transform = ValTransform((16, 16), normalize=False)
    svc = DetectionService(slow_infer, transform, batch_size=1, flush_ms=0.0,
                           max_in_flight=1, device="cpu")
    results, errors = [], []

    def client():
        try:
            results.append(svc.detect(np.zeros((16, 16, 3), np.uint8), timeout=30))
        except RuntimeError as exc:
            errors.append(exc)

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    # the first request is in flight; the others wait in the queue
    for _ in range(500):
        if svc._q.qsize() >= 2:
            break
        time.sleep(0.01)
    closer = threading.Thread(target=svc.close)
    closer.start()
    for _ in range(500):  # release the batch only once close() has begun
        if svc._stop.is_set():
            break
        time.sleep(0.01)
    release.set()
    closer.join(timeout=30)
    for t in threads:
        t.join(timeout=30)
    assert not closer.is_alive() and not any(t.is_alive() for t in threads)
    assert len(results) + len(errors) == 3
    assert errors and all("closed" in str(e) for e in errors)
    with pytest.raises(RuntimeError):
        svc.detect(np.zeros((16, 16, 3), np.uint8))


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("shape", [(480, 640), (101, 37), (200, 200)])
def test_val_transform_matches_jax_within_one_level(letterbox, shape):
    rng = np.random.default_rng(sum(shape))
    image = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    size = (96, 128)
    got, _, got_affine = ValTransform(size, letterbox_resize=letterbox, normalize=False)(image)
    want, _, want_affine = JaxValTransform(size, letterbox_resize=letterbox,
                                           normalize=False)(image)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_affine, want_affine)
    label = np.array([[10, 20, 30, 40, 1], [-1, -1, -1, -1, -1]], np.float32)
    _, got_label, _ = ValTransform(size, letterbox_resize=letterbox)(image, label)
    _, want_label, _ = JaxValTransform(size, letterbox_resize=letterbox)(image, label)
    np.testing.assert_array_equal(got_label, want_label)
