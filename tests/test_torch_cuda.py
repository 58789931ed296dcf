"""The port's CUDA kernels against their plain versions, at edge shapes.

These need a CUDA card and skip without one.  On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

``chip_smoke.py`` holds the kernels at the main path's shapes; this file
covers the shapes around them (K not a multiple of 64, k = N, one scale,
float32 heads, few classes) and the wrappers' refusals.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from viddet_tpu_torch.ops import nms_cuda, nms_gather_cuda, topk_cuda
from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cells,num_pred", [((9, 36), 9), ((169,), 85), ((4, 16, 64), 85)])
def test_anchor_scores_equals_plain(dev, dtype, cells, num_pred):
    g = _gen(len(cells) + num_pred)
    xs = [torch.randn((3, c, 3 * num_pred), generator=g).mul_(4).to(dev, dtype) for c in cells]
    got = nms_gather_cuda.anchor_scores(xs, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_gather_cuda.anchor_scores_plain(xs, 3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cells,num_pred,k", [((9, 36), 9, 17), ((169,), 85, 400),
                                               ((169, 676, 2704), 85, 400)])
def test_gather_decode_pairs_equals_plain(dev, dtype, cells, num_pred, k):
    g = _gen(len(cells) + num_pred + k)
    anchors = ((10.0, 13.0), (33.0, 23.0), (373.0, 326.0))
    meta = tuple((c, int(round(c ** 0.5)), 32 // 2 ** i, anchors) for i, c in enumerate(cells))
    xs = [torch.randn((3, c, 3 * num_pred), generator=g).mul_(3).to(dev, dtype) for c in cells]
    idx = torch.randint(0, sum(cells) * 3, (3, k), generator=g).to(dev)
    got = nms_gather_cuda.gather_decode_pairs(xs, idx, meta)
    torch.cuda.synchronize()
    want = nms_gather_cuda.gather_decode_pairs_plain(xs, idx, meta)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_gather_decode_pairs_refusals(dev):
    anchors = ((10.0, 13.0), (33.0, 23.0), (373.0, 326.0))
    meta = ((4, 2, 32, anchors),)
    x = torch.rand((2, 4, 3 * 9), device=dev)
    with pytest.raises(TypeError):
        nms_gather_cuda.gather_decode_pairs([x], torch.zeros((2, 5), dtype=torch.int32,
                                                             device=dev), meta)
    with pytest.raises(ValueError):
        nms_gather_cuda.gather_decode_pairs([x], torch.zeros((3, 5), dtype=torch.int64,
                                                             device=dev), meta)
    with pytest.raises(ValueError):
        nms_gather_cuda.gather_decode_pairs([x, x], torch.zeros((2, 5), dtype=torch.int64,
                                                                device=dev), meta)


@pytest.mark.parametrize("n,k", [(7, 3), (130, 130), (1000, 1), (10647, 400), (56 * 1024, 400)])
@pytest.mark.parametrize("data", ["random", "ties", "padded"])
def test_topk_indices_equals_plain(dev, n, k, data):
    g = _gen(n + k)
    x = torch.rand((4, n), generator=g)
    if data == "ties":
        x = torch.randint(0, 3, (4, n), generator=g).float() / 2
    elif data == "padded":
        x[:, 1::3] = -1.0
        k = min(k, n - (n - 1 + 2) // 3)
    x = x.to(dev)
    got = topk_cuda.topk_indices(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got, topk_cuda.topk_indices_plain(x, k))


def test_topk_indices_refusals(dev):
    x = torch.rand((2, 10), device=dev)
    for k in (0, 11):
        with pytest.raises(ValueError):
            topk_cuda.topk_indices(x, k)
    with pytest.raises(TypeError):
        topk_cuda.topk_indices(x.double(), 3)
    with pytest.raises(ValueError):
        topk_cuda.topk_indices(x.t().contiguous().t(), 1)  # not contiguous
    with pytest.raises(ValueError):
        topk_cuda.topk_indices(torch.rand((1, topk_cuda.MAX_N + 1), device=dev), 4)


def test_topk_indices_marks_rows_that_break_the_precondition(dev):
    x = torch.full((2, 50), -1.0, device=dev)
    x[0, :10] = 0.5
    x[1] = torch.rand(50, device=dev)
    got = topk_cuda.topk_indices(x, 20)
    assert bool((got[0, 10:] == -1).all()) and bool((got[0, :10] == torch.arange(10, device=dev)).all())
    assert torch.equal(got[1:], topk_cuda.topk_indices_plain(x[1:], 20))


@pytest.mark.parametrize("k", [1, 63, 64, 65, 400, 1024])
def test_nms_keep_mask_equals_plain(dev, k):
    g = _gen(k)
    pts = torch.rand((3, k, 2, 2), generator=g) * 100
    boxes = torch.cat([pts.amin(2), pts.amax(2)], dim=-1)
    boxes[1, 1::3] = boxes[1, 0::3][: boxes[1, 1::3].shape[0]]
    valid = torch.rand((3, k), generator=g) > 0.1
    valid[2] = False
    boxes, valid = boxes.to(dev), valid.to(dev)
    for thresh in (0.3, 0.45, 0.7):
        got = nms_cuda.nms_keep_mask(boxes, valid, thresh)
        torch.cuda.synchronize()
        assert torch.equal(got, nms_cuda.nms_keep_mask_plain(boxes, valid, thresh))


def test_nms_keep_mask_refusals(dev):
    boxes = torch.rand((1, nms_cuda.MAX_K + 1, 4), device=dev)
    with pytest.raises(ValueError):
        nms_cuda.nms_keep_mask(boxes, torch.ones((1, nms_cuda.MAX_K + 1), dtype=torch.bool,
                                                 device=dev), 0.5)
    with pytest.raises(TypeError):
        nms_cuda.nms_keep_mask(torch.rand((1, 8, 4), device=dev),
                               torch.ones((1, 8), device=dev), 0.5)


@pytest.mark.parametrize("k,post", [(400, 100), (37, 100), (1, 1), (300, 299)])
def test_compact_and_pad_equals_plain(dev, k, post):
    g = _gen(k + post)
    b = 5
    keep = (torch.rand((b, k), generator=g) > 0.5).float()
    keep[0] = 1.0
    keep[1] = 0.0
    scores = torch.sort(torch.rand((b, k), generator=g), dim=1, descending=True).values
    cls = torch.randint(0, 80, (b, k), generator=g).float()
    boxes = torch.rand((b, k, 4), generator=g) * 400
    args = [t.to(dev) for t in (keep, scores, cls, boxes)]
    got = nms_cuda.compact_and_pad(*args, post)
    torch.cuda.synchronize()
    want = nms_cuda.compact_and_pad_plain(*args, post)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("num_classes,topk,post", [(4, 64, 16), (80, 400, 100)])
def test_tail_cuda_equals_plain(dev, num_classes, topk, post):
    rng = np.random.default_rng(num_classes)
    anchors = ((116.0, 90.0), (156.0, 198.0), (373.0, 326.0))
    meta = tuple((w * w, w, 32 // (2 ** i), anchors) for i, w in enumerate((4, 8, 16)))
    cells = tuple(
        torch.from_numpy(rng.normal(0, 2, (2, m[0], 3 * (5 + num_classes))).astype(np.float32))
        .to(dev, torch.bfloat16) for m in meta)
    got = multiclass_nms_late_decode_cells(cells, meta, topk=topk, post_nms=post, backend="auto")
    want = multiclass_nms_late_decode_cells(cells, meta, topk=topk, post_nms=post, backend="plain")
    assert all(torch.equal(a, w) for a, w in zip(got, want))
