"""The port's CUDA kernels against their plain versions, at edge shapes.

These need a CUDA card and skip without one.  On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

``chip_smoke.py`` holds the kernels at the main paths' shapes; this file
covers the shapes around them (K not a multiple of 64, K = 1000 for
proposal NMS, k = N, one scale, float32 heads, few classes, m > C,
channel counts that are not multiples of 8, ROIAlign on one to four
levels with rois outside the image, on level boundaries and wider than
the TPU kernel's window) and the wrappers' refusals.  Every comparison is exact, except K8's,
which ``chip_smoke.k8_compare`` holds within one bf16 ulp (float32: 1e-5
relative) or, where the sum cancels, the float32 summation bound.
"""

import numpy as np
import pytest
import torch

from chip_smoke import k8_compare
from viddet_tpu_torch.core.platform import set_conv_backend
from viddet_tpu_torch.models import faster_rcnn
from viddet_tpu_torch.models.common import ConvBNLeaky
from viddet_tpu_torch.ops import conv_cuda, nms_cuda, nms_gather_cuda, roi_align_cuda, topk_cuda
from viddet_tpu_torch.ops.nms import multiclass_nms_late_decode_cells
from viddet_tpu_torch.ops.roi_align import fpn_roi_level, multilevel_roi_align_packed

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


@pytest.mark.parametrize("k", [1, 63, 64, 65, 400, 1000, 1024])
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


@pytest.mark.parametrize("ranking", ["hier", "det"])
@pytest.mark.parametrize("data", ["random", "ties"])
def test_tail_rankings_cuda_equal_plain(dev, ranking, data):
    rng = np.random.default_rng(7)
    anchors = ((116.0, 90.0), (156.0, 198.0), (373.0, 326.0))
    meta = tuple((w * w, w, 32 // (2 ** i), anchors) for i, w in enumerate((13, 26, 52)))
    cells = []
    for m in meta:
        x = rng.normal(0, 2, (3, m[0], 3 * 85)).astype(np.float32)
        if data == "ties":
            x = np.round(x)
        cells.append(torch.from_numpy(x).to(dev, torch.bfloat16))
    got = multiclass_nms_late_decode_cells(cells, meta, backend="auto", ranking=ranking)
    want = multiclass_nms_late_decode_cells(cells, meta, backend="plain", ranking=ranking)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def _meta(cells):
    anchors = ((10.0, 13.0), (33.0, 23.0), (373.0, 326.0))
    return tuple((c, int(round(c ** 0.5)), 32 // 2 ** i, anchors) for i, c in enumerate(cells))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cells,num_pred,k,m,hot_j", [
    ((9, 36), 9, 17, 9, 2),  # C = 4 < m: the steps past C give (-inf, 0)
    ((169,), 25, 400, 9, 45),
    ((169, 676, 2704), 85, 400, 9, 45),
    ((16, 64), 133, 100, 32, 100),  # C = 128, m = 32, hot_j = k
])
def test_gather_decode_top_m_equals_plain(dev, dtype, cells, num_pred, k, m, hot_j):
    g = _gen(len(cells) + num_pred + k + m)
    meta = _meta(cells)
    xs = [torch.randn((3, c, 3 * num_pred), generator=g).mul_(3).to(dev, dtype) for c in cells]
    xs[0][1] = xs[0][1].round().clamp(-1, 1)  # image 1: ties within rows and across boxes
    idx = torch.randint(0, sum(cells) * 3, (3, k), generator=g).to(dev)
    idx[2, : k // 2] = idx[2, k - k // 2 :]
    got = nms_gather_cuda.gather_decode_top_m(xs, idx, meta, m, hot_j)
    torch.cuda.synchronize()
    want = nms_gather_cuda.gather_decode_pairs_plain(xs, idx, meta, m, hot_j)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_gather_decode_top_m_refusals(dev):
    meta = _meta((4,))
    x = torch.rand((2, 4, 3 * 9), device=dev)
    idx = torch.zeros((2, 5), dtype=torch.int64, device=dev)
    for m, hot_j in ((0, 2), (33, 2), (9, 0), (9, 6)):
        with pytest.raises(ValueError):
            nms_gather_cuda.gather_decode_top_m([x], idx, meta, m, hot_j)
    wide = torch.rand((2, 4, 3 * 134), device=dev)  # C = 129
    with pytest.raises(ValueError):
        nms_gather_cuda.gather_decode_top_m([wide], idx, meta, 9, 2)


@pytest.mark.parametrize("b,k,m,c,hot_j,topk", [(2, 40, 9, 20, 5, 40), (3, 400, 9, 80, 45, 400),
                                                 (1, 7, 2, 3, 7, 12)])
def test_finalize_candidates_equals_plain(dev, b, k, m, c, hot_j, topk):
    g = _gen(k + c + topk)
    width = k * (m - 1)
    i_m = torch.randint(0, c, (b, k, m), generator=g)
    hot_idx = torch.randint(0, k, (b, 1, hot_j), generator=g)
    q = torch.randint(0, width + hot_j * c, (b, topk), generator=g)
    q[:, :4] = torch.tensor([0, width - 1, width, width + hot_j * c - 1])
    boxes_k = torch.rand((b, k, 4), generator=g) * 400
    args = [t.to(dev) for t in (i_m, hot_idx, q, boxes_k)]
    got = nms_gather_cuda.finalize_candidates(*args, c)
    torch.cuda.synchronize()
    want = nms_gather_cuda.finalize_candidates_plain(*args, c)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_finalize_candidates_refusals(dev):
    i_m = torch.zeros((2, 5, 9), dtype=torch.int64, device=dev)
    hot_idx = torch.zeros((2, 1, 2), dtype=torch.int64, device=dev)
    q = torch.zeros((2, 5), dtype=torch.int64, device=dev)
    boxes = torch.zeros((2, 5, 4), device=dev)
    with pytest.raises(TypeError):
        nms_gather_cuda.finalize_candidates(i_m.int(), hot_idx, q, boxes, 20)
    with pytest.raises(ValueError):
        nms_gather_cuda.finalize_candidates(i_m, hot_idx[:1], q, boxes, 20)
    with pytest.raises(ValueError):
        nms_gather_cuda.finalize_candidates(i_m, hot_idx, q, boxes[:, :4], 20)


def _conv_case(dev, b, cin, cout, h, w, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, cin, h, w), generator=g, device=dev).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.randn((cout, cin, 3, 3), generator=g, device=dev) * 0.2
    vecs = (torch.rand(cout, generator=g, device=dev) + 0.5,
            torch.randn(cout, generator=g, device=dev),
            torch.randn(cout, generator=g, device=dev) * 0.1,
            torch.rand(cout, generator=g, device=dev) + 0.5)
    return x, weight, vecs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cin,cout,h,w", [
    (2, 8, 16, 18, 18), (1, 3, 5, 6, 10),  # Cin, Cout not multiples of 8: scalar loads
    (3, 24, 40, 34, 12), (1, 255, 72, 8, 8), (2, 64, 136, 130, 66),
])
def test_conv_down2_equals_plain(dev, dtype, b, cin, cout, h, w):
    x, weight, vecs = _conv_case(dev, b, cin, cout, h, w, dtype, cin + cout)
    got = conv_cuda.conv_down2_bn_leaky(x, weight, *vecs)
    torch.cuda.synchronize()
    want = conv_cuda.conv_down2_bn_leaky_plain(x, weight, *vecs)
    assert got.shape == want.shape == (b, cout, h // 2, w // 2) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    k8_compare(got, want, x, weight, conv_cuda.fold_bn(*vecs, 1e-5)[0])


def test_conv_down2_refusals(dev):
    x, weight, vecs = _conv_case(dev, 1, 8, 16, 8, 8, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="even"):
        conv_cuda.conv_down2_bn_leaky(x[:, :, :7], weight, *vecs)
    with pytest.raises(TypeError):
        conv_cuda.conv_down2_bn_leaky(x.half(), weight, *vecs)
    with pytest.raises(ValueError, match="channels_last"):
        conv_cuda.conv_down2_bn_leaky(x.contiguous(), weight, *vecs)
    with pytest.raises(ValueError):
        conv_cuda.conv_down2_bn_leaky(x, weight[:, :4], *vecs)
    wide, wide_w, wide_vecs = _conv_case(dev, 1, 256, 8, 4, 4, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="Cin"):
        conv_cuda.conv_down2_bn_leaky(wide, wide_w, *wide_vecs)


def test_conv_bn_leaky_pallas_backend_launches_k8(dev):
    layer = ConvBNLeaky(32, 64, 3, stride=2).to(dev).eval()
    x = torch.randn((2, 32, 16, 16), device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    before = conv_cuda.conv_down2_bn_leaky.launches
    set_conv_backend("pallas")
    try:
        with torch.inference_mode():
            got = layer(x)
    finally:
        set_conv_backend("auto")
    assert conv_cuda.conv_down2_bn_leaky.launches == before + 1
    assert got.shape == (2, 64, 8, 8) and got.dtype == torch.bfloat16


def _roi_case(dev, b, r, c, image, levels, dtype, seed):
    """A pyramid of ``levels`` maps and rois of every kind: random, outside
    the image, 1e-3 wide, exactly on each level boundary, far below level 2
    and above level 5, and 8:1 / 1:8 wider than the TPU kernel's window."""
    g = _gen(seed)
    pyramid = [torch.randn((b, image // s, image // s, c), generator=g).to(dev, dtype)
               for s in (4, 8, 16, 32)[:levels]]
    pts = torch.rand((b, r, 2, 2), generator=g) * (image + 60) - 30
    rois = torch.cat([pts.amin(2), pts.amax(2)], dim=-1)
    edge = [[-50.0, -40.0, -10.0, -5.0], [image - 20.0, -30.0, image + 40.0, 25.0],
            [10.0, 10.0, 10.001, 10.001], [5.0, 5.0, 61.0, 61.0], [5.0, 5.0, 117.0, 117.0],
            [0.0, 0.0, 224.0, 224.0], [1.0, 2.0, 449.0, 450.0], [3.0, 3.0, 9.0, 9.0],
            [0.0, 0.0, 900.0, 900.0], [4.0, 8.0, 4.0 + 111.0 * 8 ** 0.5, 8.0 + 111.0 / 8 ** 0.5],
            [8.0, 4.0, 8.0 + 111.0 / 8 ** 0.5, 4.0 + 111.0 * 8 ** 0.5]]
    n = min(len(edge), r)
    rois[0, :n] = torch.tensor(edge[:n])
    return pyramid, rois.to(dev).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,r,c,image,levels", [
    (2, 300, 256, 512, 4),  # the Faster R-CNN path's shape at batch 2
    (1, 11, 2, 64, 1), (3, 50, 8, 128, 2), (2, 37, 258, 96, 3), (1, 20, 64, 640, 4),
])
def test_roi_align_equals_plain(dev, dtype, b, r, c, image, levels):
    pyramid, rois = _roi_case(dev, b, r, c, image, levels, dtype, b + r + c + image)
    strides = (4, 8, 16, 32)[:levels]
    before = roi_align_cuda.multilevel_roi_align.launches
    got = roi_align_cuda.multilevel_roi_align(pyramid, rois, strides)
    torch.cuda.synchronize()
    assert roi_align_cuda.multilevel_roi_align.launches == before + 1
    want = multilevel_roi_align_packed(pyramid, rois, strides)
    assert got.shape == want.shape == (b, r, 7, 7, c) and got.dtype == torch.float32
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_fpn_roi_level_at_the_boundaries_on_the_card(dev):
    sides = torch.tensor([56.0, 112.0, 224.0, 448.0], device=dev)
    zeros = torch.zeros_like(sides)
    rois = torch.stack([zeros, zeros, sides, sides], -1)
    assert fpn_roi_level(rois).tolist() == [2, 3, 4, 5]
    assert torch.equal(fpn_roi_level(rois).cpu(), fpn_roi_level(rois.cpu()))


def test_roi_align_refusals(dev):
    pyramid, rois = _roi_case(dev, 1, 4, 8, 64, 2, torch.float32, 0)
    with pytest.raises(ValueError, match="odd"):
        roi_align_cuda.multilevel_roi_align([p[..., :7].contiguous() for p in pyramid], rois,
                                            (4, 8))
    with pytest.raises(TypeError):
        roi_align_cuda.multilevel_roi_align([pyramid[0], pyramid[1].bfloat16()], rois, (4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        roi_align_cuda.multilevel_roi_align([pyramid[0].transpose(1, 2), pyramid[1]], rois,
                                            (4, 8))
    with pytest.raises(ValueError, match="output_size"):
        roi_align_cuda.multilevel_roi_align(pyramid, rois, (4, 8), output_size=14)
    with pytest.raises(ValueError, match="levels"):
        roi_align_cuda.multilevel_roi_align(pyramid * 3, rois, (4, 8) * 3)
    with pytest.raises(TypeError):
        roi_align_cuda.multilevel_roi_align(pyramid, rois.double(), (4, 8))


def test_frcnn_tail_cuda_equals_plain(dev):
    g = _gen(5)
    b, r, c = 2, 300, 80
    pts = torch.rand((b, r, 2, 2), generator=g) * 512
    proposals = torch.cat([pts.amin(2), pts.amax(2) + 2], dim=-1).to(dev)
    logits = torch.randn((b, r, c + 1), generator=g).mul(3).round().to(dev)  # ties
    deltas = torch.randn((b, r, c, 4), generator=g).to(dev)
    for valid in (0.05, 0.001):
        got = faster_rcnn.frcnn_postprocess(proposals, logits, deltas, (512, 512),
                                            valid_thresh=valid, backend="auto")
        want = faster_rcnn.frcnn_postprocess(proposals, logits, deltas, (512, 512),
                                             valid_thresh=valid, backend="plain")
        assert all(torch.equal(a, w) for a, w in zip(got, want))
