"""The port's CUDA kernels against their plain versions, at edge shapes.

These need a CUDA card and skip without one.  On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

``chip_smoke.py`` holds the kernels at the main paths' shapes; this file
covers the shapes around them (K not a multiple of 64, K = 1000 for
proposal NMS, k = N, one scale, float32 heads, few classes, m > C,
heads at any storage offset and with NaN, channel counts that are not
multiples of 8, ROIAlign on one to four levels with rois outside the
image, on level boundaries, wider than the TPU kernel's window and
reading the most distinct cells a roi can, levels at a 4-byte offset)
and the wrappers' refusals.  Every comparison is exact, except K8's,
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
from viddet_tpu_torch.ops.roi_align import (
    fpn_roi_level, multilevel_roi_align_packed, sample_grid,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


CELLS_416 = (169, 676, 2704)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cells,num_pred", [
    (3, (9, 36), 9), (3, (169,), 85), (3, (4, 16, 64), 85),
    (1, CELLS_416, 85), (32, CELLS_416, 85), (128, CELLS_416, 85), (32, CELLS_416, 9),
])
def test_anchor_scores_equals_plain(dev, dtype, b, cells, num_pred):
    g = _gen(b + len(cells) + num_pred)
    xs = [torch.randn((b, c, 3 * num_pred), generator=g).mul_(4).to(dev, dtype) for c in cells]
    got = nms_gather_cuda.anchor_scores(xs, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_gather_cuda.anchor_scores_plain(xs, 3))


@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("num_pred", [9, 85])
def test_anchor_scores_at_any_storage_offset(dev, offset, num_pred):
    """bf16 cells viewed ``offset`` elements into their storage, so the
    blocks' spans start at every misalignment to 16 bytes."""
    g = _gen(offset + num_pred)
    xs = []
    for c in (13, 52, 100):
        n = 4 * c * 3 * num_pred
        flat = torch.randn(n + 8, generator=g).mul_(4).to(dev, torch.bfloat16)
        xs.append(flat[offset:offset + n].view(4, c, 3 * num_pred))
        assert xs[-1].is_contiguous() and xs[-1].storage_offset() == offset
    got = nms_gather_cuda.anchor_scores(xs, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_gather_cuda.anchor_scores_plain(xs, 3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_anchor_scores_nan_signed_zero_and_ties(dev, dtype):
    g = _gen(3)
    x = torch.randn((2, 169, 3 * 85), generator=g).round()  # many tied class maxima
    v = x.view(2, 169, 3, 85)
    v[0, 0, 0, 40] = float("nan")  # a NaN class logit wins the max
    v[0, 1, 1, 5:] = -0.0
    v[0, 1, 2, 5:] = 0.0
    v[0, 2, 0, 5::2] = -0.0  # -0.0 and 0.0 tied for the max
    v[0, 3, 1, 4] = float("nan")  # a NaN objectness
    v[1, :, :, 5:] = 2.0  # every class tied
    xs = [x.to(dev, dtype)]
    got = nms_gather_cuda.anchor_scores(xs, 3)
    torch.cuda.synchronize()
    want = nms_gather_cuda.anchor_scores_plain(xs, 3)
    assert torch.equal(got.isnan(), want.isnan()) and got[0, 0].isnan()
    assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))


# The kernel takes 16 consecutive winners of the flat (B*k) order a block:
# k = 17 and 401 do not divide that run (the last block is ragged), C =
# 1, 4, 20, 30 and 80 (4*C not a multiple of 16 for most), batch 1 to 128.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cells,num_pred,k", [
    (3, (9, 36), 9, 17), (3, (169,), 85, 400), (3, (169, 676, 2704), 85, 400),
    (3, (16, 64), 6, 401), (3, (49,), 25, 401), (3, (49, 196), 35, 17),
    (1, CELLS_416, 85, 400), (3, CELLS_416, 85, 401), (128, CELLS_416, 85, 400),
    (128, CELLS_416, 85, 401),
])
def test_gather_decode_pairs_equals_plain(dev, dtype, b, cells, num_pred, k):
    g = _gen(b + len(cells) + num_pred + k)
    anchors = ((10.0, 13.0), (33.0, 23.0), (373.0, 326.0))
    meta = tuple((c, int(round(c ** 0.5)), 32 // 2 ** i, anchors) for i, c in enumerate(cells))
    xs = [torch.randn((b, c, 3 * num_pred), generator=g).mul_(3).to(dev, dtype) for c in cells]
    idx = torch.randint(0, sum(cells) * 3, (b, k), generator=g).to(dev)
    got = nms_gather_cuda.gather_decode_pairs(xs, idx, meta)
    torch.cuda.synchronize()
    want = nms_gather_cuda.gather_decode_pairs_plain(xs, idx, meta)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 1), (torch.bfloat16, 3),
                                          (torch.bfloat16, 0), (torch.float32, 1)])
@pytest.mark.parametrize("num_pred", [9, 85])
def test_gather_decode_pairs_nan_rows_and_any_storage_offset(dev, dtype, offset, num_pred):
    """Heads viewed ``offset`` elements into their storage (a bf16 row then
    starts at any 2-byte offset), winners at the first and last row of each
    scale's tensor, and indices -1 and N, whose box and pair rows are NaN."""
    g = _gen(offset + num_pred)
    cells = (9, 36, 144)
    meta = _meta(cells)
    xs = []
    for c in cells:
        n = 5 * c * 3 * num_pred
        flat = torch.randn(n + 8, generator=g).mul_(3).to(dev, dtype)
        xs.append(flat[offset:offset + n].view(5, c, 3 * num_pred))
        assert xs[-1].is_contiguous() and xs[-1].storage_offset() == offset
    total = sum(cells) * 3
    firsts = [0, 27, 27 + 108]  # each scale's first anchor; its last is the next minus 1
    idx = torch.randint(0, total, (5, 37), generator=g)
    idx[:, :6] = torch.tensor(firsts + [f - 1 for f in firsts[1:]] + [total - 1])
    bad = torch.zeros_like(idx, dtype=torch.bool)
    bad[1, 7], bad[4, 36], bad[2, 20] = True, True, True
    idx = idx.to(dev)
    got = nms_gather_cuda.gather_decode_pairs(xs, torch.where(bad.to(dev), -1, idx), meta)
    got_n = nms_gather_cuda.gather_decode_pairs(xs, torch.where(bad.to(dev), total, idx), meta)
    torch.cuda.synchronize()
    want = nms_gather_cuda.gather_decode_pairs_plain(xs, idx, meta)
    for out in (got, got_n):
        for a, w in zip(out, want):
            assert bool(a[bad].isnan().all())
            assert torch.equal(a[~bad], w[~bad])


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


def _topk_rows(g, b, n, data):
    """(b, n) scores: random, tie-heavy, -1-padded, or each row one edge
    case in turn (+0.0 beside -0.0, subnormals among zeros, all equal,
    padded, random)."""
    x = torch.rand((b, n), generator=g)
    if data == "ties":
        x = torch.randint(0, 3, (b, n), generator=g).float() / 2
    elif data == "padded":
        x[:, 1::3] = -1.0
    elif data == "edge":
        for r in range(b):
            case = r % 5
            if case == 0:
                x[r, ::3] = 0.0
                x[r, 1::3] = -0.0
            elif case == 1:
                x[r] = 0.0
                x[r, : min(n, 20)] = torch.rand(min(n, 20), generator=g) * 1e-38
                x[r, n // 2 :: 7] = torch.rand(len(range(n // 2, n, 7)), generator=g)
            elif case == 2:
                x[r] = 0.25
            elif case == 3:
                x[r, ::2] = -1.0
    return x


@pytest.mark.parametrize("b", [1, 8, 32, 48, 128])
@pytest.mark.parametrize("n,k", [(7, 3), (130, 130), (1000, 1), (6800, 400), (10647, 400),
                                 (24000, 400), (24001, 400), (56 * 1024, 400)])
@pytest.mark.parametrize("data", ["random", "ties", "padded", "edge"])
def test_topk_indices_equals_plain(dev, b, n, k, data):
    """On an H100 (132 SMs) the batches run clusters of 8, 8, 4, 2 and 1
    blocks a row (``topk_cuda.cluster_size``; N = 56 Ki raises 1 to 2).
    N = 7, 10647 and 24001 are not multiples of any cluster size; k is
    capped at the fewest non-negative scores of a row (k = N where none is
    padding)."""
    x = _topk_rows(_gen(n + k + b), b, n, data)
    k = min(k, int((x.view(torch.int32) >= 0).sum(1).min()))
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


@pytest.mark.parametrize("b,n", [(2, 50), (1, 24000), (8, 24001), (32, 10647), (48, 6800),
                                 (128, 10647)])
def test_topk_indices_marks_rows_that_break_the_precondition(dev, b, n):
    k = 20
    x = torch.rand((b, n), device=dev)
    x[0] = -1.0
    x[0, :10] = 0.5
    x[0, n - 3 :] = -0.0
    got = topk_cuda.topk_indices(x, k)
    assert bool((got[0, 10:] == -1).all()) and bool((got[0, :10] == torch.arange(10, device=dev)).all())
    assert torch.equal(got[1:], topk_cuda.topk_indices_plain(x[1:], k))


def _nms_rows(g, b, k):
    """(b, k, 4) boxes and (b, k) valid, each image one case in turn:
    random, duplicated runs, all invalid, all valid and heavily
    overlapping, one box repeated."""
    pts = torch.rand((b, k, 2, 2), generator=g) * 100
    boxes = torch.cat([pts.amin(2), pts.amax(2)], dim=-1)
    valid = torch.rand((b, k), generator=g) > 0.1
    for r in range(b):
        case = r % 5
        if case == 1:
            boxes[r, 1::3] = boxes[r, 0::3][: boxes[r, 1::3].shape[0]]
        elif case == 2:
            valid[r] = False
        elif case == 3:
            boxes[r] = torch.tensor([20.0, 20.0, 60.0, 60.0]) + torch.rand((k, 4), generator=g) * 8
            valid[r] = True
        elif case == 4:
            boxes[r] = boxes[r, :1]
            valid[r] = True
    return boxes, valid


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 400, 1000, 1024])
def test_nms_keep_mask_equals_plain(dev, b, k):
    boxes, valid = _nms_rows(_gen(k + b), b, k)
    boxes, valid = boxes.to(dev), valid.to(dev)
    for thresh in (0.3, 0.45, 0.7):
        got = nms_cuda.nms_keep_mask(boxes, valid, thresh)
        torch.cuda.synchronize()
        assert torch.equal(got, nms_cuda.nms_keep_mask_plain(boxes, valid, thresh))
    if b >= 5:
        assert got[2].sum().item() == 0 and got[4].sum().item() == 1


def test_nms_keep_mask_refusals(dev):
    boxes = torch.rand((1, nms_cuda.MAX_K + 1, 4), device=dev)
    with pytest.raises(ValueError):
        nms_cuda.nms_keep_mask(boxes, torch.ones((1, nms_cuda.MAX_K + 1), dtype=torch.bool,
                                                 device=dev), 0.5)
    with pytest.raises(TypeError):
        nms_cuda.nms_keep_mask(torch.rand((1, 8, 4), device=dev),
                               torch.ones((1, 8), device=dev), 0.5)


def test_nms_keep_mask_takes_boxes_at_any_float_offset(dev):
    boxes, valid = _nms_rows(_gen(3), 4, 65)
    flat = torch.empty(boxes.numel() + 1, device=dev)
    flat[1:] = boxes.reshape(-1).to(dev)
    unaligned = flat[1:].view(boxes.shape)  # each box starts 4 bytes off 16
    valid = valid.to(dev)
    got = nms_cuda.nms_keep_mask(unaligned, valid, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_cuda.nms_keep_mask_plain(unaligned, valid, 0.45))


def test_nms_keep_mask_batch_past_65535(dev):
    """The mask kernel's grid holds the batch in x, whose limit is 2**31 - 1."""
    boxes, valid = _nms_rows(_gen(4), 70_000, 3)
    boxes, valid = boxes.to(dev), valid.to(dev)
    got = nms_cuda.nms_keep_mask(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_cuda.nms_keep_mask_plain(boxes, valid, 0.45))


def _compact_rows(k, post, b=5):
    g = _gen(k + post)
    keep = (torch.rand((b, k), generator=g) > 0.5).float()
    keep[0] = 1.0
    keep[1] = 0.0
    scores = torch.sort(torch.rand((b, k), generator=g), dim=1, descending=True).values
    cls = torch.randint(0, 80, (b, k), generator=g).float()
    boxes = torch.rand((b, k, 4), generator=g) * 400
    return keep, scores, cls, boxes


# k past 1024 runs the kernel's tile loop; post > k fills past the kept rows.
@pytest.mark.parametrize("k,post", [(400, 100), (37, 100), (1, 1), (300, 299), (1024, 1000),
                                    (1025, 1025), (2000, 1500), (2000, 100), (5, 2000),
                                    (400, 1100)])
def test_compact_and_pad_equals_plain(dev, k, post):
    args = [t.to(dev) for t in _compact_rows(k, post)]
    got = nms_cuda.compact_and_pad(*args, post)
    torch.cuda.synchronize()
    want = nms_cuda.compact_and_pad_plain(*args, post)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_compact_and_pad_takes_inputs_at_a_4_byte_offset(dev, offset):
    """Every input viewed ``offset`` floats into its storage, so no box row
    is 16-byte aligned."""
    views = []
    for t in _compact_rows(400, 100):
        flat = torch.zeros(t.numel() + offset, device=dev)
        flat[offset:] = t.reshape(-1).to(dev)
        views.append(flat[offset:].view(t.shape))
        assert views[-1].storage_offset() == offset
    got = nms_cuda.compact_and_pad(*views, 100)
    torch.cuda.synchronize()
    want = nms_cuda.compact_and_pad_plain(*views, 100)
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


# The kernel runs a cluster per image, of ceil(k / 64) blocks (at most 8)
# where the batch fits the card at once, else of ceil(k / 32): k around a
# block's 64 winners (1 to 65), the main path's 400 (7 blocks) and 401, k
# around 8 blocks of one round each (512, 513), several rounds a block
# (1000, 4000), the largest k the two-kernel design's 48 KB of shared memory
# took, and batch 128, whose clusters do not all fit at once.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cells,num_pred,k,m,hot_j", [
    (3, (9, 36), 9, 17, 9, 2),  # C = 4 < m: the steps past C give (-inf, 0)
    (3, (169,), 25, 400, 9, 45),
    (3, CELLS_416, 85, 400, 9, 45),
    (3, (16, 64), 133, 100, 32, 100),  # C = 128, m = 32, hot_j = k
    (3, CELLS_416, 85, 1, 9, 1),
    (3, CELLS_416, 85, 7, 9, 7),
    (3, CELLS_416, 85, 9, 9, 5),
    (3, CELLS_416, 85, 64, 9, 45),
    (3, CELLS_416, 85, 65, 9, 45),
    (3, CELLS_416, 85, 401, 9, 45),
    (3, CELLS_416, 85, 512, 9, 45),
    (3, CELLS_416, 85, 513, 9, 45),
    (3, CELLS_416, 85, 400, 9, 1),
    (1, CELLS_416, 85, 400, 9, 45),
    (128, CELLS_416, 85, 400, 9, 45),
    (128, CELLS_416, 85, 65, 9, 45),
    (128, CELLS_416, 85, 1000, 9, 45),
    (3, CELLS_416, 85, 1000, 9, 45),
    (3, CELLS_416, 85, 4000, 9, 400),
    (2, CELLS_416, 85, 12000, 9, 45),
])
def test_gather_decode_top_m_equals_plain(dev, dtype, b, cells, num_pred, k, m, hot_j):
    g = _gen(len(cells) + num_pred + k + m)
    meta = _meta(cells)
    xs = [torch.randn((b, c, 3 * num_pred), generator=g).mul_(3).to(dev, dtype) for c in cells]
    idx = torch.randint(0, sum(cells) * 3, (b, k), generator=g).to(dev)
    if b > 1:
        xs[0][1] = xs[0][1].round().clamp(-1, 1)  # image 1: ties within rows and across boxes
    if b > 2:
        idx[2, : k // 2] = idx[2, k - k // 2 :]
    got = nms_gather_cuda.gather_decode_top_m(xs, idx, meta, m, hot_j)
    torch.cuda.synchronize()
    want = nms_gather_cuda.gather_decode_pairs_plain(xs, idx, meta, m, hot_j)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,k", [(2, 400), (2, 1000), (128, 400)])
def test_gather_decode_top_m_all_ninth_values_tie(dev, dtype, b, k):
    """As chip_smoke.py's image 3: objectness all equal and class logits on
    three levels, so every winner's 9th value ties and the hot rows are the
    lowest winner indices, ranked across every block of the cluster."""
    g = _gen(b + k)
    meta = _meta(CELLS_416)
    xs = []
    for c in CELLS_416:
        x = torch.randn((b, c, 3, 85), generator=g).mul_(3)
        x[1, ..., 4] = 1.0
        x[1, ..., 5:] = x[1, ..., 5:].round().clamp(-1, 1)
        xs.append(x.view(b, c, 255).to(dev, dtype))
    idx = torch.sort(torch.randperm(sum(CELLS_416) * 3, generator=g)[:k]).values
    idx = idx.expand(b, k).contiguous().to(dev)
    got = nms_gather_cuda.gather_decode_top_m(xs, idx, meta, 9, 45)
    torch.cuda.synchronize()
    want = nms_gather_cuda.gather_decode_pairs_plain(xs, idx, meta, 9, 45)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    ninth = got[1][1, :, 8]
    assert bool((ninth == ninth[0]).all())
    assert got[4][1, 0].tolist() == list(range(45))


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


# The kernel stages an image's boxes and hot ids in shared memory and
# resolves a winner a thread: winners from either section or both, topk
# above k, batch 1 to 128.
@pytest.mark.parametrize("section", ["both", "candidates", "hot"])
@pytest.mark.parametrize("b,k,m,c,hot_j,topk", [(2, 40, 9, 20, 5, 40), (3, 400, 9, 80, 45, 400),
                                                 (1, 7, 2, 3, 7, 12), (1, 400, 9, 80, 45, 400),
                                                 (128, 400, 9, 80, 45, 400),
                                                 (3, 100, 9, 80, 45, 1100)])
def test_finalize_candidates_equals_plain(dev, section, b, k, m, c, hot_j, topk):
    g = _gen(k + c + topk)
    width = k * (m - 1)
    i_m = torch.randint(0, c, (b, k, m), generator=g)
    hot_idx = torch.randint(0, k, (b, 1, hot_j), generator=g)
    lo, hi = {"both": (0, width + hot_j * c), "candidates": (0, width),
              "hot": (width, width + hot_j * c)}[section]
    q = torch.randint(lo, hi, (b, topk), generator=g)
    q[:, :2] = torch.tensor([lo, hi - 1])
    boxes_k = torch.rand((b, k, 4), generator=g) * 400
    args = [t.to(dev) for t in (i_m, hot_idx, q, boxes_k)]
    got = nms_gather_cuda.finalize_candidates(*args, c)
    torch.cuda.synchronize()
    want = nms_gather_cuda.finalize_candidates_plain(*args, c)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_finalize_candidates_out_of_range_gives_nan(dev):
    """A q outside [0, k*(m-1) + J*C), or a hot id outside [0, k), writes
    a NaN class and box; every other winner equals the plain version."""
    b, k, m, c, hot_j, topk = 2, 50, 9, 20, 6, 64
    g = _gen(5)
    width = k * (m - 1)
    i_m = torch.randint(0, c, (b, k, m), generator=g)
    hot_idx = torch.randint(0, k, (b, 1, hot_j), generator=g)
    hot_idx[1, 0, 2], hot_idx[1, 0, 4] = -1, k  # hot rows 2 and 4 of image 1
    q = torch.randint(0, width, (b, topk), generator=g)
    q[0, :3] = torch.tensor([-1, width + hot_j * c, 2**40])
    q[1, :2] = torch.tensor([width + 2 * c + 3, width + 4 * c])
    bad = torch.zeros((b, topk), dtype=torch.bool)
    bad[0, :3], bad[1, :2] = True, True
    boxes_k = torch.rand((b, k, 4), generator=g) * 400
    args = [t.to(dev) for t in (i_m, hot_idx, q, boxes_k)]
    cls, cand = nms_gather_cuda.finalize_candidates(*args, c)
    torch.cuda.synchronize()
    want = nms_gather_cuda.finalize_candidates_plain(
        i_m.to(dev), hot_idx.clamp(0, k - 1).to(dev), torch.where(bad, 0, q).to(dev),
        boxes_k.to(dev), c)
    bad = bad.to(dev)
    assert bool(cls[bad].isnan().all()) and bool(cand[bad].isnan().all())
    assert torch.equal(cls[~bad], want[0][~bad]) and torch.equal(cand[~bad], want[1][~bad])


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
    big = 15_000  # an image's boxes past a block's shared memory
    with pytest.raises(ValueError):
        nms_gather_cuda.finalize_candidates(
            torch.zeros((2, big, 9), dtype=torch.int64, device=dev), hot_idx, q,
            torch.zeros((2, big, 4), device=dev), 20)


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


# Darknet-53's three K8 layers at 416 px: (Cin, Cout, H = W)
K8_PATH_LAYERS = ((32, 64, 416), (64, 128, 208), (128, 256, 104))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cin,cout,h,w", [
    (2, 8, 16, 18, 18), (1, 3, 5, 6, 10),  # Cin, Cout not multiples of 8: scalar loads
    (3, 24, 40, 34, 12), (1, 255, 72, 8, 8), (2, 64, 136, 130, 66),
    # the path's three layers at batch 2
    *((2, cin, cout, hw, hw) for cin, cout, hw in K8_PATH_LAYERS),
    # Cin giving ragged 64-channel chunks (2*Cin or Cin not a multiple of 64)
    (1, 4, 16, 18, 26), (2, 40, 64, 26, 18), (1, 96, 128, 52, 52), (1, 192, 64, 20, 28),
    (1, 248, 16, 18, 18),
    # Cout past one N tile, or not a multiple of 64
    (1, 32, 8, 26, 26), (2, 16, 24, 18, 52), (1, 64, 256, 26, 26), (1, 32, 264, 18, 18),
    # W/2 and H/2 that no tile side divides
    (1, 32, 64, 18, 104), (1, 64, 128, 52, 26), (2, 16, 32, 104, 208), (1, 32, 64, 208, 52),
])
def test_conv_down2_equals_plain(dev, dtype, b, cin, cout, h, w):
    x, weight, vecs = _conv_case(dev, b, cin, cout, h, w, dtype, cin + cout)
    got = conv_cuda.conv_down2_bn_leaky(x, weight, *vecs)
    torch.cuda.synchronize()
    want = conv_cuda.conv_down2_bn_leaky_plain(x, weight, *vecs)
    assert got.shape == want.shape == (b, cout, h // 2, w // 2) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    k8_compare(got, want, x, weight, conv_cuda.fold_bn(*vecs, 1e-5)[0])


def _k8_kernels_run(fn) -> set:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if "_kernel" in e.key}


@pytest.mark.parametrize("cin,cout,hw", K8_PATH_LAYERS)
def test_conv_down2_path_layers_take_the_tma_route(dev, cin, cout, hw):
    x, weight, vecs = _conv_case(dev, 2, cin, cout, hw, hw, torch.bfloat16, cin)
    assert conv_cuda.route(x, cout) == "tma"
    ran = _k8_kernels_run(lambda: conv_cuda.conv_down2_bn_leaky(x, weight, *vecs))
    assert any("conv_bf16_tma_kernel" in k for k in ran), ran
    assert any("pack_weights_kernel" in k for k in ran), ran
    assert not any("scalar" in k for k in ran), ran


def test_conv_down2_unaligned_x_takes_the_scalar_route(dev):
    b, cin, cout, h, w = 2, 32, 64, 18, 26
    x, weight, vecs = _conv_case(dev, b, cin, cout, h, w, torch.bfloat16, 5)
    base = torch.empty(x.numel() + 8, dtype=x.dtype, device=dev)
    nhwc = base[1:1 + x.numel()].view(b, h, w, cin)
    nhwc.copy_(x.permute(0, 2, 3, 1))
    shifted = nhwc.permute(0, 3, 1, 2)  # channels_last, 2 bytes past a 16-byte boundary
    assert shifted.is_contiguous(memory_format=torch.channels_last)
    assert shifted.data_ptr() % 16 and conv_cuda.route(shifted, cout) == "scalar"
    got = conv_cuda.conv_down2_bn_leaky(shifted, weight, *vecs)
    ran = _k8_kernels_run(lambda: conv_cuda.conv_down2_bn_leaky(shifted, weight, *vecs))
    assert any("conv_bf16_scalar_kernel" in k for k in ran), ran
    assert not any("tma" in k for k in ran), ran
    want = conv_cuda.conv_down2_bn_leaky_plain(x, weight, *vecs)
    k8_compare(got, want, x, weight, conv_cuda.fold_bn(*vecs, 1e-5)[0])


@pytest.mark.parametrize("b,cin,cout,hw", [(16, 32, 64, 416), (32, 64, 128, 208)])
def test_conv_down2_many_tiles_per_persistent_block(dev, b, cin, cout, hw):
    """Path layers at a batch whose tiles outnumber the SMs tenfold: each
    persistent block walks many tiles, so the ring's phases wrap often
    and the producer runs ahead across tile boundaries."""
    x, weight, vecs = _conv_case(dev, b, cin, cout, hw, hw, torch.bfloat16, b)
    h2 = hw // 2
    r, c = conv_cuda.tile_shape(h2, h2)
    tiles = b * -(-h2 // r) * -(-h2 // c) * -(-cout // conv_cuda.tile_n(cout))
    assert tiles >= 10 * torch.cuda.get_device_properties(dev).multi_processor_count
    got = conv_cuda.conv_down2_bn_leaky(x, weight, *vecs)
    want = conv_cuda.conv_down2_bn_leaky_plain(x, weight, *vecs)
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
    (8, 300, 256, 512, 4),  # the Faster R-CNN path's shape
    (2, 300, 256, 512, 4),
    (1, 11, 2, 64, 1), (3, 50, 8, 128, 2), (2, 37, 258, 96, 3), (1, 20, 64, 640, 4),
])
def test_roi_align_equals_plain(dev, dtype, b, r, c, image, levels):
    """Every channel-slice geometry of the kernel (512 bytes a block: C = 2,
    8 and 64 in one partial slice, 256 in one whole bf16 slice or two
    float32 ones, 258 with a ragged last slice read 4 bytes at a time),
    rois with every sample outside the image, larger than the image and
    8:1 / 1:8, at the path's batch 8 x 300."""
    pyramid, rois = _roi_case(dev, b, r, c, image, levels, dtype, b + r + c + image)
    strides = (4, 8, 16, 32)[:levels]
    before = roi_align_cuda.multilevel_roi_align.launches
    got = roi_align_cuda.multilevel_roi_align(pyramid, rois, strides)
    torch.cuda.synchronize()
    assert roi_align_cuda.multilevel_roi_align.launches == before + 1
    want = multilevel_roi_align_packed(pyramid, rois, strides)
    assert got.shape == want.shape == (b, r, 7, 7, c) and got.dtype == torch.float32
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [256, 258])
def test_roi_align_widest_roi_reads_28_rows_and_columns(dev, dtype, c):
    """Rois whose 14 samples per side are over two cells apart on a one-level
    pyramid: each reads 28 distinct rows and 28 distinct columns, the most a
    roi can, so no two taps share a cell."""
    g = _gen(c)
    pyramid = [torch.randn((2, 64, 64, c), generator=g).to(dev, dtype)]
    rois = torch.tensor([[[8.0, 8.0, 128.0, 128.0], [3.0, 5.0, 130.0, 127.0]],
                         [[120.0, 2.0, 250.0, 140.0], [0.5, 100.0, 125.0, 254.0]]], device=dev)
    ys, xs = sample_grid(rois, torch.zeros((2, 2), dtype=torch.long, device=dev), (4,), 7, 2)
    for coord in (ys, xs):
        lo = coord.clamp(0, 63).floor().long()
        taps = torch.stack([lo, (lo + 1).clamp_max(63)], -1).flatten(-2)
        assert all(len(set(t.tolist())) == 28 for t in taps.flatten(0, 1))
    got = roi_align_cuda.multilevel_roi_align(pyramid, rois, (4,))
    torch.cuda.synchronize()
    assert torch.equal(got, multilevel_roi_align_packed(pyramid, rois, (4,)))


@pytest.mark.parametrize("offset", [2, 6])
def test_roi_align_takes_a_level_at_a_4_byte_offset(dev, offset):
    """A bf16 level viewed ``offset`` elements into its storage: its cells
    are 4-byte but not 16-byte aligned, so the kernel reads them 4 bytes at
    a time."""
    pyramid, rois = _roi_case(dev, 2, 60, 256, 256, 4, torch.bfloat16, offset)
    shifted = []
    for p in pyramid:
        flat = torch.empty(p.numel() + 8, dtype=p.dtype, device=dev)
        view = flat[offset:offset + p.numel()].view(p.shape)
        view.copy_(p)
        assert view.is_contiguous() and view.data_ptr() % 16 == 2 * offset
        shifted.append(view)
    got = roi_align_cuda.multilevel_roi_align(shifted, rois, (4, 8, 16, 32))
    torch.cuda.synchronize()
    assert torch.equal(got, multilevel_roi_align_packed(pyramid, rois, (4, 8, 16, 32)))


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


def _counting(monkeypatch):
    """Launch counts of the tail's wrappers from here on."""
    kernels = {"anchor_scores": nms_gather_cuda.anchor_scores,
               "topk_indices": topk_cuda.topk_indices,
               "gather_decode_pairs": nms_gather_cuda.gather_decode_pairs,
               "gather_decode_top_m": nms_gather_cuda.gather_decode_top_m,
               "finalize_candidates": nms_gather_cuda.finalize_candidates,
               "nms_keep_mask": nms_cuda.nms_keep_mask,
               "compact_and_pad": nms_cuda.compact_and_pad}
    for fn in kernels.values():
        monkeypatch.setattr(fn, "launches", 0)
    return lambda: {name: fn.launches for name, fn in kernels.items() if fn.launches}


@pytest.mark.parametrize("aggregation", ["stack", "max", "mean", "conv"])
def test_temporal_tail_cuda_equals_plain(dev, aggregation, monkeypatch):
    """The tiny k = 3 VID model in bf16 with seeded weights on uint8 clips:
    one predictor call launches the hierarchical tail's kernels, and both
    kernel tails equal their plain tails on the same head outputs."""
    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.models.zoo import get_model
    from viddet_tpu_torch.weights import init_flat, load_flat

    name = "yolo3_tiny_darknet_k3_vid"
    model, _ = get_model(name, aggregation=aggregation)
    load_flat(model, init_flat(name, seed=1, aggregation=aggregation))
    clips = torch.randint(0, 256, (4, 3, 96, 96, 3), generator=_gen(3), dtype=torch.uint8)
    count = _counting(monkeypatch)
    ids, scores, boxes = make_predictor(model)(clips.to(dev))
    torch.cuda.synchronize()
    assert count() == {"anchor_scores": 1, "topk_indices": 2, "gather_decode_top_m": 1,
                       "finalize_candidates": 1, "nms_keep_mask": 1, "compact_and_pad": 1}
    assert ids.shape == (4, 100) and bool(torch.isfinite(scores).all())
    with torch.inference_mode():
        out = model(clips.to(dev).float() / 255.0)
    for ranking in ("hier", "det"):
        got = multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"], ranking=ranking)
        want = multiclass_nms_late_decode_cells(out["raws_cells"], out["meta"], ranking=ranking,
                                                backend="plain")
        assert all(torch.equal(a, w) for a, w in zip(got, want))


DENSE_CASES = [(2, 300, 6, 64), (2, 30, 6, 400), (1, 700, 80, 400), (1, 1000, 80, 400)]


@pytest.mark.parametrize("entry,b,n,c,topk", [
    *[(e, *case) for e in ("dense_two_stage", "multiclass_nms", "from_logits")
      for case in DENSE_CASES],
    ("dense_two_stage", 3, 24564, 20, 400), ("from_logits", 3, 24564, 20, 400),
    ("multiclass_nms", 2, 2800, 20, 400),  # N*C = 56,000
    ("multiclass_nms", 2, 10647, 80, 400),  # YOLOv3-416 COCO: N*C = 851,760
    ("dense_two_stage", 2, 60000, 4, 400), ("from_logits", 2, 60000, 4, 400),  # N > MAX_N
])
def test_dense_nms_cuda_equals_plain(dev, entry, b, n, c, topk):
    """The dense entry points on the card against their plain chain, with
    tie-heavy scores; at N = 30, C = 6 the pair ranking is padded to topk
    (30 * 6 = 180 < 400).  Rankings wider than K2's MAX_N (N*C = 80,000
    and 851,760; N = 60,000) go through K2 in slices."""
    from viddet_tpu_torch.ops import nms as torch_nms

    g = _gen(n + c)
    pts = torch.rand((b, n, 2, 2), generator=g) * 512
    boxes = torch.cat([pts.amin(2), pts.amax(2) + 2], dim=-1).to(dev)
    scores = torch.softmax(torch.randn((b, n, c + 1), generator=g).mul(2).round(), -1)
    scores = scores[..., 1:].contiguous().to(dev)
    logits = torch.randn((b, n, c + 1), generator=g).mul(2).round().to(dev)
    kw = dict(iou_thresh=0.45, valid_thresh=0.01, topk=topk, post_nms=100)

    def run(backend):
        if entry == "dense_two_stage":
            return torch_nms.multiclass_nms_dense_two_stage(boxes, scores, backend=backend, **kw)
        if entry == "multiclass_nms":
            return torch_nms.multiclass_nms(boxes, scores, backend=backend, **kw)
        return torch_nms.multiclass_nms_from_logits(boxes, logits[..., :1], logits[..., 1:],
                                                    backend=backend, **kw)

    assert all(torch.equal(a, w) for a, w in zip(run("auto"), run("plain")))


def test_ssd_predictor_cuda_equals_plain(dev, monkeypatch):
    """A shallow SSD in bf16 on the card: one predictor call launches K2
    twice, K5 and K6 once, and the kernel tail equals the plain tail."""
    from viddet_tpu_torch.cli.common import make_predictor
    from viddet_tpu_torch.models import ssd
    from viddet_tpu_torch.models.yolo3 import NMSConfig

    torch.manual_seed(0)
    model = ssd.SSD(20, 256, backbone_blocks=(1, 1, 1, 1), backbone_widths=(8, 16, 32, 64))
    model = model.to(dev, memory_format=torch.channels_last).eval()
    frames = torch.randint(0, 256, (4, 256, 256, 3), generator=_gen(7), dtype=torch.uint8)
    count = _counting(monkeypatch)
    ids, scores, boxes = make_predictor(model, NMSConfig(valid_thresh=0.0))(frames.to(dev))
    torch.cuda.synchronize()
    assert count() == {"topk_indices": 2, "nms_keep_mask": 1, "compact_and_pad": 1}
    assert bool((ids >= 0).any())
    with torch.inference_mode():
        out = model(frames.to(dev).float() / 255.0)
    for valid in (0.0, 0.01):
        cfg = ssd.SSDNMSConfig(valid_thresh=valid)
        got = ssd.ssd_postprocess(out, cfg)
        want = ssd.ssd_postprocess(out, ssd.SSDNMSConfig(valid_thresh=valid, backend="plain"))
        assert all(torch.equal(a, w) for a, w in zip(got, want))
