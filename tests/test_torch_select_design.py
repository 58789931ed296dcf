"""Launch geometry of K2 and K5 on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).
Here the Python side of their launches is checked: K2's cluster size per
(B, N) and K5's scratch shape.
"""

import pytest

from viddet_tpu_torch.ops import nms_cuda, topk_cuda

H100_SMS = 132


@pytest.mark.parametrize("b,n,want", [
    (8, 24000, 8),     # Faster R-CNN detection ranking: 64 blocks
    (32, 10647, 4),    # YOLOv3 stage 1: 128 blocks
    (32, 6800, 4),     # YOLOv3 stage 2 (hier)
    (1, 7, 8),
    (48, 10647, 2),
    (66, 1000, 2),
    (67, 1000, 1),
    (128, 10647, 1),   # YOLOv3 at batch 128: a full wave without a cluster
    (128, 6800, 1),
    (200, 56 * 1024, 2),  # raised until the slice fits in shared memory
])
def test_cluster_size(b, n, want):
    size = topk_cuda.cluster_size(b, n, H100_SMS)
    assert size == want
    assert -(-n // size) <= topk_cuda.SLICE_MAX


def test_cluster_size_never_exceeds_the_portable_limit():
    for b in (1, 2, 3, 5, 8, 16, 33, 132, 1000):
        for n in (1, 400, topk_cuda.MAX_N):
            size = topk_cuda.cluster_size(b, n, H100_SMS)
            assert size in (1, 2, 4, 8)
            assert -(-n // size) <= topk_cuda.SLICE_MAX


@pytest.mark.parametrize("b,k,words", [(8, 1000, 16), (32, 400, 7), (1, 1, 1), (3, 64, 1),
                                       (3, 65, 2), (2, 1024, 16)])
def test_nms_mask_shape(b, k, words):
    assert nms_cuda.mask_shape(b, k) == (b, words, k)
    assert words * 64 >= k > (words - 1) * 64

