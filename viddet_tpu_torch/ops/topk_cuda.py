"""K2 ``topk_indices``: exact top-k index set per row, ascending indices.

Replaces ``viddet_tpu/ops/topk_pallas.py:237`` ``topk_indices_pallas``
(``_select_kernel``, ``:62``).  The CUDA kernel is ``csrc/topk_select.cu``:
a radix select over a thread-block cluster per row (``cluster_size``).
The result is the index SET of ``lax.top_k`` (ties at the k-th value taken
lowest index first), in ascending index order.

Precondition, as in the JAX package: scores are >= 0 apart from -1.0
padding, with at least k non-negative entries per row, and 0 < k <= N.
The wrapper checks k; checking the data would need a device sync, so the
kernel writes -1 into the slots of a row that breaks it, and the plain
version raises (but not while ``torch.export`` traces it: an artifact
checks no data, as the kernel does not).

The kernel is the custom op ``viddet::topk_indices`` (``ops/__init__.py``):
its CUDA implementation launches the kernel, its CPU implementation is
the plain version, and its fake implementation gives the output's shape,
so that ``torch.export`` can carry the kernel inside an artifact.
"""

from __future__ import annotations

import torch

from viddet_tpu_torch.kernels import build, on_card, require

_HI_BITS = 0x7F800000 + 1  # exclusive bound of the search: +inf's bit pattern
_SEARCH_ITERS = 31
MAX_N = 56 * 1024
# The kernel runs a cluster of up to MAX_CLUSTER blocks per row (the
# portable cluster size); each block keeps its slice of the row in shared
# memory, at most SLICE_MAX scores (4 bytes each, beside ~10 KB of
# histograms, within the 227 KB a block may use on an H100).
MAX_CLUSTER = 8
SLICE_MAX = 48 * 1024


def _check_k(n: int, k: int) -> None:
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= N, got k={k}, N={n}")


def topk_indices_plain(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) float32 -> (B, k) int64 indices, ascending (see module doc)."""
    b, n = scores.shape
    _check_k(n, k)
    bits = scores.float().contiguous().view(torch.int32)
    lo = torch.zeros((b, 1), dtype=torch.int32, device=scores.device)
    hi = torch.full((b, 1), _HI_BITS, dtype=torch.int32, device=scores.device)
    for _ in range(_SEARCH_ITERS):
        mid = lo + (hi - lo) // 2
        ge = (bits >= mid).sum(dim=1, keepdim=True) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    gt, tie = bits > lo, bits == lo
    need = k - gt.sum(dim=1, keepdim=True)
    tie_rank = torch.cumsum(tie, dim=1) - tie.long()  # exclusive
    mask = gt | (tie & (tie_rank < need))
    if not torch.compiler.is_compiling() and not bool((mask.sum(dim=1) == k).all()):
        raise ValueError("topk_indices: a row has fewer than k non-negative scores")
    # the k set positions in ascending order: a stable sort keeps index order
    return torch.sort(mask.to(torch.uint8), dim=1, descending=True, stable=True).indices[:, :k]


def cluster_size(b: int, n: int, num_sms: int) -> int:
    """Blocks per row: the largest power of two up to MAX_CLUSTER with
    ``b * size <= num_sms`` (at least 1), so that the batch fills the SMs
    in one wave, raised until a row's slice fits in shared memory."""
    size = 1
    while size < MAX_CLUSTER and b * size * 2 <= num_sms:
        size *= 2
    while size < MAX_CLUSTER and -(-n // size) > SLICE_MAX:
        size *= 2
    return size


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """K2 wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if scores.device.type == "cpu":
        return topk_indices_plain(scores, k)
    on_card(scores, "topk_indices")
    return torch.ops.viddet.topk_indices(scores, k)


@torch.library.custom_op("viddet::topk_indices", mutates_args=(), device_types="cpu")
def _topk_indices_op(scores: torch.Tensor, k: int) -> torch.Tensor:
    return topk_indices_plain(scores, k).contiguous()


@_topk_indices_op.register_kernel("cuda")
def _topk_indices_cuda(scores: torch.Tensor, k: int) -> torch.Tensor:
    if scores.dim() != 2:
        raise ValueError(f"topk_indices: expected (B, N), got {tuple(scores.shape)}")
    b, n = scores.shape
    _check_k(n, k)
    if n > MAX_N:
        raise ValueError(f"topk_indices: N={n} exceeds the kernel's {MAX_N}")
    require(scores, "scores", torch.float32)
    out = torch.empty((b, k), dtype=torch.int64, device=scores.device)
    sms = torch.cuda.get_device_properties(scores.device).multi_processor_count
    err = build.library().viddet_topk_indices(
        scores.data_ptr(), b, n, k, cluster_size(b, n, sms), out.data_ptr(), build.stream_of(out)
    )
    build.check(err, "topk_indices")
    topk_indices.launches += 1
    return out


@_topk_indices_op.register_fake
def _(scores: torch.Tensor, k: int) -> torch.Tensor:
    return scores.new_empty((scores.shape[0], k), dtype=torch.int64)


topk_indices.launches = 0
