"""K2 ``topk_indices``: exact top-k index set per row, ascending indices.

Replaces ``viddet_tpu/ops/topk_pallas.py:237`` ``topk_indices_pallas``
(``_select_kernel``, ``:62``).  The CUDA kernel is ``csrc/topk_select.cu``.
The result is the index SET of ``lax.top_k`` (ties at the k-th value taken
lowest index first), in ascending index order.

Precondition, as in the JAX package: scores are >= 0 apart from -1.0
padding, with at least k non-negative entries per row, and 0 < k <= N.
The wrapper checks k; checking the data would need a device sync, so the
kernel writes -1 into the slots of a row that breaks it, and the plain
version raises.
"""

from __future__ import annotations

import torch

from viddet_tpu_torch.kernels import build, require

_HI_BITS = 0x7F800000 + 1  # exclusive bound of the search: +inf's bit pattern
_SEARCH_ITERS = 31
# One row lives in shared memory: 4 bytes per score within the 227 KB a
# block may use on an H100.
MAX_N = 56 * 1024


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
    if not bool((mask.sum(dim=1) == k).all()):
        raise ValueError("topk_indices: a row has fewer than k non-negative scores")
    return mask.nonzero()[:, 1].reshape(b, k)


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """K2 wrapper: the kernel for CUDA tensors, the plain version on the CPU."""
    if scores.device.type == "cpu":
        return topk_indices_plain(scores, k)
    if scores.dim() != 2:
        raise ValueError(f"topk_indices: expected (B, N), got {tuple(scores.shape)}")
    b, n = scores.shape
    _check_k(n, k)
    if n > MAX_N:
        raise ValueError(f"topk_indices: N={n} exceeds the kernel's {MAX_N}")
    require(scores, "scores", torch.float32)
    out = torch.empty((b, k), dtype=torch.int64, device=scores.device)
    err = build.library().viddet_topk_indices(
        scores.data_ptr(), b, n, k, out.data_ptr(), build.stream_of(out)
    )
    build.check(err, "topk_indices")
    topk_indices.launches += 1
    return out


topk_indices.launches = 0
