"""The port's ops.  Importing this package registers every hand-written
kernel as a custom op in the ``viddet`` namespace (``torch.ops.viddet.*``):
K1 ``anchor_scores``, K3 ``gather_decode_pairs`` and ``gather_decode_top_m``,
K4 ``finalize_candidates`` (``nms_gather_cuda.py``), K2 ``topk_indices``
(``topk_cuda.py``), K5 ``nms_keep_mask`` and K6 ``compact_and_pad``
(``nms_cuda.py``), K7 ``multilevel_roi_align`` (``roi_align_cuda.py``) and
K8 ``conv_down2_bn_leaky`` (``conv_cuda.py``).  Each op's CUDA
implementation is its kernel's launch (the kernel's wrapper counts it
there), its CPU implementation the plain version, and its fake
implementation the fixed shapes of its outputs, which is what
``torch.export`` needs to carry a kernel inside an artifact
(``infer/export.py``).  A process that loads such an artifact imports this
package first."""

from viddet_tpu_torch.ops import (  # noqa: F401  (registers the ops)
    conv_cuda,
    nms_cuda,
    nms_gather_cuda,
    roi_align_cuda,
    topk_cuda,
)

OP_NAMES = ("anchor_scores", "topk_indices", "gather_decode_pairs", "gather_decode_top_m",
            "finalize_candidates", "nms_keep_mask", "compact_and_pad", "multilevel_roi_align",
            "conv_down2_bn_leaky")
