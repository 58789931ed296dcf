"""viddet_tpu_torch: the PyTorch / CUDA port of ``viddet_tpu``.

The JAX package beside this one is the reference; this package imports
nothing of it (nor of JAX) and keeps its own copy of what it needs.

Public functions take and return NHWC tensors, as the JAX package does.
Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``
(``core.platform.resolve_device``).  The hand-written Hopper kernels
(``csrc/*.cu``) are built on first use by ``kernels.build``; a kernel's
wrapper launches it for a CUDA tensor and runs its plain PyTorch version
for a CPU tensor.
"""
