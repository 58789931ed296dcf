"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), and the objects are linked into
one shared library with a plain C interface that ``ctypes`` loads.  No
source includes PyTorch's headers, so a build takes seconds, and the
link needs no ``-lcuda``: K8's TMA tensor maps are encoded through the
entry point that ``cudaGetDriverEntryPoint`` hands out.

The build runs at first use, into ``build/viddet_tpu_torch/<hash>/`` at
the repository root (``build/`` is git-ignored), keyed by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import time: the CPU tests import
every module of the package on a machine with no ``nvcc``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "viddet_tpu_torch"
LIB_NAME = "libviddet_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# No --use_fast_math anywhere.  The NMS file, the conv epilogue and the
# ROIAlign reproduce float expressions of their plain versions (the IoU;
# the affine then leaky; the bilinear taps and bin mean), so they also
# forbid multiply-add contraction.
SOURCE_FLAGS = {"nms.cu": ["-fmad=false"], "conv_down2.cu": ["-fmad=false"],
                "roi_align.cu": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every entry point returns int (a cudaError_t).
SIGNATURES = {
    "viddet_error_string": [_I],
    # raw0..raw2, cells0..cells2, nscales, batch, na, num_pred, is_bf16, out, stream
    "viddet_anchor_scores": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # scores, batch, n, k, cluster, out, stream
    "viddet_topk_indices": [_P, _I, _I, _I, _I, _P, _P],
    # boxes, valid, batch, k, iou_thresh, mask (scratch), keep, stream
    "viddet_nms_keep_mask": [_P, _P, _I, _I, _F, _P, _P, _P],
    # keep, scores, cls, boxes, batch, k, post, ids, out_scores, out_boxes, stream
    "viddet_compact_and_pad": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # raw0..raw2, cells0..cells2, width0..width2, strides, anchors (host
    # float arrays), nscales, batch, k, na, num_pred, is_bf16, idx, boxes,
    # pairs, stream
    "viddet_gather_decode": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # as viddet_gather_decode up to idx, then m, hot_j, boxes, v_m, i_m,
    # hot_flat, hot_idx, stream
    "viddet_gather_decode_top_m": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                                   _P],
    # i_m, hot_idx, q, boxes_k, batch, k, m, c, hot_j, topk, cls, cand, stream
    "viddet_finalize_candidates": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # x (NHWC), w, w_is_bf16, a, b (Cout float32), batch, h, w, cin, cout,
    # slope, is_bf16, chunk schedule (host int array or NULL), chunks, tile
    # rows, tile columns, tile channels, packed weights (scratch or NULL), out
    # (NHWC), stream
    "viddet_conv_down2_bn_leaky": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _I, _I,
                                   _I, _I, _P, _P, _P],
    # feat0..feat3, heights, widths, strides (host arrays), nlevels, batch,
    # rois per image, c, is_bf16, rois, levels, out, stream
    "viddet_roi_align": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # measurement probes (csrc/latency_probe.cu): the scan round (k,
    # passes, out, stream) and the launch floor (blocks, threads, dynamic
    # shared bytes, src and dst of the round-trip form or NULL, stream)
    "viddet_scan_round_probe": [_I, _I, _P, _P],
    "viddet_launch_floor_probe": [_I, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA machine")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(repr((ARCH_FLAGS, COMMON_FLAGS, SOURCE_FLAGS)).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    failures = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))


def build() -> Path:
    """Compile and link the library if this source hash has none yet."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tool = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs, cmds = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            cmds.append(
                [tool, *ARCH_FLAGS, *COMMON_FLAGS, *SOURCE_FLAGS.get(src.name, []),
                 "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            )
        _run_all(cmds)
        staged = Path(tmp) / LIB_NAME
        _run_all([[tool, *ARCH_FLAGS, "-shared", *objs, "-o", str(staged)]])
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(staged, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p if name == "viddet_error_string" else _I
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().viddet_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
