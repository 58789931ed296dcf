"""Animated GIF writing without PIL: a palette per frame (median cut, then a
few k-means rounds), LZW and the GIF89a blocks.

The JAX package saves its GIFs through PIL (``Image.save(save_all=True)``),
which quantises each frame with its median cut.  This quantiser is not
PIL's bit for bit: the k-means rounds after the cut move each palette
entry to the mean of the colours it serves, so a frame comes out at least
about as close to the original as PIL's (``tests/test_torch_visualise.py``
holds the PSNR).  Timing and looping are PIL's: each frame's delay is
``int(duration_ms / 10)`` hundredths of a second, and ``loop`` goes into a
NETSCAPE2.0 block.
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np

COLORS = 256  # palette entries, 8-bit LZW codes
KMEANS_ROUNDS = 4
_CHUNK = 16384  # colours per block of the nearest-palette search


def _nearest(colors: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Index of the nearest palette entry (squared RGB distance) per colour."""
    out = np.empty(len(colors), np.int64)
    p2 = (palette ** 2).sum(1)
    for start in range(0, len(colors), _CHUNK):
        c = colors[start : start + _CHUNK]
        d = p2[None, :] - 2.0 * (c @ palette.T)  # + |c|^2, the same for every entry
        out[start : start + _CHUNK] = d.argmin(1)
    return out


def _sse(colors: np.ndarray, weights: np.ndarray) -> float:
    mean = (colors * weights[:, None]).sum(0) / weights.sum()
    return float((((colors - mean) ** 2) * weights[:, None]).sum())


def quantize(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> (palette (n, 3) uint8 with n <= ``COLORS``, (H, W)
    uint8 indices).  Median cut splits the box of colours with the largest
    squared error at the median (by pixel count) of its widest channel,
    until there are ``COLORS`` boxes; k-means rounds then refine the box
    means."""
    flat = rgb.reshape(-1, 3).astype(np.int32)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    cols = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1).astype(np.float64)
    counts = counts.astype(np.float64)
    if len(uniq) <= COLORS:
        return cols.astype(np.uint8), inverse.reshape(rgb.shape[:2]).astype(np.uint8)
    boxes = [np.arange(len(uniq))]
    errors = [_sse(cols, counts)]
    while len(boxes) < COLORS:
        i = int(np.argmax(errors))
        if errors[i] <= 0:
            break
        box = boxes[i]
        c = cols[box]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = box[np.argsort(c[:, axis], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2)) + 1, 1), len(order) - 1)
        boxes[i], errors[i] = order[:cut], _sse(cols[order[:cut]], counts[order[:cut]])
        boxes.append(order[cut:])
        errors.append(_sse(cols[order[cut:]], counts[order[cut:]]))
    centers = np.stack([(cols[b] * counts[b, None]).sum(0) / counts[b].sum() for b in boxes])
    for _ in range(KMEANS_ROUNDS):
        assign = _nearest(cols, centers)
        weight = np.bincount(assign, weights=counts, minlength=len(centers))
        used = weight > 0
        for ch in range(3):
            sums = np.bincount(assign, weights=counts * cols[:, ch], minlength=len(centers))
            centers[used, ch] = sums[used] / weight[used]
    palette = np.clip(np.rint(centers), 0, 255)
    assign = _nearest(cols, palette)
    return palette.astype(np.uint8), assign[inverse].reshape(rgb.shape[:2]).astype(np.uint8)


def lzw(indices: np.ndarray) -> bytes:
    """GIF's variable-width LZW of a flat array of 8-bit palette indices
    (minimum code size 8), codes packed least significant bit first, a
    clear code first and whenever the table reaches 4096 codes."""
    min_code_size = 8
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    size, next_code = min_code_size + 1, end + 1
    table: dict = {}

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = indices.tolist()
    emit(clear)
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code == 4096:
            emit(clear)
            table.clear()
            size, next_code = min_code_size + 1, end + 1
        else:
            table[key] = next_code
            if next_code == 1 << size:
                size += 1
            next_code += 1
        prefix = k
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    blocks = b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255]
                      for i in range(0, len(data), 255))
    return blocks + b"\0"


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int, loop: int = 0) -> None:
    """Frames (H, W, 3) uint8 RGB, all one size, -> an animated GIF89a: the
    first frame's palette global, every other frame's local."""
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    delay = int(duration_ms / 10)
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0)]  # 256-entry global table
    for i, frame in enumerate(frames):
        if frame.shape[:2] != (h, w):
            raise ValueError(f"GIF frame {i} is {frame.shape[:2]}, not {(h, w)}")
        palette, indices = quantize(frame)
        table = palette.tobytes() + bytes(3 * (COLORS - len(palette)))
        if i == 0:
            parts += [table, b"\x21\xff\x0bNETSCAPE2.0", struct.pack("<BBHB", 3, 1, loop, 0)]
        parts.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0))
        parts.append(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0 if i == 0 else 0x87))
        if i:
            parts.append(table)
        parts += [b"\x08", _sub_blocks(lzw(indices.reshape(-1)))]
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))
