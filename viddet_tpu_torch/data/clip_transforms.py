"""Clip (multi-frame) transforms (copy of
``viddet_tpu/data/clip_transforms.py:20-90``): every frame of a k-frame
clip goes through the same transform, so all share one geometry; for
training each frame's transform gets a generator seeded identically from
one draw of the clip's, so every random draw coincides.  The label is
transformed once."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from viddet_tpu_torch.data.transforms import TrainTransform, ValTransform


def _as_clip(clip: np.ndarray, k: int) -> np.ndarray:
    """A k-frame clip from ``clip``: a still (H, W, 3) image becomes a static
    clip (the frame repeated k times, which needs k >= 1); a true clip
    (k', H, W, 3) must have k' == k when k >= 1."""
    if clip.ndim == 3:
        if k < 1:
            raise ValueError(
                "got a still image but the clip transform has no k set; "
                "pass k= so stills can be tiled into static clips"
            )
        return np.repeat(clip[None], k, axis=0)
    if k >= 1 and clip.shape[0] != k:
        raise ValueError(f"clip has {clip.shape[0]} frames but the model expects k={k}")
    return clip


@dataclasses.dataclass
class ClipTrainTransform:
    size: Tuple[int, int]
    letterbox_resize: bool = False
    k: int = 0  # 0 = require true clips; >=1 also tiles stills to k frames
    normalize: bool = True  # False: uint8 clips, normalized in the train step

    def __post_init__(self):
        self._frame_tf = TrainTransform(size=self.size, letterbox_resize=self.letterbox_resize,
                                        normalize=self.normalize)

    def __call__(self, clip: np.ndarray, label: np.ndarray, rng: np.random.Generator):
        """clip (k, H, W, 3) uint8 (or a still (H, W, 3) with k set) ->
        ((k, h, w, 3) float32 or uint8, the transformed label)."""
        clip = _as_clip(clip, self.k)
        self._frame_tf.size = self.size
        seed = int(rng.integers(0, 2**63 - 1))
        frames, out_label = [], None
        for f in clip:
            img, out_label = self._frame_tf(f, label.copy(), np.random.default_rng(seed))
            frames.append(img)
        return np.stack(frames), out_label


@dataclasses.dataclass
class ClipValTransform:
    size: Tuple[int, int]
    letterbox_resize: bool = False
    k: int = 0  # 0 = require true clips; >=1 also tiles stills to k frames
    normalize: bool = True  # False: uint8 clips, normalized on the device

    def __post_init__(self):
        self._frame_tf = ValTransform(size=self.size, letterbox_resize=self.letterbox_resize,
                                      normalize=self.normalize)

    def __call__(self, clip: np.ndarray, label: Optional[np.ndarray] = None):
        """clip (k, H, W, 3) uint8 -> ((k, h, w, 3) float32 or uint8, label,
        affine)."""
        clip = _as_clip(clip, self.k)
        frames = []
        out_label, affine = label, None
        for f in clip:
            img, out_label, affine = self._frame_tf(f, label)
            frames.append(img)
        return np.stack(frames), out_label, affine
