"""Packed dataset shards (copy of ``viddet_tpu/data/packed.py``): simple
length-prefixed shards that stream sequentially, one seek per record.

Shard layout (little-endian):
  header:  magic b"VDTP0001"
  records: [u32 meta_len][meta json utf-8][u32 payload_len][payload bytes]
  meta:    {"label": [[x1,y1,x2,y2,cls,diff(,track)]...], "id": <str>,
            "shape": null}  — payload is the raw (typically JPEG) image file.

An index file (<shard>.idx, one "offset size" pair per line) gives O(1)
random access.  A record's payload is decoded with the port's JPEG decoder
and turned upright by its EXIF orientation, as ``cv2.imdecode`` does in the
JAX package.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from viddet_tpu_torch.data.base import DetectionDataset, decode_rgb

MAGIC = b"VDTP0001"


def write_shard(path: str, records) -> int:
    """records: iterable of (image_bytes, label ndarray, id str). Returns count."""
    count = 0
    with open(path, "wb") as f, open(path + ".idx", "w") as idx:
        f.write(MAGIC)
        for payload, label, rec_id in records:
            meta = json.dumps(
                {"label": np.asarray(label, np.float32).tolist(), "id": str(rec_id)}
            ).encode()
            offset = f.tell()
            f.write(struct.pack("<I", len(meta)))
            f.write(meta)
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)
            idx.write(f"{offset} {f.tell() - offset}\n")
            count += 1
    return count


def pack_dataset(dataset: DetectionDataset, out_prefix: str,
                 shard_size: int = 1024, split: str = "") -> List[str]:
    """Pack any DetectionDataset with an ``image_path`` into shards."""
    shards = []
    buf = []
    shard_idx = 0

    def flush():
        nonlocal buf, shard_idx
        if not buf:
            return
        path = f"{out_prefix}-{shard_idx:05d}.vdtp"
        write_shard(path, buf)
        shards.append(path)
        shard_idx += 1
        buf = []

    for i in range(len(dataset)):
        with open(dataset.image_path(i), "rb") as f:
            payload = f.read()
        buf.append((payload, dataset.label(i), i))
        if len(buf) >= shard_size:
            flush()
    flush()
    # sidecar metadata so '--dataset packed --data-root <prefix>' can
    # reconstruct the class set without the source dataset
    with open(f"{out_prefix}.meta.json", "w") as f:
        json.dump(
            {
                "classes": list(dataset.classes),
                "wn_classes": list(getattr(dataset, "wn_classes", ())),
                "num_records": len(dataset),
                "shards": [os.path.basename(s) for s in shards],
                "split": split,
            },
            f,
            indent=2,
        )
    return shards


def open_packed(prefix_or_dir: str, split: str = "") -> "PackedDetection":
    """Open packed shards by prefix (or a directory holding exactly one
    packed set): reads ``<prefix>.meta.json`` for classes and the exact
    shard list (never a glob — sibling sets sharing a prefix, e.g.
    ``voc-train`` next to ``voc-train-aug``, must not merge).

    ``split``: when given and the sidecar recorded a different split at
    pack time, raise — a training CLI silently validating on its training
    shards is the failure this guards."""
    import glob as _glob

    prefix = prefix_or_dir
    if os.path.isdir(prefix_or_dir):
        metas = sorted(_glob.glob(os.path.join(prefix_or_dir, "*.meta.json")))
        if len(metas) != 1:
            raise ValueError(
                f"{prefix_or_dir!r} holds {len(metas)} packed sets; pass the "
                "shard prefix itself (e.g. /data/packed/voc-train)"
            )
        prefix = metas[0][: -len(".meta.json")]
    meta_path = f"{prefix}.meta.json"
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"{meta_path} not found — write shards with pack_dataset"
        )
    with open(meta_path) as f:
        meta = json.load(f)
    packed_split = meta.get("split", "")
    if split and packed_split and split != packed_split:
        raise ValueError(
            f"{meta_path} was packed from split {packed_split!r} but "
            f"{split!r} was requested — pack each split separately and pass "
            "both, e.g. --data-root trainprefix,valprefix"
        )
    base = os.path.dirname(prefix)
    if meta.get("shards"):
        shards = [os.path.join(base, s) for s in meta["shards"]]
        missing = [s for s in shards if not os.path.exists(s)]
        if missing:
            raise FileNotFoundError(f"shards listed in {meta_path} missing: {missing}")
    else:  # pre-sidecar-era sets: fall back to the glob
        shards = sorted(_glob.glob(f"{prefix}-*.vdtp"))
    if not shards:
        raise FileNotFoundError(f"no shards for {prefix} found")
    return PackedDetection(
        shards, meta["classes"], meta.get("wn_classes") or None
    )


class PackedDetection(DetectionDataset):
    """Reads shards written by ``pack_dataset``/``write_shard``.

    classes must be supplied (the packed label carries numeric ids only).
    """

    def __init__(self, shards: Sequence[str], classes: Sequence[str],
                 wn_classes: Optional[Sequence[str]] = None):
        self.classes = tuple(classes)
        # fallback wnids must be UNIQUE per class: CombinedDetection keys
        # its class union by wnid, and N copies of "" would collapse every
        # class into one.  Keying by display name keeps same-named classes
        # from different packed sets aligned, which is the sane default.
        self.wn_classes = tuple(
            wn_classes or (f"name:{c}" for c in self.classes)
        )
        self._entries: List[Tuple[str, int, int]] = []  # (shard, offset, size)
        for shard in shards:
            with open(shard + ".idx") as idx:
                for line in idx:
                    offset, size = line.split()
                    self._entries.append((shard, int(offset), int(size)))
        self._fds = {}
        self._fds_lock = threading.Lock()

    def _fd(self, shard: str) -> int:
        # Raw fd + os.pread: positionless reads are safe from the loader's
        # concurrent worker threads (a shared seek+read cursor is not).
        with self._fds_lock:
            fd = self._fds.get(shard)
            if fd is None:
                fd = os.open(shard, os.O_RDONLY)
                if os.pread(fd, len(MAGIC), 0) != MAGIC:
                    os.close(fd)
                    raise ValueError(f"bad shard magic: {shard}")
                self._fds[shard] = fd
        return fd

    def __len__(self):
        return len(self._entries)

    def __del__(self):
        # At interpreter shutdown module globals (os, even TypeError) may
        # already be torn down — swallow everything; fds die with the
        # process anyway.
        try:
            for fd in getattr(self, "_fds", {}).values():
                try:
                    os.close(fd)
                except OSError:
                    pass
        except Exception:
            pass

    def _read(self, idx: int):
        shard, offset, size = self._entries[idx]
        buf = os.pread(self._fd(shard), size, offset)
        (meta_len,) = struct.unpack_from("<I", buf, 0)
        meta = json.loads(buf[4 : 4 + meta_len])
        (payload_len,) = struct.unpack_from("<I", buf, 4 + meta_len)
        payload = buf[8 + meta_len : 8 + meta_len + payload_len]
        label = np.asarray(meta["label"], np.float32)
        if label.size == 0:
            label = np.zeros((0, 6), np.float32)
        return payload, label

    def label(self, idx: int) -> np.ndarray:
        return self._read(idx)[1]

    def __getitem__(self, idx: int):
        payload, label = self._read(idx)
        return decode_rgb(payload, f"record {idx}"), label
