"""Replay the committed fixtures, and seeded mutations of them, through every
decoding entry point of the port's native library (``native/*.cpp``): the
run that ``tests/test_torch_native_sanitize.py`` makes in a subprocess
whose library it built with sanitizers.

    python -m tests.torch_sanitize_replay LIBRARY [--mutations N] [--seed S] [--stream]

Each video of ``tests/fixtures`` (MP4, AVI, WebM, Matroska: MPEG-4 Part 2,
Motion-JPEG, VP8, VP9, H.264 CAVLC and CABAC) decodes whole through its
decoder; then ``N`` times one of its first samples (as the port's demuxer
hands it over) is bit-flipped, cut, zeroed or given a forged length and
decoded after the samples before it, and ``N`` times the file itself is
mutated and read through ``probe_video`` and ``iterate_frames``.  Each still
of ``tests/fixtures/stills`` (BMP, PNG, PPM, WebP lossy, lossless and
animated, GIF) decodes through ``decode_rgb``, then ``N`` mutations of it.
Small writer-made H.264 streams (CAVLC and CABAC, the 8x8 transform,
scaling lists, I_PCM) add their own.  ``--stream`` also reads every video,
and mutated copies, through ``native.VideoStream``'s decode thread.  A
decoder may raise on a mutated input; the run fails only when the process
does (a sanitizer's report aborts it).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures"
VIDEOS = sorted(p for ext in ("mp4", "avi", "webm", "mkv")
                for p in glob.glob(str(FIXTURES / f"*.{ext}")))
STILLS = sorted(glob.glob(str(FIXTURES / "stills" / "*")))


def use_library(path: str) -> None:
    """Make ``native.library()`` load ``path`` (built by the caller) instead
    of building its own."""
    from viddet_tpu_torch import native

    native.build = lambda: Path(path)
    native.library()


# ------------------------------------------------------------- mutations


def flip(data: bytes, rng) -> bytes:
    out = bytearray(data)
    for _ in range(int(rng.integers(1, 9))):
        i = int(rng.integers(len(out)))
        out[i] ^= 1 << int(rng.integers(8))
    return bytes(out)


def cut(data: bytes, rng) -> bytes:
    return data[: int(rng.integers(0, len(data)))]


def zero(data: bytes, rng) -> bytes:
    start = int(rng.integers(len(data)))
    end = min(len(data), start + int(rng.integers(1, 64)))
    return data[:start] + bytes(end - start) + data[end:]


def forge(data: bytes, rng) -> bytes:
    """A 4-byte length or size field (big- or little-endian) rewritten."""
    if len(data) < 4:
        return data
    at = int(rng.integers(len(data) - 3))
    value = int(rng.choice([0, 1, 0xFF, len(data), len(data) + 1, 0x7FFFFFFF, 0xFFFFFFFF,
                            int(rng.integers(0, 1 << 32))]))
    order = "big" if rng.random() < 0.5 else "little"
    return data[:at] + value.to_bytes(4, order) + data[at + 4:]


MUTATIONS = (flip, cut, zero, forge)


def mutate(data: bytes, rng) -> bytes:
    if not data:
        return data
    return MUTATIONS[int(rng.integers(len(MUTATIONS)))](data, rng)


# --------------------------------------------------------------- decoding


def decoder_for(index, name: str):
    from viddet_tpu_torch import native

    if index.codec == "mpeg4":
        return native.Mpeg4Decoder(index.config, name, index.fourcc)
    if index.codec == "vp8":
        return native.Vp8Decoder(name)
    if index.codec == "vp9":
        return native.Vp9Decoder(name)
    if index.codec == "h264":
        return native.H264Decoder(index.config, name)
    return None  # Motion-JPEG: each sample on its own


def decode(index, samples, name: str) -> int:
    """Decode ``samples`` in order until one raises; how many decoded."""
    from viddet_tpu_torch import native

    decoder = decoder_for(index, name)
    done = 0
    try:
        for sample in samples:
            if decoder is None:
                native.decode_jpeg(sample, name)
            else:
                decoder.decode(sample, name)
            done += 1
    except ValueError:
        pass
    finally:
        if decoder is not None:
            decoder.close()
    return done


def replay_video(path: str, rng, mutations: int, tmp: str) -> None:
    from viddet_tpu_torch.utils.video import iterate_frames, open_video, probe_video

    with open_video(path) as video:
        index = video.index
        samples = [video.sample(i) for i in range(len(index.offsets))]
    decode(index, samples, path)  # whole (mpeg4_damaged.mp4 raises part way, as it should)
    for _ in range(mutations):
        i = int(rng.integers(min(len(samples), 8)))
        decode(index, samples[:i] + [mutate(samples[i], rng)] + samples[i + 1:i + 3], path)
    with open(path, "rb") as f:
        data = f.read()
    for k in range(mutations):
        bad = os.path.join(tmp, f"m{k}{os.path.splitext(path)[1]}")
        with open(bad, "wb") as f:
            f.write(mutate(data, rng))
        try:
            probe_video(bad)
            for n, _ in iterate_frames(bad):
                if n >= 3:
                    break
        except Exception:  # noqa: BLE001 - a mutated file may fail anywhere in Python
            pass


def replay_stills(rng, mutations: int) -> None:
    from viddet_tpu_torch.data.base import decode_rgb

    for path in STILLS:
        with open(path, "rb") as f:
            data = f.read()
        decode_rgb(data, path)
        for _ in range(mutations):
            try:
                decode_rgb(mutate(data, rng), path)
            except Exception:  # noqa: BLE001
                pass


def writer_streams():
    """Small H.264 streams the fixtures do not hold: CAVLC and CABAC with the
    8x8 transform, scaling lists, I_PCM and several slices."""
    from tests import torch_h264_writer as W

    out = []
    for k, pps in enumerate((W.Pps(transform_8x8=1, num_ref_idx_default=2),
                             W.Pps(cabac=1, transform_8x8=1, num_ref_idx_default=2, scaling=1,
                                   lists=[None, "default", None, [20] * 16, None, None,
                                          [18] * 64, None]))):
        writer = W.Writer(64, 48, seed=k, sps=W.Sps(profile=100, max_num_ref_frames=2), pps=pps)
        units = [writer.parameter_sets() + writer.random_picture("IDR", slices=2, pcm=0.1)[0]]
        units += [writer.random_picture("P", slices=2, pcm=0.05)[0] for _ in range(3)]
        out.append([W.annexb(u) for u in units])
    return out


def replay_writer_streams(rng, mutations: int) -> None:
    from viddet_tpu_torch import native

    for samples in writer_streams():
        for k in range(mutations + 1):
            decoder = native.H264Decoder(b"", "writer stream")
            i = int(rng.integers(len(samples)))
            try:
                for j, sample in enumerate(samples):
                    decoder.decode(mutate(sample, rng) if k and j == i else sample)
                    decoder.contexts  # noqa: B018 - the call is what is replayed
            except ValueError:
                pass
            finally:
                decoder.close()


def replay_stream(path: str, rng, mutations: int, tmp: str) -> None:
    """The file, then mutated copies, through ``VideoStream``'s decode
    thread; a stream is also closed while its thread runs."""
    from viddet_tpu_torch import native
    from viddet_tpu_torch.utils.video import open_video

    with open(path, "rb") as f:
        data = f.read()
    for k in range(mutations + 1):
        src = path
        if k:
            src = os.path.join(tmp, f"s{k}{os.path.splitext(path)[1]}")
            with open(src, "wb") as f:
                f.write(mutate(data, rng))
        try:
            with open_video(src) as video:
                index = video.index
            stream = native.VideoStream(src, index.offsets, index.sizes,
                                        np.arange(index.shown), (64, 64), capacity=4,
                                        codec=index.codec, config=index.config,
                                        fourcc=index.fourcc)
        except Exception:  # noqa: BLE001
            continue
        try:
            for n, _ in enumerate(stream):
                if k % 2 and n >= 2:
                    break  # closed mid stream
        except ValueError:
            pass
        finally:
            stream.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("library")
    p.add_argument("--mutations", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stream", action="store_true")
    args = p.parse_args(argv)
    use_library(args.library)
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        for path in VIDEOS:
            if args.stream:
                replay_stream(path, rng, args.mutations, tmp)
            else:
                replay_video(path, rng, args.mutations, tmp)
        if not args.stream:
            replay_stills(rng, args.mutations)
            replay_writer_streams(rng, args.mutations)
    print(f"replayed {len(VIDEOS)} videos, {len(STILLS)} stills, {args.mutations} mutations each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
