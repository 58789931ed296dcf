"""The port's native library (``viddet_tpu_torch/native/*.cpp``: JPEG, PNG,
BMP, MPEG-4 Part 2, VP8, VP9, H.264 CAVLC and CABAC, WebP, GIF, the video
stream thread) under sanitizers.

The sources of ``native.sources()`` are built with the package's own
compiler commands (``native.compile_commands`` / ``native.build_command``),
``-O3`` replaced by ``-O1 -g -fsanitize=... -fno-sanitize-recover=all
-fno-omit-frame-pointer``, into ``build/viddet_tpu_torch/sanitize/``; then
``tests/torch_sanitize_replay.py`` runs in a subprocess that loads that
library (the ASan runtime preloaded into Python) and feeds every committed
fixture and seeded mutations of it (bit flips, cuts, zeroed runs, forged
lengths; in the container and in the samples the demuxers hand over) to
every decoding entry point.  The gate: the process ends cleanly, and no
sanitizer reported anything.

Tier 1 runs ASan + UBSan with 8 mutations an input (~50 s on one CPU
worker, the build included).  ``-m slow`` adds 64 mutations an input and the
``VideoStream`` decode thread under ThreadSanitizer.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from viddet_tpu_torch import native

ROOT = Path(__file__).resolve().parents[1]
SANITIZE_ROOT = ROOT / "build" / "viddet_tpu_torch" / "sanitize"
SANITIZERS = {"asan": ["-fsanitize=address,undefined"], "tsan": ["-fsanitize=thread"]}
RUNTIMES = {"asan": "libasan.so", "tsan": "libtsan.so"}
DEBUG = ["-O1", "-g", "-fno-sanitize-recover=all", "-fno-omit-frame-pointer"]
REPORTS = ("runtime error:", "ERROR: AddressSanitizer", "WARNING: ThreadSanitizer",
           "ERROR: LeakSanitizer", "SUMMARY: UndefinedBehaviorSanitizer")


def build_sanitized(kind: str) -> Path:
    """The library built from the package's sources under ``kind``'s
    sanitizers (cached by the sources' digest)."""
    out = SANITIZE_ROOT / f"{native._digest()}-{kind}" / native.LIB_NAME
    if out.exists():
        return out
    objects = out.parent / "objects"
    objects.mkdir(parents=True, exist_ok=True)
    flags = SANITIZERS[kind] + DEBUG
    cmds = [[c for c in cmd if c != "-O3"][:1] + flags + [c for c in cmd if c != "-O3"][1:]
            for cmd in native.compile_commands(objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        assert proc.returncode == 0, f"$ {' '.join(cmd)}\n{err}"
    staged = out.with_suffix(".tmp")
    cmd = native.build_command(staged, objects) + SANITIZERS[kind]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, f"$ {' '.join(cmd)}\n{proc.stderr}"
    os.replace(staged, out)
    return out


def replay(kind: str, *args: str, timeout: int) -> None:
    lib = build_sanitized(kind)
    # the runtime first, and the C++ library with it: Python links no libstdc++, and the
    # runtime's exception interceptor needs it there when it starts
    preload = [subprocess.run(["g++", f"-print-file-name={name}"], capture_output=True,
                              text=True, check=True).stdout.strip()
               for name in (RUNTIMES[kind], "libstdc++.so")]
    env = dict(os.environ, LD_PRELOAD=":".join(preload), PYTHONPATH=str(ROOT),
               ASAN_OPTIONS="detect_leaks=0:halt_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1",
               TSAN_OPTIONS="halt_on_error=1:report_signal_unsafe=0",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "tests.torch_sanitize_replay", str(lib), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    reports = [r for r in REPORTS if r in proc.stderr]
    assert proc.returncode == 0 and not reports, (proc.returncode, reports, proc.stderr[-6000:])
    assert "replayed" in proc.stdout


def test_fixtures_and_mutations_under_asan_and_ubsan():
    replay("asan", "--mutations", "8", "--seed", "0", timeout=600)


@pytest.mark.slow
def test_many_mutations_under_asan_and_ubsan():
    replay("asan", "--mutations", "64", "--seed", "1", timeout=3600)


@pytest.mark.slow
def test_video_stream_thread_under_tsan():
    replay("tsan", "--stream", "--mutations", "8", "--seed", "2", timeout=3600)
