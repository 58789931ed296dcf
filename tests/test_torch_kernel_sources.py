"""The kernel sources against the Python that binds and measures them, on
the CPU: each C entry point's parameter count against its ctypes argument
list in ``kernels/build.py`` (ctypes passes whatever it is given, so a
mismatch shows only on the card, as a wrong argument), and the launch
shapes ``chip_smoke.floor_grids`` times an empty kernel at against the
constants the sources launch with."""

import re

import pytest

import chip_smoke
from viddet_tpu_torch.kernels import build

ENTRY = re.compile(r'extern "C" (?:int|const char\*) (viddet_\w+)\(([^)]*)\)', re.S)


def _entry_points():
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def _constant(src: str, name: str) -> int:
    text = (build.CSRC / src).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_every_entry_point_has_a_signature():
    assert set(_entry_points()) == set(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_entry_point_parameters_match_its_signature(name):
    assert _entry_points()[name] == len(build.SIGNATURES[name])


@pytest.mark.parametrize("b", [chip_smoke.B, 4 * chip_smoke.B])
def test_floor_grids_follow_the_kernels_launch_shapes(b):
    k, topk = chip_smoke.K, chip_smoke.TOPK
    threads = _constant("gather_decode.cu", "kPairThreads")
    run = threads // 32 * _constant("gather_decode.cu", "kPairWarpWinners")
    grids = chip_smoke.floor_grids(b)
    assert grids["gather_decode_pairs"] == (-(-b * k // run), threads, 0)
    k4_threads = min(_constant("finalize.cu", "kMaxThreads"), -(-topk // 32) * 32)
    assert grids["finalize_candidates"] == (b * -(-topk // k4_threads), k4_threads,
                                            k * 16 + chip_smoke.HOT_J * 8)
    k6_threads = min(_constant("nms.cu", "kCompactMaxThreads"), -(-k // 32) * 32)
    assert grids["compact_and_pad"] == (b, k6_threads, 0)
