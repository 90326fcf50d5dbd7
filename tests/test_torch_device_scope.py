"""Every C kernel launcher leaves the thread's current card as it found it.

A launcher takes its card's index from the caller (``kernels/wrap.py``)
and makes it current with ``DeviceScope`` (``kernels/csrc/device_scope.h``),
which restores the thread's previous card when the launcher returns, on
every path: a launch, an early refusal (``cudaErrorInvalidValue``) and a
card that cannot be made current.  The header is compiled here with the
host compiler against a stub CUDA runtime that keeps a current card per
thread, and driven through those paths; and each of the six launchers
(five in ``fragscore.cu``, one in ``decode_attention.cu``) is checked to
open with the scope and to set no card any other way.  The card itself
cannot show it on a one-card machine.
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
SOURCES = {
    "fragscore": KERNELS / "fragscore" / "csrc" / "fragscore.cu",
    "decode_attention": KERNELS / "decode_attention" / "csrc" / "decode_attention.cu",
}
LAUNCHERS = [("fragscore", n) for n in ("fragscore_launch", "mfi_delta_launch",
                                        "delta_from_base_launch", "select_from_base_launch",
                                        "migrate_refine_launch")] + [
    ("decode_attention", "decode_attention_launch")]

STUB_RUNTIME = r"""
#pragma once
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
extern int current_card, card_count;
inline cudaError_t cudaGetDevice(int* d) { *d = current_card; return cudaSuccess; }
inline cudaError_t cudaSetDevice(int d) {
  if (d < 0 || d >= card_count) return cudaErrorInvalidDevice;
  current_card = d;
  return cudaSuccess;
}
"""

PROBE = r"""
#include <cstdio>
#include <cstdlib>
#include "device_scope.h"
int current_card = 0, card_count = 4;
int seen = -1;

// a launcher's shape: the scope, an early refusal, the launch
int launcher(int device, int refuse) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  if (refuse) return cudaErrorInvalidValue;
  seen = current_card;
  return cudaSuccess;
}

int main(int argc, char** argv) {
  current_card = atoi(argv[1]);
  int rc = launcher(atoi(argv[2]), atoi(argv[3]));
  printf("%d %d %d\n", rc, current_card, seen);
  return 0;
}
"""


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("device_scope")
    (d / "cuda_runtime.h").write_text(STUB_RUNTIME)
    shutil.copy(KERNELS / "csrc" / "device_scope.h", d / "device_scope.h")
    (d / "probe.cc").write_text(PROBE)
    exe = d / "probe"
    subprocess.run([cxx, "-std=c++17", "-I", str(d), "-o", str(exe), str(d / "probe.cc")],
                   check=True, capture_output=True)

    def run(prev, device, refuse):
        out = subprocess.run([str(exe), str(prev), str(device), str(refuse)], check=True,
                             capture_output=True, text=True).stdout.split()
        return tuple(int(x) for x in out)

    return run


@pytest.mark.parametrize("prev,device,refuse,want_rc,want_seen", [
    (0, 2, 0, 0, 2),     # a launch on card 2 from card 0
    (3, 1, 0, 0, 1),     # from card 3
    (1, 1, 0, 0, 1),     # already current
    (2, 0, 1, 1, -1),    # refused after the card was made current
    (1, 7, 0, 101, -1),  # a card that cannot be made current
], ids=["launch", "launch-from-3", "same-card", "refused", "bad-card"])
def test_the_scope_restores_the_card_on_every_path(probe, prev, device, refuse, want_rc,
                                                   want_seen):
    rc, after, seen = probe(prev, device, refuse)
    assert (rc, seen) == (want_rc, want_seen)
    assert after == prev


def _body(source: str, name: str) -> str:
    start = source.index(f"int {name}(")
    return source[source.index("{", start):]


@pytest.mark.parametrize("lib,name", LAUNCHERS, ids=[n for _, n in LAUNCHERS])
def test_every_launcher_opens_with_the_scope(lib, name):
    source = SOURCES[lib].read_text()
    assert '#include "../../csrc/device_scope.h"' in source
    assert "cudaSetDevice" not in source  # no card is set outside the scope
    body = _body(source, name)
    lines = [ln.strip() for ln in body.splitlines()[1:3]]
    assert lines == ["DeviceScope scope(device);",
                     "if (scope.error() != cudaSuccess) return scope.error();"], lines
    assert len(re.findall(r"\bint \w+_launch\(", source)) == sum(1 for l, _ in LAUNCHERS
                                                                   if l == lib)
