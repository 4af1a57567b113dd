"""The port's kernel build (``sslrec_tpu_torch/ops/cuda_build.py``) with a
stand-in ``nvcc``: one process per stale source, the source-newer check, the
whole-file rename, and a failure that names its library.  The real nvcc
exists only on the machine with the card, where ``chip_smoke.py`` builds."""

import os
import stat

import pytest
import torch

from sslrec_tpu_torch.ops import cuda_build

torch.set_num_threads(1)    # one intra-op thread: the suite's test workers share the cores

FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: writes the -o target, prints a ptxas line, or fails for a
# source named bad.cu
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
case "$src" in *bad.cu) echo "error in $src" >&2; exit 2 ;; esac
echo "ptxas info    : Used 20 registers ($src)"
echo built > "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "bad"):
        (csrc / f"{name}.cu").write_text("// kernel\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    return csrc


def test_builds_each_stale_source_once(fake_toolchain):
    built = cuda_build.build_libraries(("a", "b"))
    assert set(built) == {"a", "b"}
    for name, (so, out) in built.items():
        assert so == cuda_build.library_path(name) and os.path.exists(so)
        assert "registers" in out and f"{name}.cu" in out
    assert not [f for f in os.listdir(cuda_build.BUILD_DIR) if f.endswith(".tmp")]
    again = cuda_build.build_libraries(("a", "b"))
    assert {k: v[1] for k, v in again.items()} == {"a": "", "b": ""}
    # a source newer than its library rebuilds that library only
    so_a = cuda_build.library_path("a")
    os.utime(so_a, (1, 1))
    rebuilt = cuda_build.build_libraries(("a", "b"))
    assert rebuilt["a"][1] and rebuilt["b"][1] == ""
    assert cuda_build.build_libraries(("b",), force=True)["b"][1]


def test_failed_build_names_its_library_and_keeps_the_others(fake_toolchain):
    with pytest.raises(RuntimeError, match=r"libbad\.so: nvcc exited 2") as exc:
        cuda_build.build_libraries(("a", "bad"))
    assert "liba.so" not in str(exc.value)
    assert os.path.exists(cuda_build.library_path("a"))
    assert not os.path.exists(cuda_build.library_path("bad"))


def test_kernels_cover_every_source():
    srcs = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu"))
    assert srcs == sorted(cuda_build.KERNELS)
