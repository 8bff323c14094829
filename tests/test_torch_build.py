"""The kernel builder (``repro_torch.kernels._build``) with a stand-in
``nvcc`` that links an empty shared library: every source starts its own
compiler at once, a built library is reused, an edited header rebuilds
the sources that include it, and a failed build raises with the
compiler's output."""
import os
import shutil
import stat

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: note the start, fail on request, link an empty library
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo start >> "$STARTS"
case "$*" in *broken*) echo "error: broken source" ; exit 2 ;; esac
echo "ptxas info    : Used 42 registers"
exec gcc -shared -fPIC -o "$out" -x c /dev/null
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    if shutil.which("gcc") is None:
        pytest.skip("no gcc to link a stand-in library")
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "broken"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}"
                       f"{os.environ['PATH']}")
    monkeypatch.setenv("STARTS", str(tmp_path / "starts"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    return tmp_path


def test_build_all_builds_each_source_once_and_reuses_it(fake):
    built = _build.build_all(["a", "b"])
    assert set(built) == {"a", "b"}
    assert all("42 registers" in b.log for b in built.values())
    assert all(b.seconds > 0 for b in built.values())
    assert (fake / "starts").read_text().count("start") == 2
    assert _build.build("a") is built["a"]
    _build._LOADED.clear()                  # a new process: the .so is kept
    again = _build.build("b")
    assert again.seconds == 0.0 and again.path == built["b"].path
    assert (fake / "starts").read_text().count("start") == 2


def test_build_failure_raises_with_the_compiler_output(fake):
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build_all(["a", "broken"])
    assert not list((fake / "build").glob("broken_*.so"))


def test_editing_a_header_rebuilds_the_sources_that_include_it(fake):
    csrc = fake / "csrc"
    (csrc / "prims.cuh").write_text("// v1\n")
    (csrc / "wrap.cuh").write_text('#include "prims.cuh"\n')
    (csrc / "a.cu").write_text('#include "wrap.cuh"\n#include <cstdint>\n')
    first = _build.build_all(["a", "b"])
    _build._LOADED.clear()
    (csrc / "prims.cuh").write_text("// v2\n")   # included through wrap.cuh
    again = _build.build_all(["a", "b"])
    assert again["a"].seconds > 0 and again["a"].path != first["a"].path
    assert again["b"].seconds == 0.0 and again["b"].path == first["b"].path
    assert (fake / "starts").read_text().count("start") == 3
