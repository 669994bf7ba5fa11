"""The kernel build of maxk_tpu_torch (ops/_native.py), with a stand-in for
nvcc: the library is keyed by the sources' hash, a build is reused, and a
failed build raises with the compiler's output. The real nvcc runs only
on the card's machine (chip_smoke.py)."""

import re
import stat

import pytest
import torch

from maxk_tpu_torch.ops import _native

torch.set_num_threads(1)


def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// kernel a\n")
    (src / "common.cuh").write_text("// header\n")
    monkeypatch.setattr(_native, "CSRC", src)
    monkeypatch.setattr(_native, "BUILD_DIR", src / "build")
    return src


def test_library_name_follows_every_source(csrc):
    first = _native.library_path()
    assert first.parent == csrc / "build" and first.name.endswith(".so")
    (csrc / "a.cu").write_text("// kernel a, edited\n")
    second = _native.library_path()
    (csrc / "common.cuh").write_text("// header, edited\n")
    assert len({first, second, _native.library_path()}) == 3


def test_build_runs_nvcc_once_per_source_state(csrc, tmp_path, monkeypatch):
    log = tmp_path / "calls"
    # writes the file named after -o and records the call
    nvcc = _fake_nvcc(tmp_path, f"""
while [ "$1" != "-o" ]; do shift; done
echo built > "$2"
echo "$@" >> {log}
""")
    monkeypatch.setattr(_native, "_nvcc", lambda: nvcc)
    out = _native.build()
    assert out.exists() and out == _native.library_path()
    assert _native.build() == out
    # one compile per source, then one link
    compile_call, link_call = log.read_text().splitlines()
    assert compile_call.endswith("a.cu") and link_call.endswith("a.o")
    assert [p.name for p in (csrc / "build").iterdir()] == [out.name]  # no temp file left


def test_failed_build_raises_with_compiler_output(csrc, tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "a.cu(3): error: bad kernel" >&2\nexit 3\n')
    monkeypatch.setattr(_native, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match=r"(?s)exit code 3.*a.cu\(3\): error: bad kernel"):
        _native.build()
    assert not any((csrc / "build").iterdir())


def test_every_signature_is_an_entry_point_of_the_sources():
    """Each name that `SIGNATURES` binds is an `extern "C"` function of
    `csrc/*.cu` taking as many parameters as its ctypes signature."""
    text = "\n".join(p.read_text() for p in sorted(_native.CSRC.glob("*.cu")))
    params = {
        name: len([p for p in args.split(",") if p.strip()])
        for name, args in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text)
    }
    assert {name: params.get(name) for name in _native.SIGNATURES} == {
        name: len(argtypes) for name, argtypes in _native.SIGNATURES.items()
    }


def test_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
