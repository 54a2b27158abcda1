"""Building the port's kernels raises with the compiler's stderr when a build
fails, and never hands back a missing library. A stand-in ``nvcc`` script
takes the compiler's place on the CPU."""

import importlib
import os
import stat

import pytest

nl = importlib.import_module("ray_tpu_torch._private.native_loader")


def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(bindir)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(nl, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(nl, "BUILD_DIR", str(tmp_path / "build"))
    return tmp_path


def test_every_kernel_source_is_listed():
    assert {"flash_attention", "flash_attention_bwd"} <= set(
        nl.kernel_names())


def test_failed_build_raises_with_stderr(workdir, monkeypatch):
    bindir = _fake_nvcc(workdir, 'echo "k.cu(3): error: boom" >&2\nexit 2\n')
    monkeypatch.setenv("PATH", bindir + os.pathsep + os.environ["PATH"])
    with pytest.raises(RuntimeError, match="error: boom"):
        nl.load_library("k")
    assert not any(p.endswith(".so") for p in os.listdir(workdir / "build"))


def test_build_reports_and_caches_by_source(workdir, monkeypatch):
    # writes the file named after -o, and a ptxas-style report
    body = ('while [ "$1" != "-o" ]; do shift; done\n'
            'echo lib > "$2"\necho "ptxas info: Used 90 registers" >&2\n')
    monkeypatch.setenv("PATH", _fake_nvcc(workdir, body) + os.pathsep
                       + os.environ["PATH"])
    reports = nl.build(["k"])
    assert "90 registers" in reports["k"]
    assert nl.build(["k"]) == {}          # same source: nothing to build
    (workdir / "csrc" / "k.cu").write_text("// changed\n")
    assert set(nl.build(["k"])) == {"k"}  # a new source hash rebuilds


def test_missing_nvcc_raises(workdir, monkeypatch):
    monkeypatch.setenv("PATH", str(workdir))
    monkeypatch.setenv("CUDA_HOME", str(workdir))
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        nl.build(["k"])


def test_header_change_rebuilds(workdir):
    """A source may include any ``csrc/*.cuh``: editing one, or adding
    one, gives every library a new path, so the next build recompiles."""
    first = nl._library_path("k")
    (workdir / "csrc" / "h.cuh").write_text("// helpers\n")
    with_header = nl._library_path("k")
    (workdir / "csrc" / "h.cuh").write_text("// helpers, edited\n")
    edited = nl._library_path("k")
    assert len({first, with_header, edited}) == 3
    assert nl._library_path("k") == edited     # same files: same path
