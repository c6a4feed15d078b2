"""The port's CUDA build bookkeeping (no nvcc needed): which sources
build, and when a built library is stale."""

import os
import shutil

import pytest

pytest.importorskip("torch")

from modegpt_tpu_torch.kernels import build  # noqa: E402


def test_sources_name_every_cu_file():
    present = sorted(f[: -len(".cu")] for f in os.listdir(build.CSRC_DIR) if f.endswith(".cu"))
    assert sorted(build.SOURCES) == present


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, dst)
    return dst


def _paths(csrc, tmp_path):
    return {n: build._lib_path(n, str(csrc), str(tmp_path / "build")) for n in build.SOURCES}


def test_library_path_is_stable(csrc_copy, tmp_path):
    assert _paths(csrc_copy, tmp_path) == _paths(csrc_copy, tmp_path)
    assert _paths(csrc_copy, tmp_path) == {
        n: os.path.join(str(tmp_path / "build"), os.path.basename(build._lib_path(n))) for n in build.SOURCES
    }


@pytest.mark.parametrize("header", sorted(f for f in os.listdir(build.CSRC_DIR) if f.endswith(".cuh")))
def test_library_path_changes_with_a_shared_header(csrc_copy, tmp_path, header):
    before = _paths(csrc_copy, tmp_path)
    with open(csrc_copy / header, "a") as f:
        f.write("\n// edited\n")
    after = _paths(csrc_copy, tmp_path)
    assert all(before[n] != after[n] for n in build.SOURCES)


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_path_changes_with_its_own_source_only(csrc_copy, tmp_path, name):
    before = _paths(csrc_copy, tmp_path)
    with open(csrc_copy / f"{name}.cu", "a") as f:
        f.write("\n// edited\n")
    after = _paths(csrc_copy, tmp_path)
    assert {n for n in build.SOURCES if before[n] != after[n]} == {name}


def test_host_sources_name_every_cpp_file():
    present = sorted(f[: -len(".cpp")] for f in os.listdir(build.CSRC_DIR) if f.endswith(".cpp"))
    assert sorted(build.HOST_SOURCES) == present
    assert not set(build.HOST_SOURCES) & set(build.SOURCES)


@pytest.mark.parametrize("name", build.HOST_SOURCES)
def test_host_library_path_changes_with_its_own_source_only(csrc_copy, tmp_path, name):
    def paths():
        return {n: build._lib_path(n, str(csrc_copy), str(tmp_path / "build"))
                for n in build.SOURCES + build.HOST_SOURCES}

    before = paths()
    for header in (f for f in os.listdir(csrc_copy) if f.endswith(".cuh")):
        with open(csrc_copy / header, "a") as f:
            f.write("\n// edited\n")
    assert paths()[name] == before[name]  # a CUDA header does not rebuild host code
    with open(csrc_copy / f"{name}.cpp", "a") as f:
        f.write("\n// edited\n")
    after = paths()
    assert {n for n in build.HOST_SOURCES if before[n] != after[n]} == {name}


def test_host_source_builds_with_the_host_compiler_and_loads():
    """The zstd decoder builds here (g++), as on the card's machine, and
    its library loads and decodes."""
    from modegpt_tpu_torch.compress import zstd

    build.build_all(["zstd_decode"])
    assert os.path.exists(build._lib_path("zstd_decode"))
    # a raw-block frame: magic, header (single segment, 1-byte size), block
    frame = b"\x28\xb5\x2f\xfd" + b"\x20\x03" + bytes([(3 << 3) | 1, 0, 0]) + b"abc"
    assert zstd.decompress(frame) == b"abc"
