"""The port's kernel build keys (``repro_torch.kernels.build``): a library is
rebuilt when its source, a shared header of ``csrc/`` or the flags change,
and loaded as it is otherwise.  Runs on the CPU: nothing here compiles."""
import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text('#include "shared.cuh"\nint f() { return g(); }\n')
    (src / "shared.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    return src


def test_library_path_is_stable_and_under_the_build_root(csrc, tmp_path):
    first = build.library_path("kern")
    assert first == build.library_path("kern")
    assert first.parent.parent == tmp_path / "out"
    assert first.name == "libkern.so"
    assert first.parent.name.startswith("kern-")


@pytest.mark.parametrize("edit", ["source", "header", "new_header",
                                  "flags"])
def test_a_changed_input_changes_the_library_path(edit, csrc, monkeypatch):
    before = build.library_path("kern")
    if edit == "source":
        (csrc / "kern.cu").write_text("int f() { return 2; }\n")
    elif edit == "header":
        (csrc / "shared.cuh").write_text("inline int g() { return 2; }\n")
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("inline int h() { return 3; }\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.library_path("kern") != before


def test_a_header_renamed_with_the_same_bytes_changes_the_path(csrc):
    before = build.library_path("kern")
    (csrc / "shared.cuh").rename(csrc / "renamed.cuh")
    assert build.library_path("kern") != before


def test_the_port_sources_share_the_hopper_header():
    """The flash forward and backward include ``csrc/hopper.cuh``, so both
    libraries' keys cover it."""
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "hopper.cuh"' in build.source(name).read_text()
    assert (build.CSRC / "hopper.cuh").exists()


def test_a_missing_source_raises(csrc):
    with pytest.raises(FileNotFoundError):
        build.library_path("absent")
