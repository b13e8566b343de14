"""Host side of the kernel build (ops/_build.py); the compile itself runs
only where nvcc is, on the card's machine."""

import pytest

from accelerate_tpu_torch.ops import _build


def test_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "_library_path", lambda name: _build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_fwd"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")


def test_library_name_is_keyed_by_sources_and_flags(monkeypatch):
    path = _build._library_path("flash_fwd")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libflash_fwd-")
    assert _build._library_path("flash_fwd") == path  # stable
    # Every source keys every library: one digest over all of csrc/.
    assert _build._library_path("flash_bwd").name.split("-")[1] == path.name.split("-")[1]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._library_path("flash_fwd") != path
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "flash_bwd", "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90", "flash_fwd", "flash_fwd_sm90"]


def test_shared_header_keys_every_library(monkeypatch, tmp_path):
    # sm90.cuh is compiled into the wgmma sources: editing it must rebuild them.
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._library_path("flash_fwd_sm90")
    (csrc / "sm90.cuh").write_text((csrc / "sm90.cuh").read_text() + "\n// edited\n")
    assert _build._library_path("flash_fwd_sm90") != before
