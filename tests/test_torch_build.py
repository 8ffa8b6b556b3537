"""The port's kernel build (ops/_build.py): what can be checked without nvcc
here, and the build itself on a card."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from pfilter_tpu_torch.ops import _build


def _c_signatures():
    """extern "C" functions of csrc/*.cu -> their parameter type strings."""
    out = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = [p.strip().rsplit(" ", 1)[0] for p in m.group(2).split(",")]
    return out


def test_sources_and_declared_signatures_agree():
    assert [s.name for s in _build.sources()] == ["knn_tiled.cu", "pca_radius.cu", "work_list.cu"]
    c = _c_signatures()
    assert set(c) == set(_build.SIGNATURES)
    for name, params in c.items():
        declared = _build.SIGNATURES[name]
        assert len(params) == len(declared), name
        for p, ct in zip(params, declared):
            # Every pointer (and the stream) as void*, every int as int, every
            # float as float: a pointer passed as c_int would be cut to 32 bits.
            assert (ct is ctypes.c_void_p) == p.endswith("*"), (name, p)
            assert (ct is ctypes.c_int) == (p in ("int", "const int")), (name, p)
            assert (ct is ctypes.c_float) == (p in ("float", "const float")), (name, p)


def test_build_key_follows_sources(tmp_path):
    srcs = _build.sources()
    a = _build._digest(srcs)
    assert a == _build._digest(srcs)
    copy = tmp_path / srcs[0].name
    copy.write_text(srcs[0].read_text() + "\n// edited\n")
    assert _build._digest([copy]) != a


def test_build_key_follows_headers(tmp_path):
    """Both kernels include csrc/async_stage.cuh: editing it must rebuild."""
    for src in list(_build.sources()) + sorted(_build.CSRC.glob("*.cuh")):
        (tmp_path / src.name).write_text(src.read_text())
    assert (tmp_path / "async_stage.cuh").is_file()
    a = _build.build_key(tmp_path)
    assert a == _build.build_key(_build.CSRC)
    (tmp_path / "async_stage.cuh").write_text((tmp_path / "async_stage.cuh").read_text() + "\n// edited\n")
    assert _build.build_key(tmp_path) != a


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", Path(tmp_path) / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", Path(tmp_path) / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.cuda
def test_build_and_load_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels are built for sm_90a only there")
    lib = _build.load()
    assert lib.pf_knn_tiled.restype is ctypes.c_int
    assert lib.pf_pca_radius.restype is ctypes.c_int
    assert lib.pf_work_list.restype is ctypes.c_int
    assert Path(_build.BUILD_INFO["path"]).is_file()
