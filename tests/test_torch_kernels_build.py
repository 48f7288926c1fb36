"""How weclip_tpu_torch/kernels.py names, declares and rebuilds the CUDA
libraries: checks that need no card and no nvcc."""

import re

from weclip_tpu_torch import kernels


def test_lib_path_hashes_every_included_header(tmp_path, monkeypatch):
    """A library is rebuilt when any header its source includes changes,
    at any depth; a system header (<...>) is not read."""
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    monkeypatch.setattr(kernels, "_CSRC", tmp_path)
    first = kernels._lib_path("k")
    assert first == kernels._lib_path("k")
    (tmp_path / "unrelated.cuh").write_text("// changed\n")
    assert kernels._lib_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    second = kernels._lib_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a, changed\n')
    assert kernels._lib_path("k") not in (first, second)


def test_signatures_match_the_c_entry_points():
    """Every ctypes signature names an ``extern "C"`` function of its
    source with as many parameters, and every such function is declared."""
    for name, fns in kernels.SIGNATURES.items():
        src = (kernels._CSRC / f"{name}.cu").read_text()
        found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
        assert set(found) == set(fns), name
        for fn, argtypes in fns.items():
            assert len(found[fn].split(",")) == len(argtypes), f"{name}.{fn}"
