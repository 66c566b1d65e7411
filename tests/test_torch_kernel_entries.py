"""The ctypes signatures of kernels/_build.py against the C entry points of
csrc/*.cu, on the CPU: every entry exists once and takes as many arguments
as its signature lists, pointers where the signature says c_void_p (a
pointer passed as a 32-bit int would be cut)."""

import ctypes
import re

import pytest

from lichtfeld_studio_tpu_torch.kernels import _build

SOURCES = {p.name: p.read_text() for p in _build.sources()}


def _parameters(name: str) -> list[str]:
    found = [m for text in SOURCES.values()
             for m in re.finditer(rf'extern "C" int {name}\(([^)]*)\)', text)]
    assert len(found) == 1, f"{name}: {len(found)} definitions"
    return [p.strip() for p in found[0].group(1).split(",")]


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_entry(name):
    params = _parameters(name)
    sig = _build.SIGNATURES[name]
    assert len(params) == len(sig), (params, sig)
    for p, t in zip(params, sig):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        else:
            assert t is (ctypes.c_float if p.startswith("float") else ctypes.c_int), p
