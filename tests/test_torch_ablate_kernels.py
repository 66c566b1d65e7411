"""tools/ablate_kernels.py on the CPU: every variant still applies to the
kernel source it rewrites (the builds and the timings need the GPU)."""

import pytest

from lichtfeld_studio_tpu_torch.tools import ablate_kernels

CASES = [(file, name) for file, variants in ablate_kernels.VARIANTS.items() for name in variants]


@pytest.mark.parametrize("file,name", CASES)
def test_variant_applies_to_the_source(file, name):
    source = ablate_kernels.expanded_source(file)
    text = ablate_kernels.variant_source(file, name)
    pairs = ablate_kernels.VARIANTS[file][name]
    assert (text == source) == (not pairs)
    for old, new in pairs:
        assert old not in text or old in new
        assert new in text
    assert f'extern "C" int {ablate_kernels.ENTRIES[file]}(' in text
    assert "#include \"" not in text  # the local headers are written in


def test_a_variant_that_fell_behind_the_source_raises(monkeypatch):
    stale = {ablate_kernels.P4: {"stale": [("constexpr int kThreads = 1;", "")]}}
    monkeypatch.setattr(ablate_kernels, "VARIANTS", stale)
    with pytest.raises(ValueError, match="not once"):
        ablate_kernels.variant_source(ablate_kernels.P4, "stale")


def test_refuses_to_run_without_a_gpu(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert ablate_kernels.main([]) == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
