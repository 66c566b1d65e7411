"""The check's controls on the card (these skip without one): the
reference computed with TF32 on, put in the program's place, has to come
out not correct, in training (through the EWA path and, with a fisheye
test lens, the --gut-exact path) and in the frame cell;
sizes as the CPU tests', far below the cells' (the full-size readings are
in PERF.md, from port_bench/readings.py)."""

from __future__ import annotations

import dataclasses

import pytest

from port_bench.tests.tiny import tiny_config, tiny_context


@pytest.fixture
def card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    return tmp_path


@pytest.mark.cuda
@pytest.mark.parametrize("fisheye", [False, True])
def test_tf32_in_the_programs_place_is_not_correct_in_training(card, fisheye):
    from port_bench.drivers import train

    ctx = dataclasses.replace(tiny_context("train", card), device="cuda",
                              config=tiny_config(fisheye=fisheye))
    _, first = train.set_up(ctx, card / "out", warm=False)
    checks = train.compare(train.control_first(first, ctx, "cuda"), ctx, "cuda")
    assert not all(c.ok for c in checks), [(c.name, c.value) for c in checks]


@pytest.mark.cuda
def test_tf32_in_the_programs_place_is_not_correct_for_frames(card):
    from port_bench.drivers import view

    ctx = dataclasses.replace(tiny_context("view", card), device="cuda")
    checks = view.readings(ctx, "control")
    assert not all(c.ok for c in checks), [(c.name, c.value) for c in checks]
