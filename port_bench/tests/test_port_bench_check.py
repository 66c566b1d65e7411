"""The correctness check on the CPU at a tiny size: a sound run through
the program's plain versions comes out correct, and the same run with
the timed path broken underneath comes out not correct: a step that
leaves the state unchanged, half of the image left out of the loss (the
mean taken over the rest), an MCMC refine that relocates nothing, draws
its sources with equal weights, keeps the sources' Adam moments or copies
them unsplit, and a frame's pixel altered where it is produced.
(One card, one process: no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

from port_bench.tests.tiny import tiny_context


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("port_bench_cache")


def run_train(cache, seed=5):
    from port_bench.drivers import train

    return train.run(tiny_context("train", cache, seed))


def run_view(cache, seed=5):
    from port_bench.drivers import view

    return view.run(tiny_context("view", cache, seed))


def test_a_sound_training_run_is_correct(cache):
    res = run_train(cache)
    assert all(c.ok for c in res.checks), [(c.name, c.value) for c in res.checks]
    assert res.attempted > 0 and res.failed == 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cache, monkeypatch):
    from lichtfeld_studio_tpu_torch.train import state as st
    from lichtfeld_studio_tpu_torch.train import trainer as tr

    def frozen_step(state, camera, gt, bg, cfg, flags=st.StepFlags()):
        loss, out, _ = st.compute_grads(state, camera, gt, bg, cfg, flags)
        state.iteration += 1
        return state, {"loss": loss, "n_active": state.splats.n_active.clone(),
                       "n_instances": out.n_instances, "n_nonfinite": torch.zeros((), dtype=torch.int64)}

    monkeypatch.setattr(tr, "train_step", frozen_step)
    res = run_train(cache)
    bad = [c.name for c in res.checks if not c.ok]
    assert "update_norm_gap" in bad and "grad_norm_gap" in bad


def test_half_the_image_left_out_of_the_loss_is_not_correct(cache, monkeypatch):
    from lichtfeld_studio_tpu_torch.train import state as st

    real = st.photometric_loss

    def half_loss(rendered, gt, lam):
        rows = rendered.shape[0] // 2
        return real(rendered[:rows], gt[:rows], lam)

    monkeypatch.setattr(st, "photometric_loss", half_loss)
    res = run_train(cache)
    assert "loss_gap" in [c.name for c in res.checks if not c.ok]


def _refine_fault(monkeypatch, fault):
    from lichtfeld_studio_tpu_torch.train.strategies import mcmc

    if fault == "skip":
        monkeypatch.setattr(mcmc, "relocate_gs", lambda u, splats, adam, binoms, cfg: (splats, adam))
    elif fault == "uniform":
        real = mcmc._sample_multinomial
        monkeypatch.setattr(mcmc, "_sample_multinomial",
                            lambda u, probs: real(u, (probs > 0).to(probs.dtype)))
    elif fault == "moments":
        real = mcmc._apply_relocation
        monkeypatch.setattr(mcmc, "_apply_relocation", lambda *a, zero_source_moments, **kw:
                            real(*a, zero_source_moments=False, **kw))
    else:
        monkeypatch.setattr(mcmc, "relocation", lambda op, scales, ratios, binoms: (op, scales))


@pytest.mark.parametrize("fault, number", [("skip", "refine_pick_gap"),
                                           ("uniform", "refine_pick_gap"),
                                           ("moments", "refine_moment_diff"),
                                           ("nosplit", "refine_diff")])
def test_a_broken_refine_is_not_correct(cache, monkeypatch, fault, number):
    _refine_fault(monkeypatch, fault)
    res = run_train(cache)
    bad = [c.name for c in res.checks if not c.ok]
    assert number in bad, [(c.name, c.value) for c in res.checks]
    assert "loss_gap" not in bad  # the first steps, before the refine, are sound


def test_a_sound_frame_run_is_correct(cache):
    res = run_view(cache)
    assert all(c.ok for c in res.checks), [(c.name, c.value) for c in res.checks]


def test_a_frame_altered_where_it_is_produced_is_not_correct(cache, monkeypatch):
    from lichtfeld_studio_tpu_torch.render import headless

    real = headless.render_frame_u8

    def altered(*args, **kw):
        img, n = real(*args, **kw)
        img = img.clone()
        img[img.shape[0] // 2, img.shape[1] // 2, 0] ^= 0x40
        return img, n

    monkeypatch.setattr(headless, "render_frame_u8", altered)
    res = run_view(cache)
    assert "frame_max_diff" in [c.name for c in res.checks if not c.ok]
