"""The plain versions of the microbenchmark kernels T1a, T1b, T2 and T3
(lichtfeld_studio_tpu_torch.kernels.microbench) against the TPU kernels'
bodies, run through pl.pallas_call(..., interpret=True) as the JAX package's
kernel tests run theirs on the CPU. Small shapes and R = 2 repetitions.

Where interpret mode cannot run a body on the CPU (the DMA semaphores of
_stream_kernel; pltpu.roll of the scan's "roll" variant) the plain version
is held against the function's numpy definition instead.

Tolerances: float32 1e-6 relative (the same operations in the same order;
XLA may contract a multiply-add); bf16 2e-2 relative (XLA on the CPU keeps
excess precision between bf16 operations, the port rounds after each)."""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lichtfeld_studio_tpu_torch.kernels import microbench as mb

TOOLS = Path(__file__).resolve().parents[1] / "tools"
R = 2


def _tool(name, monkeypatch, tmp_path):
    """Import tools/<name>.py as it stands (it sets a compile cache
    directory when imported: point it under tmp_path)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_tpu_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


def _interpret(kernel, x, out_shape):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32), interpret=True,
    )(jnp.asarray(x)))


def _slab(rng, lo, hi, shape=(mb.DEPTH, mb.WIDTH)):
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("dtype,rel", [("f32", 1e-6), ("bf16", 2e-2)])
def test_alu_elementwise_plain_matches_the_tpu_body(rng, monkeypatch, tmp_path, dtype, rel):
    tool = _tool("microbench_bf16_vpu", monkeypatch, tmp_path)
    x = _slab(rng, 0.99, 1.0)
    x[0, :8] = [-1.0, -0.5, 0.0, 0.25, 3.0, 1e-3, -1e-3, 100.0]  # the max(x, 0) branch too
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = _interpret(functools.partial(tool._elemwise_kernel, reps=R, dtype=jdt), x, x.shape)
    got = mb.alu_elementwise(torch.from_numpy(x)[None], dtype=dtype, reps=R)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=rel, atol=1e-7)
    assert (got[0, :3] == 0).all() and got[0, 4] > 2.9


@pytest.mark.parametrize("dtype,rel", [("f32", 1e-5), ("bf16", 5e-2)])
def test_scan_prod_plain_matches_the_tpu_body(rng, monkeypatch, tmp_path, dtype, rel):
    """The "pad" variant in interpret mode (the "roll" variant needs
    pltpu.roll); 7 levels of rounding compound: 1e-5 / 5e-2 relative."""
    tool = _tool("microbench_bf16_vpu", monkeypatch, tmp_path)
    x = _slab(rng, 0.99, 1.0)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = _interpret(functools.partial(tool._scan_kernel, reps=1, dtype=jdt, impl="pad"), x,
                      x.shape)
    got = mb.scan_prod(torch.from_numpy(x)[None], dtype=dtype, reps=1)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=rel)
    if dtype == "f32":  # and the function's definition: a cumulative product, times the decay
        np.testing.assert_allclose(got, np.cumprod(x.astype(np.float64), 0) * 0.999999, rtol=1e-5)
    two = mb.scan_prod(torch.from_numpy(x)[None], dtype=dtype, reps=2, impl="smem")[0].numpy()
    want2 = _interpret(functools.partial(tool._scan_kernel, reps=2, dtype=jdt, impl="pad"), x,
                       x.shape)
    np.testing.assert_allclose(two, want2, rtol=10 * rel, atol=1e-30)


def test_log_step_scan_is_the_roll_variants_definition(rng):
    """_scan_roll cannot run here (pltpu.roll): its definition, roll by
    `shift` and select the pad where row < shift, in numpy."""
    x = _slab(rng, 0.5, 1.5, (16, 8))
    want, shift = x.copy(), 1
    while shift < 16:
        rolled = np.roll(want, shift, 0)
        rolled[:shift] = 1.0
        want, shift = want * rolled, shift * 2
    got = mb.log_step_scan(torch.from_numpy(x), torch.mul, 1.0, dim=0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,width,nb,blocks", [(8, 128, 32, 1), (1, 1024, 32, 5), (2, 128, 7, 7),
                                                  (16, 128, 9, 4), (8, 512, 8, 3)])
def test_stream_ring_plain_matches_the_definition(rng, rows, width, nb, blocks):
    """_stream_kernel's copies and semaphores have no interpret mode on the
    CPU: what it computes is the sum of element [0, 0] of every chunk
    x[:, i * width : (i + 1) * width]; a grid splits the chunks into
    contiguous ranges. 1e-6 of the sum of |values| (float64 sums here)."""
    x = rng.normal(size=(rows, nb * width)).astype(np.float32)
    first = np.array([x[:, i * width:(i + 1) * width][0, 0] for i in range(nb)], np.float64)
    per = -(-nb // blocks)
    want = np.array([first[b * per:(b + 1) * per].sum() for b in range(blocks)])
    got = mb.stream_ring(torch.from_numpy(x), width=width, blocks=blocks).numpy()
    assert got.shape == (blocks,)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(first).sum())
    np.testing.assert_allclose(got.sum(), first.sum(), atol=1e-5 * np.abs(first).sum())


@pytest.mark.parametrize("orient,axis,shape", [("thread", 0, (mb.DEPTH, 256)),
                                               ("lanes", 1, (64, mb.DEPTH))])
def test_scan_orient_plain_matches_the_tpu_body(rng, monkeypatch, tmp_path, orient, axis, shape):
    """Both orientations against _kernel in interpret mode. The serial
    form's cumprod / cumsum add and multiply in another order than the
    body's log-step scans: 1e-5 relative for both."""
    tool = _tool("microbench_scan_orient", monkeypatch, tmp_path)
    monkeypatch.setattr(tool, "R", R)
    x = _slab(rng, 0.1, 0.9, shape)
    want = _interpret(functools.partial(tool._kernel, axis=axis), x, (1, shape[1]))
    out, x_final = mb.scan_orient(torch.from_numpy(x)[None], orient=orient, reps=R)
    assert out.shape == (1, 1, shape[1]) and x_final.shape == (1, *shape)
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-5)
    assert np.isfinite(x_final.numpy()).all() and not np.allclose(x_final[0].numpy(), x)


def test_the_two_orientations_compute_the_same_recurrence(rng):
    x = torch.from_numpy(_slab(rng, 0.1, 0.9, (2, mb.DEPTH, 128)))
    out_t, x_t = mb.scan_orient(x, orient="thread", reps=3)
    out_l, x_l = mb.scan_orient(x.transpose(1, 2).contiguous(), orient="lanes", reps=3)
    np.testing.assert_allclose(x_l.transpose(1, 2).numpy(), x_t.numpy(), rtol=1e-5)
    assert out_t.shape == (2, 1, 128) and out_l.shape == (2, 1, mb.DEPTH)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, mb.DEPTH, mb.WIDTH))
    with pytest.raises(ValueError, match="float32"):
        mb.alu_elementwise(x.double())
    with pytest.raises(ValueError, match="float32"):
        mb.scan_prod(x[:, :64])
    with pytest.raises(ValueError, match="dtype"):
        mb.alu_elementwise(x, dtype="f16")
    with pytest.raises(ValueError, match="impl"):
        mb.scan_prod(x, impl="roll")
    with pytest.raises(ValueError, match="contiguous"):
        mb.alu_elementwise(x.transpose(1, 2).transpose(1, 2)[:, :, ::1].expand(2, -1, -1))
    with pytest.raises(ValueError, match="multiple of 4"):
        mb.stream_ring(torch.zeros((2, 30)), width=6)
    with pytest.raises(ValueError, match="blocks"):
        mb.stream_ring(torch.zeros((2, 64)), width=16, blocks=5)
    with pytest.raises(ValueError, match="orient"):
        mb.scan_orient(x, orient="warp")
    with pytest.raises(ValueError, match="axis"):
        mb.scan_orient(x, orient="lanes")  # 128 must lie on the last axis
    for fn in (mb.alu_elementwise, mb.scan_prod, mb.stream_ring, mb.scan_orient):
        assert fn.launches == 0  # the CPU never launches a kernel
