"""Port parity for kernel P1 (instance expansion): the port's
expand_instances on CPU tensors (its plain version) against the JAX
package's Pallas kernel in interpret mode and the XLA scatter-marker
construction, on the cases of tests/test_expand_pallas.py and three that
span several of the CUDA kernel's merge pieces. Exact equality on valid
slots; in-bounds g everywhere. The plain mirror of the kernel's partition
against the plain version on the same cases; the CUDA kernel against the
plain version is in test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.kernels.expand_pallas import expand_instances as j_expand
from lichtfeld_studio_tpu_torch.kernels import expand as texpand
from tests.test_expand_pallas import _xla_expand
from tests.torch_parity import EXPAND_CASES, assert_expand_equal_on_valid, expand_inputs


def _case(nt, cap, seed=0, counts_bits=None):
    nt, payload = expand_inputs(nt, seed)
    out = texpand.expand_instances(torch.from_numpy(nt), torch.from_numpy(payload), cap)
    nt_j, pl_j = jnp.asarray(nt), jnp.asarray(payload)
    ref_xla = jax.jit(_xla_expand, static_argnums=2)(nt_j, pl_j, cap)
    ref_pallas = jax.jit(j_expand, static_argnums=(2, 3))(nt_j, pl_j, cap, counts_bits)
    assert_expand_equal_on_valid(nt, out, ref_xla, cap)
    assert_expand_equal_on_valid(nt, out, ref_pallas, cap)


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_expand_matches_jax(name):
    nt, cap = EXPAND_CASES[name]
    _case(nt, cap, seed=len(name))


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_partition_mirror_matches_plain(name):
    """csrc/expand.cu's merge-path partition, mirrored step by step
    (kernels/expand.py::expand_partition_plain), gives the plain version's
    owner, rank and payload on every valid slot, and on EVERY slot the
    upper bound of the slot in the inclusive cumsum, clamped to the last
    gaussian (what the kernel's function is)."""
    nt, cap = EXPAND_CASES[name]
    nt, payload = expand_inputs(nt, seed=len(name))
    nt_t, pl_t = torch.from_numpy(nt), torch.from_numpy(payload)
    out = texpand.expand_partition_plain(nt_t, pl_t, cap)
    assert_expand_equal_on_valid(nt, out, texpand.expand_instances_plain(nt_t, pl_t, cap), cap)
    ends = torch.cumsum(nt_t.long(), 0)
    g = torch.clamp(torch.searchsorted(ends, torch.arange(cap), right=True), max=nt.shape[0] - 1)
    off = torch.cat([torch.zeros(1, dtype=torch.int64), ends])[g]
    assert torch.equal(out[0].long(), g)
    assert torch.equal(out[1].long(), torch.arange(cap) - off)
    assert torch.equal(out[2], pl_t[:, g])
    pieces = -(-(nt.shape[0] + cap) // texpand.PIECE)
    if name in ("culled_run_longer_than_a_piece", "cap_not_a_multiple_of_a_piece",
                "total_exactly_the_cap"):
        assert pieces > 1
    if name == "cap_not_a_multiple_of_a_piece":
        assert cap % texpand.PIECE != 0 and cap % texpand.ITEMS != 0
    if name == "culled_run_longer_than_a_piece":
        runs = np.diff(np.flatnonzero(np.diff(np.r_[1, nt, 1] == 0)))[::2]
        assert runs.max() > texpand.PIECE
    if name == "total_exactly_the_cap":
        assert int(nt.sum()) == cap


def test_counts_packed_in_payload():
    rng = np.random.default_rng(6)
    nt = rng.integers(0, 5, 500).astype(np.int32)
    nt[100:300] = 0
    _case(nt, cap=1024, seed=6, counts_bits=10)


def test_expand_rejects_bad_inputs():
    nt = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        texpand.expand_instances(nt.long(), torch.zeros((4, 8), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        texpand.expand_instances(nt, torch.zeros((3, 8), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        texpand.expand_instances(nt, torch.zeros((4, 8), dtype=torch.int32), 0)
