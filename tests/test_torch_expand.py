"""Port parity for kernel P1 (instance expansion): the port's
expand_instances on CPU tensors (its plain version) against the JAX
package's Pallas kernel in interpret mode and the XLA scatter-marker
construction, on the cases of tests/test_expand_pallas.py. Exact equality
on valid slots; in-bounds g everywhere. The CUDA kernel against the plain
version is in test_torch_kernels_cuda.py."""

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
