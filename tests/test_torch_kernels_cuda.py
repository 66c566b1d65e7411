"""The port's CUDA kernels against their plain PyTorch versions on the same
CUDA tensors. Needs an NVIDIA GPU; skips elsewhere. Imports no JAX, so on
a machine without it run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch.kernels import blend as tblend
from lichtfeld_studio_tpu_torch.kernels import expand as texpand
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
from tests.torch_parity import (
    EXPAND_CASES,
    assert_expand_equal_on_valid,
    binned_blend_inputs,
    expand_inputs,
    random_scene,
    require_cuda,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_expand_kernel_matches_plain(name):
    """Exact equality on valid slots, in-bounds g everywhere."""
    dev = require_cuda()
    nt, cap = EXPAND_CASES[name]
    nt, payload = expand_inputs(nt, seed=len(name))
    plain = texpand.expand_instances_plain(torch.from_numpy(nt), torch.from_numpy(payload), cap)
    before = texpand.expand_instances.launches
    out = texpand.expand_instances(
        torch.from_numpy(nt).to(dev), torch.from_numpy(payload).to(dev), cap
    )
    torch.cuda.synchronize()
    assert texpand.expand_instances.launches == before + 1
    assert_expand_equal_on_valid(nt, out, plain, cap)


@pytest.mark.parametrize("n,spread", [(400, 0.8), (600, 0.25)])
@pytest.mark.parametrize("with_depth", [False, True])
def test_blend_kernel_matches_plain(n, spread, with_depth):
    """Within 1e-4: alpha and transmittance follow the plain version's
    operation order; the colour sums run in another order. The second
    scene stacks hundreds of gaussians per tile (early stop, several
    batches)."""
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(n), n=n, spread=spread, device=dev)
    args, kw = binned_blend_inputs(sd, cam, dev, with_depth=with_depth)
    img_p, alpha_p = tblend.blend_forward_plain(*args, **kw)
    before = tblend.blend_forward.launches
    img_k, alpha_k = tblend.blend_forward(*args, **kw)
    torch.cuda.synchronize()
    assert tblend.blend_forward.launches == before + 1
    assert torch.isfinite(img_k).all()
    assert float((img_k - img_p).abs().max()) <= 1e-4
    assert float((alpha_k - alpha_p).abs().max()) <= 1e-4


def test_kernel_render_matches_oracle():
    """The whole binned path on the card against the dense oracle: the
    early stop leaves out < 1/512 per pixel (atol 2.5e-3)."""
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(7), n=300, device=dev)
    params = cam.device_params(dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    with torch.no_grad():
        out_k = rasterize(sd, params, bg, mode="cuda", inference=True, instance_cap=16384)
        out_o = rasterize(sd, params, bg, mode="oracle")
    assert float((out_k.image - out_o.image).abs().max()) <= 2.5e-3
    assert float((out_k.alpha - out_o.alpha).abs().max()) <= 2.5e-3


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(3), n=50, device=dev)
    args, kw = binned_blend_inputs(sd, cam, dev)
    with pytest.raises(ValueError):
        tblend.blend_forward(*args, **{**kw, "tile_size": 16})
    with pytest.raises(ValueError):  # tensors on two devices
        tblend.blend_forward(*args[:3], args[3].cpu(), *args[4:], **kw)
