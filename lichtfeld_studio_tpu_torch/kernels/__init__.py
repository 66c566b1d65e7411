"""Hand-written CUDA kernels (csrc/) and their PyTorch wrappers."""


def training_kernels() -> dict:
    """The wrappers of the training paths' kernels, P1-P6 and the EWA and
    UT projections' two each, by name; each counts its launches in
    `.launches`."""
    from lichtfeld_studio_tpu_torch.kernels import (
        blend, expand, projection, segment_reduce, ut_projection, world_blend)

    return {f.__name__: f for f in (
        expand.expand_instances, blend.blend_forward, blend.blend_backward,
        segment_reduce.segment_reduce, world_blend.world_blend_forward,
        world_blend.world_blend_backward, projection.project_ewa_forward,
        projection.project_ewa_backward, ut_projection.project_ut_forward,
        ut_projection.project_ut_backward)}
