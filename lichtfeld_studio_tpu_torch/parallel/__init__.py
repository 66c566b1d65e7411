from lichtfeld_studio_tpu_torch.parallel.data_parallel import (  # noqa: F401
    RankContext,
    batch_camera,
    broadcast_state,
    dryrun_multichip,
    make_camera_batch,
    dp_train_step,
    reduce_grads,
    spawn_ranks,
    state_digest,
)
