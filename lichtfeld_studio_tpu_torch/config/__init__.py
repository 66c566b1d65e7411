from lichtfeld_studio_tpu_torch.config.parameters import (  # noqa: F401
    DatasetConfig,
    OptimizationParameters,
    TrainingParameters,
    load_optim_params_from_json,
)
