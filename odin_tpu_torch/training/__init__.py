"""Training of the port: the state, the optimizer and the fused step."""
from odin_tpu_torch.training.core import (
    EMA_KEY,
    Noise,
    Optimizer,
    TrainState,
    TrainStep,
    TrainStepFn,
    build_train_step_fn,
    device_dataset_steps,
    exponential_decay,
    extract_partitions,
    get_param_subtree,
    make_optimizer,
    merge_partitions,
    scan_steps,
    set_param_subtree,
    use_ema_params,
)
