"""Training of the port: the state, the optimizers, the fused step, the
trainer, its callbacks and early stopping."""
from odin_tpu_torch.training.core import (
    EMA_KEY,
    SGD,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    Lamb,
    Lion,
    Noise,
    Optimizer,
    RMSProp,
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
    state_from_host,
    state_to_host,
    step_indices,
    use_ema_params,
)
from odin_tpu_torch.training.callbacks import (BestWeights, Callback,
                                               early_stopping_callback)
from odin_tpu_torch.training.early_stopping import (
    EarlyStopping, exponential_moving_average)
from odin_tpu_torch.training.trainer import (Trainer, get_current_trainer,
                                             read_tensorboard)
