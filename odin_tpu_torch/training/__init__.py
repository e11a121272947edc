"""Training of the port: the state, the optimizers, the fused step,
multi-seed training, the trainer, its callbacks and early stopping, the
experiment sweep (``run_hydra``) and the ``ScoreBoard``."""
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
    multiseed_device_dataset_steps,
    scan_steps,
    set_param_subtree,
    stack_states,
    state_from_host,
    state_to_host,
    step_indices,
    unstack_states,
    use_ema_params,
)
from odin_tpu_torch.training.callbacks import (BestWeights, Callback,
                                               early_stopping_callback)
from odin_tpu_torch.training.early_stopping import (
    EarlyStopping, exponential_moving_average)
from odin_tpu_torch.training.experimenter import (get_output_dir, hash_config,
                                                  parse_config, run_hydra)
from odin_tpu_torch.training.scores import ScoreBoard
from odin_tpu_torch.training.trainer import (Trainer, get_current_trainer,
                                             read_tensorboard)
