from glnn_tpu_torch.utils.common import (
    BGNN_data,
    CPF_data,
    NonHom_data,
    OGB_data,
    SYNTH_prefix,
    check_readable,
    check_writable,
    get_evaluator,
    get_logger,
    set_seed,
)
from glnn_tpu_torch.utils.config import get_training_config
from glnn_tpu_torch.utils.checkpoint import load_model, save_model
from glnn_tpu_torch.utils.splits import (
    get_train_val_test_split,
    graph_split,
    idx_split,
    sample_per_class,
)

__all__ = [
    "CPF_data", "OGB_data", "NonHom_data", "BGNN_data", "SYNTH_prefix",
    "set_seed", "get_evaluator", "check_writable", "check_readable",
    "get_logger", "get_training_config", "sample_per_class",
    "get_train_val_test_split", "idx_split", "graph_split", "save_model",
    "load_model",
]
