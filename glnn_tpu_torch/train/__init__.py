from glnn_tpu_torch.train.engine import (
    distill_run_inductive,
    distill_run_transductive,
    make_eval_fn,
    make_gnn_train_step,
    make_mlp_epoch_fn,
    make_mlp_eval_fn,
    run_inductive,
    run_transductive,
)
from glnn_tpu_torch.train.losses import (
    accuracy,
    kl_div_batchmean_log_target,
    log_softmax,
    nll_loss,
)
from glnn_tpu_torch.train.state import make_adam, restore, snapshot

__all__ = [
    "run_transductive", "run_inductive", "distill_run_transductive",
    "distill_run_inductive", "make_eval_fn",
    "make_gnn_train_step",
    "make_mlp_epoch_fn", "make_mlp_eval_fn", "make_adam", "snapshot",
    "restore", "log_softmax", "nll_loss", "kl_div_batchmean_log_target",
    "accuracy",
]
