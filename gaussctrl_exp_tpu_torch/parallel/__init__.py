"""Sharded rendering, training and edit generation on ``torch.distributed``
(the port of ``gaussctrl_exp_tpu/parallel``)."""

from .sharded import (
    ShardedRenderConfig,
    make_mesh,
    make_sharded_render_loss,
    make_sharded_train_step,
    shard_params,
)

__all__ = [
    "ShardedRenderConfig",
    "make_mesh",
    "make_sharded_render_loss",
    "make_sharded_train_step",
    "shard_params",
]
