"""Multi-card serving and evaluation over a ``torch.distributed`` process
group (the port's counterpart of ``irw_tpu/parallel/``): the group helpers
of ``mesh.py`` here, the metric suite over a group in ``eval_sharding.py``.
Data, band, FSDP, tensor and pipeline parallelism for training wait for
ROADMAP A13b-A13f."""

from irw_tpu_torch.parallel.mesh import (
    agreed,
    all_gather_rows,
    close_group,
    init_group,
    local_rank,
    local_rows,
    pad_to_multiple,
    rank,
    refuse_group_training,
    replicate,
    world_size,
)

__all__ = [
    "agreed",
    "all_gather_rows",
    "close_group",
    "init_group",
    "local_rank",
    "local_rows",
    "pad_to_multiple",
    "rank",
    "refuse_group_training",
    "replicate",
    "world_size",
]
