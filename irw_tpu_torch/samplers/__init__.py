"""Batch samplers: host-side epoch-static batch index lists, made anew by
``reshuffle(epoch)`` each epoch."""

from irw_tpu_torch.samplers.samplers import (
    HierarchicalSampler,
    MPerClassSampler,
    RandomSampler,
    get_sampler,
)

__all__ = ["HierarchicalSampler", "MPerClassSampler", "RandomSampler", "get_sampler"]
