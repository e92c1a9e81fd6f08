"""Object factory (port of ``irw_tpu/getter.py:28-146``, ``Getter``): every
training object from the composed config, through what the port already
has — ``transforms.build_transforms``, ``data.get_dataset``,
``samplers.get_sampler``, ``models.get_model``, ``losses.build_losses``,
``engine.optimizers`` and ``engine.get_memory``.

The JAX ``init_train_state`` of the same module is
``engine.init_train_state`` in the port.
"""

from __future__ import annotations

import logging

from irw_tpu_torch.data.registry import QUERY_GALLERY_DATASETS, get_dataset
from irw_tpu_torch.engine.optimizers import build_loss_optimizers, build_optimizers
from irw_tpu_torch.engine.xbm import get_memory
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.samplers import get_sampler
from irw_tpu_torch.transforms import build_transforms

LOGGER = logging.getLogger(__name__)


class Getter:
    """Build every training object from the composed config."""

    def get_transform(self, transform_config, device=None):
        """``{train: {...}, test: {...}}`` (ordered name → kwargs) →
        ((host, device) for train, (host, device) for test)."""
        train_cfg = transform_config.get("train") if transform_config else None
        test_cfg = transform_config.get("test") if transform_config else None
        return (build_transforms(train_cfg or {}, device=device),
                build_transforms(test_cfg or {}, device=device))

    def get_dataset(self, dataset_config):
        """(train dataset, {"test": eval side}): a {query, gallery} dict for
        the query/gallery families, else the test split (the train set if
        the family has none); a ``distractor`` entry ({name, mode, kwargs})
        adds that dataset to the eval side as ``"distractor"``, one test
        split becoming its own query and gallery."""
        name = dataset_config["name"]
        kwargs = dict(dataset_config.get("kwargs") or {})
        kwargs.pop("mode", None)
        train_ds = get_dataset(name, mode="train", **kwargs)
        if name in QUERY_GALLERY_DATASETS:
            test = {"query": get_dataset(name, mode="query", **kwargs),
                    "gallery": get_dataset(name, mode="gallery", **kwargs)}
        else:
            try:
                test = get_dataset(name, mode="test", **kwargs)
            except Exception:  # the JAX getter's rule: no test split, eval on train
                test = train_ds
        distractor = dataset_config.get("distractor")
        if distractor:  # extra gallery items that match no query
            if not isinstance(test, dict):
                test = {"query": test, "gallery": test}
            test["distractor"] = get_dataset(distractor["name"],
                                             mode=distractor.get("mode", "gallery"),
                                             **dict(distractor.get("kwargs") or {}))
        return train_ds, {"test": test}

    def get_sampler(self, dataset, sampler_config):
        return get_sampler(sampler_config["name"], dataset,
                           **dict(sampler_config.get("kwargs") or {}))

    def get_model(self, model_config, device=None, seed: int = 0, image_size=None):
        """The model of ``model_config`` ({name, kwargs}) on ``device``, its
        weights drawn from ``seed``; ``image_size`` (height, width of its
        input) sizes its ViTs' position embeddings."""
        name = model_config["name"]
        kwargs = dict(model_config.get("kwargs") or {})
        LOGGER.info(f"building model {name} ({kwargs})")
        return get_model(name, device=device, seed=seed, image_size=image_size, **kwargs)

    def get_loss(self, loss_config):
        return build_losses(loss_config)

    def get_optimizer(self, model, optimizer_config):
        return build_optimizers(list(optimizer_config), model)

    def get_loss_optimizer(self, loss_config, losses):
        """Each loss's own optimizer (its entry's ``kwargs.optimizer``)."""
        return build_loss_optimizers(loss_config, losses)

    def get_memory(self, memory_config, embedding_dim: int, label_shape=()):
        return get_memory(memory_config, embedding_dim, label_shape)
