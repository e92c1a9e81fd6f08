"""A trained run, rebuilt from its directory: what the tools that read a run
share (``evaluate``, ``attention``, ``alpha_weights``, ``plot_exemples`` and
``tools/export_serving``; the JAX package's CLIs each repeat these lines,
e.g. ``evaluate.py:28-50``).

``load_run(run_dir)`` reads the rolling checkpoint (``engine.checkpoint``;
the config travels inside it), builds the config's model through the
``Getter`` with its weights, in eval mode on ``device``, and the eval side:
the test transforms and the eval datasets.  The ViTs' position embeddings
are sized as ``run`` sizes them, from the first batch of the run's sampler
through its train stages (``run.first_sample``); a checkpoint whose
``pos_embed`` has another shape raises, naming both.  ``quant="int8"`` builds
the ViT blocks with ``quant_int8`` (the parameters are the same, so the
checkpoint applies as it is).  ``device=None`` means the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from irw_tpu_torch.config import Config
from irw_tpu_torch.data.loader import EpochLoader
from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.engine.checkpoint import load_checkpoint
from irw_tpu_torch.getter import Getter


@dataclass
class Run:
    model: object            # in eval mode, on the run's device, the checkpoint's weights
    meta: dict               # config, epoch, score, best_score
    config: Config
    host_test: object        # the test transforms: host stage, device stage
    device_test: object
    eval_datasets: dict      # split → dataset or {"query", "gallery"}
    image_size: tuple        # (height, width) the model's ViTs were sized for
    device: object

    def eval_split(self, eval_set: str = "test"):
        """The eval side of ``eval_set``, or the first split there is."""
        return self.eval_datasets.get(eval_set) or next(iter(self.eval_datasets.values()))


def model_config(config, quant: str | None = None) -> dict:
    """The run's model config; with ``quant="int8"`` its ViT blocks on the
    int8 path (``tools/export_serving.py:126-134``)."""
    cfg = dict(config.model)
    if quant == "int8":
        kw = dict(cfg.get("kwargs") or {})
        kw["vit_kwargs"] = dict(kw.get("vit_kwargs") or {}, quant_int8=True)
        cfg["kwargs"] = kw
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}; int8 or None")
    return cfg


def check_position_embeddings(model, weights: dict) -> None:
    """Raise if a ``pos_embed`` of ``weights`` and the model's differ in
    shape, naming both."""
    own = model.state_dict()
    for name, tensor in weights.items():
        if name.endswith("pos_embed") and name in own and own[name].shape != tensor.shape:
            raise ValueError(
                f"{name}: the checkpoint's position embeddings are {tuple(tensor.shape)}, the "
                f"model sized from the run's first train batch has {tuple(own[name].shape)}; "
                "the run's dataset or transform no longer gives the images it trained on")


def load_run(run_dir: str, device=None, quant: str | None = None) -> Run:
    """The run under ``run_dir`` (it holds ``weights/rolling``), rebuilt."""
    from irw_tpu_torch.run import first_sample, first_sampler

    device = resolve_device(device)
    restored = load_checkpoint(run_dir, map_location="cpu")
    if restored is None:
        raise FileNotFoundError(f"no rolling checkpoint under {run_dir}")
    state, meta = restored
    config = Config(meta["config"])
    seed = int(config.experience.get("seed", 333))
    getter = Getter()
    (host_train, device_train), (host_test, device_test) = getter.get_transform(
        config.get("transform", {}), device)
    train_ds, eval_datasets = getter.get_dataset(config.dataset)
    sample = first_sample(first_sampler(getter, config, train_ds, seed), train_ds, host_train,
                          device_train, seed)
    image_size = tuple(sample.shape[-3:-1])
    model = getter.get_model(model_config(config, quant), device, seed, image_size=image_size)
    check_position_embeddings(model, state["model"])
    model.load_state_dict(state["model"])
    model.eval()
    return Run(model, meta, config, host_test, device_test, eval_datasets, image_size, device)


def mean_aux(run: Run, key: str, eval_set: str = "test", batch_size: int = 64,
             missing: str = "") -> tuple[np.ndarray, int]:
    """``aux[key]`` of the eval-mode forward averaged over the samples of
    ``eval_set`` (its gallery, for a query/gallery split), with the count:
    each batch's sum over its samples in f32 numpy, the sums added in
    order, one division at the end (``attention.py:51-63``).  Raises
    ``SystemExit(missing)`` when the model returns no ``aux[key]``."""
    dataset = run.eval_split(eval_set)
    if isinstance(dataset, dict):
        dataset = dataset["gallery"]
    order = np.arange(len(dataset))
    batches = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
    loader = EpochLoader(dataset, batches, run.host_test, num_workers=4, train=False)
    totals, count = None, 0
    with torch.inference_mode():
        for batch in loader:
            _, aux = run.model(run.device_test(batch["image"]))
            values = aux.get(key)
            if values is None:
                raise SystemExit(missing)
            values = values.float().cpu().numpy()
            totals = values.sum(0) if totals is None else totals + values.sum(0)
            count += values.shape[0]
    return totals / count, count
