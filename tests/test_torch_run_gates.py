"""``irw_tpu_torch.alpha_weights.generate_alphas`` against the JAX CLI
``alpha_weights.generate_alphas`` on the same weights, for two models whose
forward returns ``aux["gate"]``:

- ``multidino_attention_cbam`` (the family's CBAM fusion head) at the
  runner's test width: 4 bands of a 64-wide, 2-block ``test_tiny`` ViT on
  16² images, f32;
- ``wcnn_attention_ce`` over ``transform=cub_dwt`` on resnet18 branches
  (``backbone: resnet18``, two basic blocks a stage) at 32² images: the
  device stage's ``CustomTransform`` reaches K4's plain version in the port
  and the Pallas kernel in the JAX package.

Each on ``dataset=synthetic`` at 12 images.  The JAX CLI is handed the
run's config in its composed order (``in_composed_order``).  No training: the port's model
is built as ``load_run`` builds it (sized from the run's first train
batch), its biases, norms and BatchNorm statistics redrawn
(``test_torch_vit.randomize``), and both packages' checkpoints are written
from those weights with the composed config.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import sys

import numpy as np
import pytest
import torch

import alpha_weights as jax_alpha_weights
from irw_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from irw_tpu_torch import alpha_weights as port_alpha_weights
from irw_tpu_torch.bridge import load_jax_variables
from irw_tpu_torch.config import compose
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.run import first_sample, first_sampler
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from test_torch_run_tools import jax_variables
from test_torch_vit import randomize

DATA = ["dataset=synthetic", "dataset.kwargs.num_samples=12", "dataset.sampler.kwargs.batch_size=4"]
CBAM = ["model=multidino_attention_cbam", "transform=voc_swt",
        "model.kwargs.backbones_config=[{name: test_tiny, frozen: false}]",
        "+model.kwargs.vit_kwargs={img_size: 16}", "model.kwargs.with_autocast=false",
        "model.kwargs.fusion_config.input_dim=64", "model.kwargs.fusion_config.output_dim=64",
        "dataset.kwargs.image_size=16", "transform.train.Resize.size=16",
        "transform.train.RandomResizedCrop.size=16", "transform.test.Resize.size=16",
        "transform.test.CenterCrop.size=16"]
WCNN = ["model=wcnn_attention_ce", "transform=cub_dwt", "+model.kwargs.backbone=resnet18",
        "model.kwargs.num_classes=8", "dataset.kwargs.image_size=32",
        "transform.train.Resize.size=32", "transform.train.RandomResizedCrop.size=32",
        "transform.test.Resize.size=32", "transform.test.CenterCrop.size=32"]


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def write_runs(root, overrides) -> tuple[str, str]:
    """Both packages' checkpoints of one model's weights (the port's init,
    biases, norms and statistics redrawn) with the composed config."""
    cfg = compose(CONFIG_DIR, "default", DATA + overrides)
    seed = int(cfg.experience.get("seed", 333))
    getter = Getter()
    (host_train, device_train), _ = getter.get_transform(cfg.transform, "cpu")
    train_ds, _ = getter.get_dataset(cfg.dataset)
    sample = first_sample(first_sampler(getter, cfg, train_ds, seed), train_ds, host_train,
                          device_train, seed)
    model = getter.get_model(cfg.model, "cpu", seed, image_size=tuple(sample.shape[-3:-1]))
    variables = randomize(jax_variables(model), 0)
    load_jax_variables(model, variables)
    meta = {"config": cfg.to_dict(), "epoch": 1, "score": None, "best_score": None}
    port_dir, jax_dir = root / "port", root / "jax"
    (port_dir / "weights").mkdir(parents=True)
    torch.save({"state": {"model": model.state_dict()}, "meta": meta},
               port_dir / "weights" / "rolling")
    jax_save_checkpoint(str(jax_dir), variables, meta["config"], 1)
    return str(port_dir), str(jax_dir)


def in_composed_order(monkeypatch, module, port_dir: str):
    """Hand ``module``'s ``load_checkpoint`` the run's config in its
    composed order: orbax restores a dict's keys sorted, which would run
    ``cub_dwt``'s device ops as CustomTransform, then Normalize."""
    config = torch.load(f"{port_dir}/weights/rolling", weights_only=True)["meta"]["config"]
    load = module.load_checkpoint

    def ordered(run_dir, *args, **kwargs):
        state, meta = load(run_dir, *args, **kwargs)
        assert meta["config"] == config   # the same config, its keys sorted
        return state, dict(meta, config=config)

    monkeypatch.setattr(module, "load_checkpoint", ordered)


@pytest.mark.parametrize("overrides", [CBAM, WCNN], ids=["cbam_head", "wcnn_cub_dwt"])
def test_generate_alphas_matches_jax(overrides, tmp_path, monkeypatch):
    port_dir, jax_dir = write_runs(tmp_path, overrides)
    ours = port_alpha_weights.generate_alphas(port_dir, batch_size=5, device="cpu")
    in_composed_order(monkeypatch, jax_alpha_weights, port_dir)
    ref = np.asarray(jax_alpha_weights.generate_alphas(jax_dir, batch_size=5))
    assert ours.shape == ref.shape and ours.shape[-1] == 4
    assert np.isfinite(ours).all() and np.ptp(ours) > 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_generate_alphas_names_a_model_without_a_gate(tmp_path):
    """The flagship's cross-attention head returns no ``aux["gate"]``."""
    flagship = ["model=multidino_attention_hashing_ortho", "model.kwargs.fusion_config.output_dim=64",
                "model.kwargs.fusion_config.num_heads=2"] + [
        o for o in CBAM if not o.startswith(("model=", "model.kwargs.fusion_config"))]
    port_dir, _ = write_runs(tmp_path, flagship)
    with pytest.raises(SystemExit, match="no gate alphas"):
        port_alpha_weights.generate_alphas(port_dir, batch_size=5, device="cpu")
