"""``bridge.jax_param_paths`` (the port's parameter names → flax leaf paths,
which adaptive weighting's head scope and the instrumentor read) against
the flax trees of irw_tpu's models.

For the files of ``configs/model/`` of the multi-band ViT family and the HF
towers, composed over ``configs/default.yaml`` (the single-trunk models in
``tests/test_torch_param_paths_trunks.py``, the WCNNs, fusion heads, bare
trunks, gates and ViT layouts in ``tests/test_torch_param_paths_cnn.py``, the wavelet
CNNs in ``tests/test_torch_wavenet_configs.py``): the JAX init's leaves
(``jax.eval_shape``, no compile) as zero-stride views, each holding its
own index, go through ``from_jax_variables``; every port parameter (built
on the meta device) must then hold exactly the index of the leaf
``jax_param_paths`` names, and the named leaves must be all the leaves.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from irw_tpu.models import get_model as jax_get_model
from irw_tpu_torch.bridge import from_jax_variables, jax_param_paths
from irw_tpu_torch.config import compose
from irw_tpu_torch.models import MODEL_REGISTRY
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from test_torch_factory import FAMILY, HF_TOWERS

RNGS = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "band_drop"))}
# the models that take images; the others take a (B, 4, H, W, 3) band stack
IMAGE_MODELS = ("DINOHashBaseline", "DinoModelCE", "RetrievalNet", "ResNetCE", "ResNetHashing",
                "ResNet50Mod")


def marked(shapes) -> tuple:
    """(variables whose ``params`` leaves are zero-stride views each holding
    its own index, {flax path: index})."""
    flat = traverse_util.flatten_dict(dict(shapes["params"]))
    index = {"/".join(path): i for i, path in enumerate(flat)}
    params = {path: np.broadcast_to(np.float32(i), leaf.shape)
              for i, (path, leaf) in enumerate(flat.items())}
    stats = {path: np.broadcast_to(np.float32(0), leaf.shape) for path, leaf in
             traverse_util.flatten_dict(dict(shapes.get("batch_stats", {}))).items()}
    return ({"params": traverse_util.unflatten_dict(params),
             "batch_stats": traverse_util.unflatten_dict(stats)}, index)


def assert_paths_are_the_leaves(model, shapes):
    """Every parameter of ``model`` carries, through the bridge, the flax
    leaf ``jax_param_paths`` names; the names cover every leaf."""
    variables, index = marked(shapes)
    state = from_jax_variables(variables)
    paths = jax_param_paths(model)
    assert set(paths) == {n for n, _ in model.named_parameters()}
    assert set(paths.values()) == set(index)
    for name, path in paths.items():
        value = np.asarray(state[name])
        assert value.min() == value.max() == index[path], (name, path)


def _config_shapes(config):
    cfg = compose(CONFIG_DIR, "default", [f"model={config}"])
    name, kwargs = cfg.model.name, cfg.model.kwargs.to_dict()
    with torch.device("meta"):
        model = MODEL_REGISTRY[name](torch.device("cpu"), **kwargs)
    bands = len(getattr(getattr(model, "backbone", None), "branches", range(4)))
    x = (1, 224, 224, 3) if type(model).__name__ in IMAGE_MODELS else (1, bands, 224, 224, 3)
    jmodel = jax_get_model(name, **kwargs)
    return model, jax.eval_shape(lambda: jmodel.init(RNGS, jnp.zeros(x), train=True))


@pytest.mark.parametrize("config", FAMILY + HF_TOWERS)
def test_config_param_paths_are_the_flax_leaves(config):
    """Full width: each port parameter's flax path is the leaf the bridge
    reads it from, for the multi-band ViT family and the HF towers."""
    assert_paths_are_the_leaves(*_config_shapes(config))
