"""The port's ResNet and subband gates against irw_tpu's, same weights.

Both packages get one parameter set: the flax init, with BatchNorm scales,
biases and statistics redrawn with numpy (``randomize``), carried across by
``irw_tpu_torch.bridge``.  Small ResNets (two stages, width 8, both block
types) on 20² and 17² inputs, so the stem, the max-pool, the stride-2
projections and odd sizes are all exercised.

Tolerance 1e-4 on the f32 features and gates (same math in another
summation order); in training the BatchNorm running statistics to 1e-5.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from irw_tpu.models import attention_blocks as jax_gates
from irw_tpu.models import resnet as jax_resnet
from irw_tpu.models.resnet import BasicBlock as JaxBasic
from irw_tpu.models.resnet import Bottleneck as JaxBottleneck
from irw_tpu.models.resnet import ResNet as JaxResNet
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models import attention_blocks
from irw_tpu_torch.models.resnet import ResNet, resnet18, resnet50
from test_torch_vit import randomize

TOL = 1e-4
STATS_TOL = 1e-5


def randomize_all(variables, seed):
    """``randomize``, and every kernel that starts at zero redrawn too (so
    zero-initialised classifiers give logits that mean something)."""
    out = traverse_util.flatten_dict(randomize(variables, seed))
    rng = np.random.RandomState(seed + 100)
    for path, leaf in out.items():
        if path[-1] == "kernel" and not leaf.any():
            out[path] = (0.05 * rng.randn(*leaf.shape)).astype(np.float32)
    return traverse_util.unflatten_dict(out)


def resnet_pair(block, size, seed=0, batch=3):
    jmodel = JaxResNet(stage_sizes=(1, 2), block=JaxBottleneck if block == "bottleneck"
                       else JaxBasic, width=8)
    x = np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=True)
    variables = randomize(variables, seed)
    model = ResNet(stage_sizes=(1, 2), block=block, width=8)
    load_jax_variables(model, variables)
    return jmodel, variables, model.eval(), x


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
@pytest.mark.parametrize("size", [20, 17])
def test_resnet_eval_matches_jax(block, size):
    jmodel, variables, model, x = resnet_pair(block, size)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (3, 16 * (4 if block == "bottleneck" else 1))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_training_batch_norm_matches_jax(block):
    jmodel, variables, model, x = resnet_pair(block, 20, seed=1, batch=4)
    ref, updated = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model.train()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=TOL)
    stats = from_jax_variables({"params": variables["params"], **updated})
    sd = model.state_dict()
    for key, value in stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), value, rtol=0, atol=STATS_TOL,
                                       err_msg=key)


def test_full_resnet_shapes():
    """resnet18 and resnet50 at full width: parameter shapes and feature
    sizes follow the flax modules."""
    for ctor, jctor, dim in ((resnet18, "resnet18", 512), (resnet50, "resnet50", 2048)):
        jmodel = getattr(jax_resnet, jctor)()
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 32, 32, 3)), train=True))
        sd = from_jax_variables(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                       shapes))
        model = ctor()
        ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert ours == {k: tuple(v.shape) for k, v in sd.items()}
        assert model.out_dim == dim


GATES = [("cbam", jax_gates.SubbandCBAM), ("eca", jax_gates.SubbandEca),
         ("channel", jax_gates.SubbandChannelGate)]


@pytest.mark.parametrize("name,jax_cls", GATES)
def test_subband_gates_match_jax(name, jax_cls):
    x = np.random.RandomState(2).randn(5, 4, 32).astype(np.float32)
    jgate = jax_cls(num_subbands=4)
    params = jgate.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = randomize_all(params, 3)
    fused_ref, scale_ref = jgate.apply(params, jnp.asarray(x))
    gate = load_jax_variables(attention_blocks.SUBBAND_GATES[name](num_subbands=4), params)
    with torch.no_grad():
        fused, scale = gate(torch.from_numpy(x))
    np.testing.assert_allclose(scale.numpy(), np.asarray(scale_ref), rtol=0, atol=TOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(fused_ref), rtol=0, atol=TOL)
    # a mean over the subbands: the gate-weighted sum divided by S
    np.testing.assert_allclose(fused.numpy(), np.einsum("bsd,bs->bd", x, scale.numpy()) / 4,
                               rtol=0, atol=1e-6)
