"""The port's micro-batched train step against irw_tpu's
``forward_microbatched`` (``sub_batch`` below the batch).

One step of the small flagship (the YAML's kwargs at depth 1 on 28² images,
f32, attention on the kernel route, block remat, ``use_bn=True``, fusion
dropout 0, HashLoss, basic.yaml's AdamW at lr 1e-3, ``clip_grad`` 5,
``ortho_scale`` 2) on a batch of 15 through both packages from one state,
at four chunkings: an even split (5 + 5 + 5), a separate tail (6 + 6 + 3),
a tail of one merged into the last chunk (7 + 8), and ``sub_batch`` at or
above the batch (the plain step); the two tail cases run in
``test_torch_microbatch_tails.py`` (each file keeps to its time).  No chunk is below 3 samples: a
BatchNorm over 2 samples maps each feature to ±1 and magnifies rounding
past the tolerances.  The HashHead's BatchNorm normalises each
chunk by that chunk's statistics, and its running statistics take one
update per chunk; a chunked step is not the plain step.

Tolerances as ``test_torch_train_step.py``: the metrics within 1e-5
relative, the parameters' moves within 1e-3·lr where the gradient is well
conditioned, the running statistics within 1e-5.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu.engine.train import _build_hyper as jax_build_hyper
from irw_tpu.engine.train_step import build_train_step as jax_build_train_step
from irw_tpu.getter import Getter
from irw_tpu.losses import build_losses as jax_build_losses
from irw_tpu.models import get_model as jax_get_model
from irw_tpu.transforms.pipeline import DeviceTransform as JaxDeviceTransform
from irw_tpu_torch.bridge import from_jax_variables, load_jax_loss_params, load_jax_variables
from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.engine.train_step import micro_batches
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.ops import attention as port_attention
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_multi_dino import flagship_yaml
from test_torch_train_model import EXACT_ZEROS
from test_torch_train_step import (
    CLIP, IMG, LR, METRIC_TOL, METRICS, OPS, ORTHO_SCALE, _configs, _deltas_agree,
    jax_state_from, jstate_variables,
)
from test_torch_vit import randomize

BATCH, DEPTH = 15, 1
CHUNKINGS = {"even": (5, [5, 5, 5]), "tail": (6, [6, 6, 3]), "tail_of_one": (7, [7, 8]),
             "whole": (16, [15])}
BN = ("hash_head.bn.running_mean", "hash_head.bn.running_var")
_START = {}


def _batch():
    rng = np.random.RandomState(4)
    labels = (rng.rand(BATCH, 20) > 0.8).astype(np.float32)
    labels[:, 0] = 1.0
    return {"image": rng.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8), "label": labels}


def _start():
    """The JAX model, variables and optimizer pieces, built once."""
    if not _START:
        cfg = flagship_yaml()
        fusion = dict(cfg["kwargs"]["fusion_config"], dropout=0.0)
        kw = dict(cfg["kwargs"], fusion_config=fusion,
                  vit_kwargs={"depth": DEPTH, "dtype": "float32", "vmem_attn": True})
        jmodel = jax_get_model(cfg["name"], **kw)
        jdt = JaxDeviceTransform(OPS)
        rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
                "band_drop": jax.random.PRNGKey(2)}
        variables = jax.jit(lambda r, x: jmodel.init(r, x, train=True))(
            rngs, jdt(jnp.asarray(_batch()["image"])))
        _START.update(cfg=cfg, kw=kw, jmodel=jmodel, jdt=jdt,
                      variables=randomize(variables, 1))
    return _START


def _step_pair(sub_batch: int):
    """One step of both packages at ``sub_batch`` from one state: (JAX state
    before and after, JAX metrics, port metrics, port state after, port
    gradients)."""
    st = _start()
    opt_cfg, loss_cfg = _configs()
    jlosses = jax_build_losses(loss_cfg)
    entries = jax_optimizers.build_optimizers(opt_cfg, st["variables"]["params"])
    loss_tx = Getter().get_loss_optimizer(loss_cfg)
    jstate = jax_state_from(st["variables"], jlosses, entries, loss_tx)
    jstep = jax.jit(jax_build_train_step(st["jmodel"], jlosses, entries, loss_tx,
                                         device_transform=st["jdt"], clip_grad=CLIP,
                                         sub_batch=sub_batch))
    batch = _batch()
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                     jax_build_hyper(entries, 1, 0, 0, None, ORTHO_SCALE))

    model = get_model(st["cfg"]["name"], device="cpu",
                      **dict(st["kw"], vit_kwargs=dict(st["kw"]["vit_kwargs"], img_size=IMG)))
    load_jax_variables(model, jstate_variables(jstate))
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0)
    load_jax_loss_params(state.losses, jstate.loss_params)
    step = build_train_step(DeviceTransform(OPS, device="cpu"), clip_grad=CLIP,
                            sub_batch=sub_batch)
    metrics = step(state, batch, _build_hyper(state.optimizer_entries, 1, 0, 0, None,
                                              ORTHO_SCALE))
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return (jstate, jnew, {k: float(v) for k, v in jm.items()},
            {k: float(v) for k, v in metrics.items()}, state, grads)


@pytest.fixture(scope="module", params=["even", "whole"])
def pair(request):
    return request.param, _step_pair(CHUNKINGS[request.param][0])


def test_micro_batches_split_as_the_reference():
    for sub_batch, sizes in CHUNKINGS.values():
        assert micro_batches(BATCH, sub_batch) == sizes
    assert micro_batches(96, 32) == [32] * 3
    assert micro_batches(96, 40) == [40, 40, 16]
    assert micro_batches(96, 19) == [19] * 4 + [20]
    assert micro_batches(20, 19) == [20]


def test_microbatched_step_matches_jax(pair):
    check_step(pair)


def test_chunked_running_statistics_are_one_update_per_chunk(pair):
    check_running_statistics(pair)


def check_step(pair):
    case, (jstate, jnew, jm, metrics, state, grads) = pair
    for name in METRICS:
        assert metrics[name] == pytest.approx(jm[name], rel=METRIC_TOL), (case, name)
    assert metrics["grad_norm"] > CLIP
    start, ref = (from_jax_variables(jstate_variables(s)) for s in (jstate, jnew))
    ours = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    for name, _ in state.model.named_parameters():
        if not name.endswith(EXACT_ZEROS):
            _deltas_agree(name, ours[name], ref[name], start[name], [grads[name]], LR, 5e-4)
    for buf in BN:  # one momentum update per chunk, in chunk order, and no more
        assert not np.array_equal(ours[buf], start[buf]), (case, buf)
        np.testing.assert_allclose(ours[buf], ref[buf], atol=1e-5, rtol=1e-5,
                                   err_msg=f"{case} {buf}")


def check_running_statistics(pair):
    """flax's momentum 0.99 applied once per chunk, in chunk order, from the
    chunks' biased statistics of the HashHead's input: the recompute in the
    backward adds no update."""
    case, (jstate, _, _, _, state, _) = pair
    start = from_jax_variables(jstate_variables(jstate))
    model = get_model(_start()["cfg"]["name"], device="cpu", **dict(
        _start()["kw"], vit_kwargs=dict(_start()["kw"]["vit_kwargs"], img_size=IMG)))
    load_jax_variables(model, jstate_variables(jstate))
    seen = []
    model.hash_head.linear.register_forward_hook(lambda m, i, o: seen.append(o.detach()))
    model.train()
    x = DeviceTransform(OPS, device="cpu")(_batch()["image"])
    with torch.no_grad():
        model(x)
    logits = seen[0]
    mean, var = start[BN[0]].copy(), start[BN[1]].copy()
    pos = 0
    for n in CHUNKINGS[case][1]:
        chunk = logits[pos:pos + n].numpy().astype(np.float64)
        pos += n
        mean = 0.99 * mean + 0.01 * chunk.mean(0)
        var = 0.99 * var + 0.01 * chunk.var(0)
    np.testing.assert_allclose(state.model.hash_head.bn.running_mean.numpy(), mean, atol=2e-6)
    np.testing.assert_allclose(state.model.hash_head.bn.running_var.numpy(), var, atol=2e-6)


def test_chunk_recompute_launches(monkeypatch):
    """The attention core's calls in one micro-batched step of the small
    flagship (block remat): per chunk, the forward, the chunk's
    recompute and each block's own recompute run K2 (3 a block), and the
    backward runs K3 once a block."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = port_attention.attention_plain, port_attention.attention_plain_bwd

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(port_attention, "attention_plain", counting_fwd)
    monkeypatch.setattr(port_attention, "attention_plain_bwd", counting_bwd)
    st = _start()
    opt_cfg, loss_cfg = _configs()
    model = get_model(st["cfg"]["name"], device="cpu",
                      **dict(st["kw"], vit_kwargs=dict(st["kw"]["vit_kwargs"], img_size=IMG)))
    state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0)
    step = build_train_step(DeviceTransform(OPS, device="cpu"), sub_batch=4)
    step(state, _batch(), _build_hyper(state.optimizer_entries, 1, 0, 0, None))
    chunks = len(micro_batches(BATCH, 4))
    assert calls == {"fwd": 3 * DEPTH * chunks, "bwd": DEPTH * chunks}


def test_chunk_recompute_draws_the_forward_masks():
    """With dropout on, each chunk's recompute in the backward redraws the
    masks of its forward: the gradients of the checkpointed chunks equal
    those of the same chunks run without a checkpoint from the same seeds,
    bit for bit; the seeds come from the state's generators, which advance."""
    from irw_tpu_torch.engine.train_step import _run_chunk, chunk_seeds, forward_microbatched

    st = _start()
    kw = dict(st["kw"], fusion_config=dict(st["kw"]["fusion_config"], dropout=0.5),
              vit_kwargs=dict(st["kw"]["vit_kwargs"], img_size=IMG, dropout=0.2))
    model = get_model(st["cfg"]["name"], device="cpu", **kw).train()
    x = DeviceTransform(OPS, device="cpu")(_batch()["image"])

    def generators():
        return {name: torch.Generator().manual_seed(i) for i, name in
                enumerate(("dropout", "band_drop"))}

    grads = []
    for checkpointed in (True, False):
        model.zero_grad()
        gens = generators()
        if checkpointed:
            out, _ = forward_microbatched(model, x, gens, 6, {})
        else:
            sizes = micro_batches(BATCH, 6)
            starts = np.cumsum([0] + sizes[:-1])
            out = torch.cat([_run_chunk(model, x[i:i + n], chunk_seeds(gens), {})[0]
                             for i, n in zip(starts, sizes)])
        (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        assert not torch.equal(gens["dropout"].get_state(), generators()["dropout"].get_state())
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], rtol=0, atol=0, msg=name)
