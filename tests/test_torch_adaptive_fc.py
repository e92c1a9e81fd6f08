"""The port's adaptive loss weighting against irw_tpu's on ``RetrievalNet``
over vit_tiny, whose head the JAX rule finds through the ``fc`` fallback;
the checks and tolerances of ``test_torch_adaptive.py``.  And the adaptive
step's pullbacks through block remat and micro-batch checkpoints on the
kernel route, against the same model without remat."""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import pytest
import torch

from irw_tpu_torch.engine import build_train_step, init_train_state
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model
from irw_tpu_torch.transforms import DeviceTransform
from test_torch_adaptive import (
    BATCH, IMG, SWT, TINY, _batch, _configs, _loss_yaml, check_head, check_updates, check_weights,
)


def test_adaptive_weights_match_jax():
    check_weights("fc")


def test_adaptive_updates_match_jax():
    check_updates("fc")


def test_head_parameters_are_the_leaves_jax_selects():
    check_head("fc")


@pytest.mark.parametrize("sub_batch", [None, 4], ids=["whole", "chunks"])
def test_adaptive_pullbacks_through_checkpoints(sub_batch, monkeypatch):
    """Each pullback of the adaptive step recomputes the checkpointed blocks
    (and chunks) anew: with block remat on the kernel route the weights and
    gradients are those of the same model without remat, and the attention
    core runs (per chunk and block) its forward, a recompute for each of the
    two loss terms' pullbacks (the chunk's and the block's own with chunks,
    and the chunk's for ortho, which stops at the fusion head) and a
    backward a loss term."""
    from irw_tpu_torch.ops import attention

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = attention.attention_plain, attention.attention_plain_bwd
    monkeypatch.setattr(attention, "attention_plain", lambda *a, **k: (
        calls.__setitem__("fwd", calls["fwd"] + 1), fwd(*a, **k))[1])
    monkeypatch.setattr(attention, "attention_plain_bwd", lambda *a, **k: (
        calls.__setitem__("bwd", calls["bwd"] + 1), bwd(*a, **k))[1])
    batch = {k: v for k, v in _batch().items() if k != "index"}
    loss_cfg = [dict(_loss_yaml("hash_loss")[0], weight="adaptative"),
                dict(_loss_yaml("roadmap_adaptative")[0])]
    results = []
    for remat in (True, False):
        model = get_model("multidino_attention_hashing", device="cpu", **dict(
            TINY, vit_kwargs={"depth": 2, "img_size": IMG, "vmem_attn": True,
                              "remat_blocks": remat}))
        if remat:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(weights)
        opt_cfg, _ = _configs()
        state = init_train_state(model, build_losses(loss_cfg), opt_cfg, loss_cfg, seed=0)
        step = build_train_step(DeviceTransform(SWT, device="cpu"), adaptive_weights=True,
                                sub_batch=sub_batch)
        calls.update(fwd=0, bwd=0)
        metrics = step(state, batch, _build_hyper(state.optimizer_entries, 1, 0, 0, None))
        results.append(({k: float(v) for k, v in metrics.items()},
                         {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}, dict(calls)))
    (m_r, g_r, c_r), (m_p, g_p, _) = results
    for key in ("adaptive_weight_0", "adaptive_weight_1", "total_loss"):
        assert m_r[key] == pytest.approx(m_p[key], rel=1e-6), key
    for name, g in g_p.items():
        torch.testing.assert_close(g_r[name], g, rtol=1e-5, atol=1e-7, msg=name)
    chunks, depth = (1, 2) if sub_batch is None else (BATCH // sub_batch, 2)
    per_block = 1 + 2 * 2 + 1 if sub_batch else 1 + 2
    assert c_r == {"fwd": per_block * chunks * depth, "bwd": 2 * chunks * depth}
