"""The port's checkpoints (``irw_tpu_torch.engine.checkpoint``): what a save
holds and a restore puts back, bit for bit; the JAX package's layout under
``weights/`` (``rolling``, ``rolling.next`` promoted through
``rolling.old``, ``epoch_N``); the async save's barriers; a process that
dies with a save in flight; and the resume probe.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from irw_tpu_torch.engine import (XBM, build_train_step, finalize_checkpoints, init_train_state,
                                  load_checkpoint, maybe_resume, restore_train_state,
                                  save_checkpoint, wait_for_checkpoints)
from irw_tpu_torch.engine.checkpoint import train_state_payload
from irw_tpu_torch.engine.train import _build_hyper
from irw_tpu_torch.losses import build_losses
from irw_tpu_torch.models import get_model

REPO = Path(__file__).resolve().parents[1]
HASH_LOSS = [{"name": "HashLoss", "weight": 1.0,
              "kwargs": {"num_classes": 20, "embedding_size": 64,
                         "optimizer": {"name": "AdamW", "kwargs": {"lr": 1e-4}}}}]
OPTIMIZER = [{"name": "AdamW", "params": None, "kwargs": {"lr": 1e-3, "weight_decay": 5e-4}}]
TINY = {"backbone": "test_tiny", "frozen_backbone": False,
        "fusion_config": {"type": "cross_attention_advanced", "output_dim": 64, "num_heads": 2},
        "vit_kwargs": {"img_size": 16}}


def tiny_state(seed=0, memory=True):
    model = get_model("multidino_attention_hashing", device="cpu", seed=seed, **TINY)
    xbm = XBM(size=16, embedding_dim=64, label_shape=(20,)) if memory else None
    return init_train_state(model, build_losses(HASH_LOSS), OPTIMIZER, HASH_LOSS, seed=seed,
                            xbm=xbm)


def train_steps(state, n, seed=0):
    """``n`` train steps on random bands: moments, memory and generators move."""
    rng = np.random.RandomState(seed)
    step = build_train_step(xbm=state.xbm)
    for _ in range(n):
        labels = (rng.rand(4, 20) > 0.7).astype(np.float32)
        labels[:, 0] = 1.0
        batch = {"image": rng.rand(4, 4, 16, 16, 3).astype(np.float32), "label": labels,
                 "index": rng.choice(16, 4, replace=False)}
        step(state, batch, _build_hyper(state.optimizer_entries, 1, state.step, 0, None))
    return state


def same_payload(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_payload(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_payload(x, y) for x, y in zip(a, b))
    return a == b


def files(log_dir):
    return sorted(p.name for p in (log_dir / "weights").iterdir())


@pytest.fixture(scope="module")
def trained():
    state = train_steps(tiny_state(), 2)
    state.epoch, state.model_alpha = 3, 1.5
    return state


@pytest.mark.parametrize("async_save", [False, True])
def test_restore_is_bit_exact(trained, tmp_path, async_save):
    """Everything the state holds comes back into a freshly built state (other
    weights, loss parameters and generator seeds), bit for bit: the
    parameters, BatchNorm statistics, AdamW moments, loss parameters and
    optimizer, XBM buffers, generators, step, epoch and α."""
    saved = train_state_payload(trained)
    assert saved["optimizers"]["net"]["state"] and saved["loss_optimizers"]["0"]["state"]
    assert int(saved["xbm"]["valid"].sum()) > 0
    save_checkpoint(str(tmp_path), trained, {"a": [1, 2]}, epoch=3, score=0.5, best_score=0.6,
                    async_save=async_save)
    payload, meta = load_checkpoint(str(tmp_path))
    assert meta == {"config": {"a": [1, 2]}, "epoch": 3, "score": 0.5, "best_score": 0.6}
    fresh = tiny_state(seed=7)
    assert not same_payload(train_state_payload(fresh), saved)
    restore_train_state(fresh, payload)
    assert same_payload(train_state_payload(fresh), saved)
    assert (fresh.step, fresh.epoch, fresh.model_alpha) == (2, 3, 1.5)
    assert files(tmp_path) == ["rolling"]
    # the restored state trains on as the saved one does
    a, b = train_steps(trained_copy(saved), 1, seed=9), train_steps(fresh, 1, seed=9)
    assert same_payload(train_state_payload(a), train_state_payload(b))


def trained_copy(payload):
    state = tiny_state(seed=3)
    return restore_train_state(state, payload)


def test_async_saves_promote_through_rolling_next(trained, tmp_path):
    log_dir = str(tmp_path)
    save_checkpoint(log_dir, trained, {}, epoch=1, async_save=True)
    wait_for_checkpoints()
    assert files(tmp_path) == ["rolling.next"]  # promoted by the next save or load
    save_checkpoint(log_dir, trained, {}, epoch=2, async_save=True, save_model_every=2)
    wait_for_checkpoints()
    assert files(tmp_path) == ["epoch_2", "rolling", "rolling.next"]
    assert torch.load(tmp_path / "weights" / "rolling", weights_only=True)["meta"]["epoch"] == 1
    finalize_checkpoints(log_dir)
    assert files(tmp_path) == ["epoch_2", "rolling"]
    assert load_checkpoint(log_dir)[1]["epoch"] == 2
    epoch_2 = torch.load(tmp_path / "weights" / "epoch_2", weights_only=True)
    assert epoch_2["meta"]["epoch"] == 2 and same_payload(epoch_2["state"],
                                                          train_state_payload(trained))


def test_load_barriers_on_an_async_save_in_flight(trained, tmp_path):
    save_checkpoint(str(tmp_path), trained, {"e": 1}, epoch=1)
    save_checkpoint(str(tmp_path), trained, {"e": 2}, epoch=2, async_save=True)
    assert load_checkpoint(str(tmp_path))[1] == {"config": {"e": 2}, "epoch": 2, "score": None,
                                                 "best_score": None}
    assert files(tmp_path) == ["rolling"]


def test_sync_save_drops_a_stale_rolling_next_and_keeps_the_cadence(trained, tmp_path):
    save_checkpoint(str(tmp_path), trained, {}, epoch=1, async_save=True)
    wait_for_checkpoints()  # a crashed async run leaves rolling.next
    for epoch in (2, 3, 4):
        save_checkpoint(str(tmp_path), trained, {}, epoch=epoch, save_model_every=2)
    assert files(tmp_path) == ["epoch_2", "epoch_4", "rolling"]
    assert load_checkpoint(str(tmp_path))[1]["epoch"] == 4


def test_load_falls_back_to_rolling_old(trained, tmp_path):
    """A crash between the promotion's renames leaves only ``rolling.old``
    (and ``rolling.next`` is gone or not yet written)."""
    save_checkpoint(str(tmp_path), trained, {}, epoch=5)
    weights = tmp_path / "weights"
    os.rename(weights / "rolling", weights / "rolling.old")
    assert load_checkpoint(str(tmp_path))[1]["epoch"] == 5
    assert files(tmp_path) == ["rolling"]
    assert load_checkpoint(str(tmp_path / "nothing")) is None


@pytest.mark.parametrize("when", ["mid_write", "before_promotion"])
def test_async_checkpoint_crash_window(tmp_path, when):
    """The process dies with an async save in flight (or written but not yet
    promoted): the directory holds epoch 1 or epoch 2 whole, never a torn
    file (``tests/test_engine.py``'s crash-window test for the JAX
    package)."""
    script = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {str(REPO / "tests")!r})
        from test_torch_checkpoint import tiny_state, train_steps
        from irw_tpu_torch.engine import save_checkpoint, wait_for_checkpoints
        state = train_steps(tiny_state(), 1)
        save_checkpoint({str(tmp_path)!r}, state, {{"e": 1}}, epoch=1)
        save_checkpoint({str(tmp_path)!r}, state, {{"e": 2}}, epoch=2, async_save=True)
        if {when!r} == "before_promotion":
            wait_for_checkpoints()
        os._exit(1)  # no atexit, no wait for the writer: a crash
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    payload, meta = load_checkpoint(str(tmp_path))
    assert meta["epoch"] in (1, 2) and meta["config"] == {"e": meta["epoch"]}
    if when == "before_promotion":
        assert meta["epoch"] == 2
    assert all(torch.isfinite(v).all() for v in payload["model"].values()
               if v.is_floating_point())
    restore_train_state(tiny_state(seed=4), payload)


def test_maybe_resume_restores_or_rotates_stale_metrics(trained, tmp_path):
    (tmp_path / "metrics.jsonl").write_text('{"step": 1}\n')
    fresh = tiny_state(seed=2)
    assert maybe_resume(fresh, str(tmp_path)) is None
    assert not (tmp_path / "metrics.jsonl").exists()
    assert (tmp_path / "metrics.jsonl.stale").read_text() == '{"step": 1}\n'
    assert fresh.step == 0 and fresh.epoch == 0
    save_checkpoint(str(tmp_path), trained, {}, epoch=3)
    (tmp_path / "metrics.jsonl").write_text('{"step": 3}\n')
    assert maybe_resume(fresh, str(tmp_path))["epoch"] == 3
    assert (tmp_path / "metrics.jsonl").exists()  # a resumed run appends to its log
    assert same_payload(train_state_payload(fresh), train_state_payload(trained))


def test_restore_refuses_a_memory_mismatch(trained, tmp_path):
    save_checkpoint(str(tmp_path), trained, {}, epoch=1)
    payload, _ = load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="XBM"):
        restore_train_state(tiny_state(memory=False), payload)
