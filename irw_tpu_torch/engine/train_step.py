"""The optimization step (port of ``irw_tpu/engine/train_step.py:47-116,
209-495``).

One ``step(state, batch, hyper)`` call:

- the device transform (Haar SWT: kernel K1);
- the training-mode forward, dropout and band-drop masks from the state's
  generators (attention: kernels K2 forward, and K3 in the backward; with
  block remat each block's forward runs again in the backward, so K2 runs
  twice per block), with ``alpha=state.model_alpha`` for a model whose
  forward takes the continuation α (the hashing ResNets, :94-107);
- the weighted loss sum plus the fusion head's ortho term, scaled by the
  runtime ``hyper["ortho_scale"]``;
- one backward;
- the gradients of the freezing set dropped: ``frozen_collections``, by
  default the model's ``frozen_param_collections`` (a frozen tower that
  prompts or DSLN backpropagate through receives them; the JAX step zeroes
  those leaves, :417-426);
- the global gradient norm over the network's parameters and global-norm
  clipping, min(1, clip / (norm + 1e-6));
- per-entry optimizer steps at the host-computed group learning rates
  (``hyper["lrs"]``); an entry whose ``hyper["active"]`` flag is off (warm-up
  gating) does not step, so its moments stay untouched;
- the losses' own optimizer steps (the reference's ``crit.step()``) on the
  unclipped loss gradients, and the per-batch ``step_update`` schedules;
- the batch proxy mAP.

The losses take the model's output by their kind
(``irw_tpu/engine/train_step.py:238-268``): a BRANCHES loss the list of
branch outputs, a LOGITS loss the output (the last of a list), an
EMBEDDINGS loss the output (the first of a list), a SCORES loss the raw
``emb @ emb.T`` with the batch's label matrix.

With an XBM memory, every step inserts the detached embeddings (the first
output of a list), the labels and ``batch["index"]`` into
``state.xbm_state`` before the losses (:338-347).  With the memory on
(``xbm_active``) and a single output, each SCORES loss and each ref-aware
EMBEDDINGS loss (``accepts_refs``) also runs against the memory
(:269-304): invalid slots hold a zero embedding and the inert label (−1,
or a zero row), and SCORES losses see −1e9 at their scores.  That term,
``loss_<i>_memory_<Loss>``, is scaled by the loss's weight times
``xbm.weight``.  Other losses ignore the memory, and with none that reads
it the step warns once, as the JAX step does.

Micro-batching (``sub_batch`` below the batch, :118-193): the device
transform runs once on the whole batch, then the forward runs chunk by
chunk, each chunk under a non-reentrant ``torch.utils.checkpoint`` (its
activations are recomputed in the backward, as ``jax.checkpoint`` +
``lax.scan`` does).  A tail of one sample joins the last chunk; any other
tail is a smaller chunk of its own, run last.  Each chunk's dropout and
band-drop generators are seeded inside the checkpointed call, so the
recompute draws the same masks, from seeds the host derives from the
state's generators (``chunk_seeds``: no seed is read back from the card).
A BatchNorm normalises each chunk by that chunk's statistics, and its
running statistics take one update per chunk, in chunk order: the buffers
are read after the forward and written back after the backward, so the
recompute does not update them a second time.  The chunks' outputs are
concatenated in batch order; of their aux, a 0-dim value is averaged with
the chunk sizes as weights, a tensor with the chunk on its first axis is
concatenated, anything else is the last chunk's, and ``ortho_loss``
defaults to 0.

Adaptive loss weighting (``adaptive_weights``, :354-415): one forward,
then one pullback (``torch.autograd.grad``, the graph retained) per entry
of the loss vector: each term (a memory term with its XBM weight), then the
ortho term.  Each term but ortho is weighted by mean(head norms) / its head
norm, where a head norm is the norm of the term's gradient over the head
parameters; ortho keeps weight 1.  The head is what the JAX step selects
from flax parameter paths: those containing ``adaptive_head_key``, else the
first of ``HashHead``, ``hash_fc``, ``fc``, ``head``, ``projection`` that
some path contains, else every parameter; the port's parameters are named
by their flax paths through ``bridge.jax_param_paths``.  The parameter
and loss-parameter gradients are the weighted sums, ``total_loss`` is the
weighted vector's sum, and ``adaptive_weight_<i>`` carries the weights.

It returns the metrics as 0-dim tensors on the device, under the JAX step's
names (``total_loss``, ``grad_norm``, ``batch_map``, ``loss_<i>_<Loss>``,
``ortho_raw``, ``ortho_loss``).  A pipeline-parallel ``apply_fn`` (A13f),
and a step under a process group of more than one rank (A13b), raise
``NotImplementedError``.
"""

from __future__ import annotations

import inspect
import logging
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from irw_tpu_torch.bridge import jax_param_paths
from irw_tpu_torch.engine.optimizers import set_group_lrs
from irw_tpu_torch.losses.base import LossContext, LossKind
from irw_tpu_torch.parallel.mesh import refuse_group_training
from irw_tpu_torch.utils.freezing import frozen_names
from irw_tpu_torch.utils.label_matrix import create_label_matrix

LOGGER = logging.getLogger(__name__)


def batch_proxy_map(embeddings, labels, metric: str = "cosine"):
    """Training-time self-retrieval mAP over the batch (batch_map.py:9-36):
    rank the batch against itself (self dropped, ties in index order, as
    ``jnp.argsort``), exact AP."""
    if metric == "hamming":
        codes = torch.sign(embeddings)
        sims = codes @ codes.T
    else:
        e = embeddings / torch.clamp(torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True),
                                     min=1e-12)
        sims = e @ e.T
    b = sims.shape[0]
    eye = torch.eye(b, dtype=sims.dtype, device=sims.device)
    sims = sims - 1e9 * eye
    rel = create_label_matrix(labels, dtype=sims.dtype) * (1.0 - eye)
    order = torch.argsort(-sims, dim=1, stable=True)
    ranked_rel = torch.gather(rel, 1, order)
    ranks = torch.arange(1, b + 1, dtype=sims.dtype, device=sims.device)
    cum = torch.cumsum(ranked_rel, dim=1)
    ap = torch.sum((cum / ranks) * ranked_rel, dim=1) / torch.clamp(rel.sum(1), min=1.0)
    valid = rel.sum(1) > 0
    return torch.where(valid, ap, 0.0).sum() / torch.clamp(valid.sum(), min=1)


def _as_device(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def micro_batches(batch: int, sub_batch: int) -> list:
    """The chunk sizes of a batch of ``batch`` at ``sub_batch``: whole chunks,
    a tail of one sample merged into the last of them, any other tail a
    smaller chunk of its own (``_split_into_microbatches``)."""
    sb = min(int(sub_batch), batch)
    n_full, tail = divmod(batch, sb)
    n_scan = n_full - 1 if tail == 1 else n_full
    rest = batch - n_scan * sb
    return [sb] * n_scan + ([rest] if rest else [])


def _merge_aux(values: list, sizes: list) -> object:
    """One aux entry of every chunk → the batch's: a 0-dim value averaged
    with the chunk sizes as weights, a tensor with the chunk on its first
    axis concatenated, anything else the last chunk's."""
    first = values[0]
    if torch.is_tensor(first) and first.dim() == 0:
        return sum(v * n for v, n in zip(values, sizes)) / sum(sizes)
    if len(values) > 1 and torch.is_tensor(first) and first.shape[0] == sizes[0]:
        return torch.cat(values, dim=0)
    return values[-1]


def _run_chunk(model, x, seeds: dict, extra: dict):
    """A chunk's forward with generators seeded here, inside the checkpointed
    call, so the recompute redraws the forward's masks."""
    gens = {name: torch.Generator(device=x.device).manual_seed(seed)
            for name, seed in seeds.items()}
    out = model(x, gens, **extra)
    return out if isinstance(out, tuple) else (out, {})


def chunk_seeds(generators: dict) -> dict:
    """One seed per rng stream for a micro-batch, from each generator's state,
    which then advances.  A card generator keeps its state on the host and
    advances as it launches: no seed read back from the card, so no wait for
    it before every chunk."""
    seeds = {}
    for name, g in generators.items():
        words = np.frombuffer(g.get_state().numpy().tobytes(), np.uint32)
        seeds[name] = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 2)
        torch.empty(1, device=g.device).uniform_(generator=g)
    return seeds


def forward_microbatched(model, x, generators: dict, sub_batch: int, extra: dict):
    """(output, aux) of the training forward in chunks of ``sub_batch``, each
    under a non-reentrant checkpoint (``forward_microbatched``,
    ``irw_tpu/engine/train_step.py:118-193``), each chunk's rng streams
    seeded from ``generators`` (``chunk_seeds``)."""
    sizes = micro_batches(x.shape[0], sub_batch)
    outs, auxs, start = [], [], 0
    for n in sizes:
        out, aux = checkpoint(_run_chunk, model, x[start:start + n], chunk_seeds(generators),
                              extra, use_reentrant=False)
        outs.append(out)
        auxs.append(aux)
        start += n
    if isinstance(outs[0], (list, tuple)):
        output = type(outs[0])(torch.cat(parts, dim=0) for parts in zip(*outs))
        first = output[0]
    else:
        output = first = torch.cat(outs, dim=0)
    aux = {k: _merge_aux([a[k] for a in auxs], sizes) for k in auxs[-1]}
    aux.setdefault("ortho_loss", first.new_zeros((), dtype=torch.float32))
    return output, aux


HEAD_FALLBACKS = ("HashHead", "hash_fc", "fc", "head", "projection")


def head_parameter_names(model, key: str = "HashHead") -> list:
    """The parameters the JAX step's adaptive weighting takes as the head
    (``head_norm``, ``irw_tpu/engine/train_step.py:380-398``): those whose
    flax path contains ``key``, else the first of ``HEAD_FALLBACKS`` some
    path contains, else all of them."""
    paths = jax_param_paths(model)
    if not any(key in p for p in paths.values()):
        key = next((cand for cand in HEAD_FALLBACKS
                    if any(cand in p for p in paths.values())), "")
    return [name for name, p in paths.items() if key in p]


def adaptive_backward(vec: list, named: list, loss_params: list, head: set,
                      parts: dict) -> torch.Tensor:
    """The adaptive weighting's backward: one pullback per entry of ``vec``
    (the graph kept for the next), the weights from the terms' head norms
    (ortho last, at weight 1), each parameter's ``.grad`` the weighted sum of
    its gradients (None where no term reaches it).  Writes
    ``parts["adaptive_weight_<i>"]``; returns the weighted total."""
    names = [n for n, p in named if p.requires_grad]
    targets = [p for _, p in named if p.requires_grad]
    n_params = len(targets)
    targets += [p for p in loss_params if p.requires_grad]
    per_term = []
    for i, term in enumerate(vec):
        if term.requires_grad:
            per_term.append(torch.autograd.grad(term, targets, retain_graph=i < len(vec) - 1,
                                                allow_unused=True))
        else:  # a constant term (no ortho): zero gradients
            per_term.append((None,) * len(targets))
    zero = vec[0].new_zeros((), dtype=torch.float32)

    def head_norm(grads):
        squares = [torch.sum(g.float() ** 2) for name, g in zip(names, grads[:n_params])
                   if name in head and g is not None]
        return torch.sqrt(sum(squares, zero) + 1e-12)

    with torch.no_grad():
        norms = torch.stack([head_norm(grads) for grads in per_term[:-1]])
        weights = torch.cat([norms.mean() / (norms + 1e-12), norms.new_ones(1)])
        for j, p in enumerate(targets):
            terms = [w * grads[j] for w, grads in zip(weights, per_term) if grads[j] is not None]
            p.grad = sum(terms[1:], terms[0]) if terms else None
        for i in range(len(vec) - 1):
            parts[f"adaptive_weight_{i}"] = weights[i]
        return torch.sum(torch.stack([v.detach().float() for v in vec]) * weights)


def build_train_step(device_transform: Callable | None = None, clip_grad: float | None = None,
                     proxy_map_metric: str = "cosine", xbm=None, sub_batch: int | None = None,
                     adaptive_weights: bool = False, apply_fn: Callable | None = None,
                     xbm_active: bool = False, frozen_collections=None,
                     adaptive_head_key: str = "HashHead"):
    """Returns ``step(state, batch, hyper) -> metrics``.  ``batch``: ``image``
    (B, H, W, 3) uint8 or float, numpy or tensor, ``label`` and, with a
    unique ``xbm``, ``index``.  ``hyper``: ``lrs`` (entry name → label →
    lr), ``active`` (entry name → bool) and optionally ``ortho_scale`` —
    what ``engine.train._build_hyper`` makes.  ``xbm_active``: the memory
    term is on (the loop turns it on at ``xbm.activate_after``).
    ``frozen_collections``: the freezing set (``utils.freezing``), by
    default the model's ``frozen_param_collections``.  ``sub_batch``: the
    micro-batch size; ``adaptive_weights`` with ``adaptive_head_key``: the
    adaptive loss weighting (see the module's docstring)."""
    if apply_fn is not None:
        raise NotImplementedError("a pipeline-parallel apply_fn waits for ROADMAP A13f")
    refuse_group_training()

    use_xbm = xbm is not None and xbm_active
    warned = False
    # model → (the names its freezing set selects, whether forward takes alpha,
    # the head's parameter names for adaptive weighting)
    model_facts = {}

    def memory_refs(state):
        """The memory's (embeddings, labels, valid mask) as the losses read
        them: invalid slots zeroed, their labels inert."""
        mem_emb, mem_labels, valid = xbm.contents(state.xbm_state)
        ref_emb = mem_emb * valid[:, None]
        if mem_labels.dim() == 1:
            ref_labels = torch.where(valid, mem_labels, -1)
        else:
            ref_labels = mem_labels * valid[:, None]
        return ref_emb, ref_labels, valid

    def compute_losses(output, aux, labels, state, ortho_scale):
        is_branches = isinstance(output, (list, tuple))
        emb = None if is_branches else output
        refs = memory_refs(state) if use_xbm and emb is not None else None
        first = output[0] if is_branches else output
        total = first.new_zeros((), dtype=torch.float32)
        parts, new_states = {}, {}
        vec = []  # each term, a memory term with its XBM weight, then ortho
        for idx, (loss, weight) in enumerate(state.losses):
            key = str(idx)
            name = type(loss).__name__
            if loss.kind == LossKind.BRANCHES:
                ctx = LossContext(labels=labels, branches=list(output))
            elif loss.kind == LossKind.LOGITS:
                ctx = LossContext(labels=labels, embeddings=output[-1] if is_branches else output)
            elif loss.kind == LossKind.SCORES:
                # raw dot products: a model that L2-normalises its output gives cosines
                ctx = LossContext(labels=labels, embeddings=emb, scores=emb @ emb.T,
                                  label_matrix=create_label_matrix(labels))
            else:
                ctx = LossContext(labels=labels, embeddings=first)
            value, new_states[key] = loss(ctx, state.loss_states.get(key))
            if value.dim() > 0:
                value = value.mean()
            total = total + weight * value
            parts[f"loss_{idx}_{name}"] = value.detach()
            vec.append(value)

            reads_memory = loss.kind == LossKind.SCORES or (
                loss.kind == LossKind.EMBEDDINGS and getattr(loss, "accepts_refs", False))
            if refs is not None and reads_memory:
                ref_emb, ref_labels, valid = refs
                if loss.kind == LossKind.SCORES:
                    scores = torch.where(valid[None, :], emb @ ref_emb.T, -1e9)
                    mctx = LossContext(labels=labels, embeddings=emb, scores=scores,
                                       label_matrix=create_label_matrix(labels, ref_labels))
                else:
                    mctx = LossContext(labels=labels, embeddings=emb, ref_embeddings=ref_emb,
                                       ref_labels=ref_labels)
                mem_value, _ = loss(mctx, state.loss_states.get(key))
                if mem_value.dim() > 0:
                    mem_value = mem_value.mean()
                total = total + weight * xbm.weight * mem_value
                parts[f"loss_{idx}_memory_{name}"] = mem_value.detach()
                vec.append(xbm.weight * mem_value)
        ortho = aux.get("ortho_loss", total.new_zeros(()))
        # the constraint violation before ortho_weight and ortho_scale
        parts["ortho_raw"] = aux.get("ortho_raw", ortho).detach()
        if ortho_scale is not None:
            ortho = ortho * ortho_scale
        total = total + ortho
        parts["ortho_loss"] = ortho.detach()
        vec.append(ortho)
        return total, parts, new_states, vec

    def warn_if_inert(losses):
        """The JAX step's warning (train_step.py:195-207): a memory that no
        loss reads."""
        nonlocal warned
        if warned or any(loss.kind == LossKind.SCORES or getattr(loss, "accepts_refs", False)
                         for loss, _ in losses):
            return
        warned = True
        LOGGER.warning("XBM memory is configured but no loss consumes it "
                       f"({[type(loss).__name__ for loss, _ in losses]} are neither "
                       "score-based nor ref-aware) — the memory term is inert")

    def step(state, batch: dict, hyper: dict) -> dict:
        model = state.model
        device = next(model.parameters()).device
        if use_xbm:
            warn_if_inert(state.losses)
        images = batch["image"]
        if device_transform is not None:
            x = device_transform(images)
        else:
            x = _as_device(images, device)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
        labels = _as_device(batch["label"], device)
        # copied before the forward: a copy from pageable memory waits for the stream
        index = (_as_device(batch["index"], device)
                 if xbm is not None and batch.get("index") is not None else None)
        model.train()
        if id(model) not in model_facts:
            model_facts[id(model)] = (
                frozen_names(model, getattr(model, "frozen_param_collections", ())
                             if frozen_collections is None else frozen_collections),
                "alpha" in inspect.signature(model.forward).parameters,
                set(head_parameter_names(model, adaptive_head_key)) if adaptive_weights
                else None)
        frozen, takes_alpha, head = model_facts[id(model)]
        named = list(model.named_parameters())
        params = [p for _, p in named]
        loss_params = [p for loss, _ in state.losses for p in loss.parameters()]
        for p in params + loss_params:
            p.grad = None
        extra = {"alpha": state.model_alpha} if takes_alpha else {}
        chunked = sub_batch is not None and sub_batch < x.shape[0]
        if chunked:
            output, aux = forward_microbatched(model, x, state.generators, sub_batch, extra)
            # the running statistics after one update per chunk; the
            # backward's recompute would update them again
            buffers = [b.clone() for b in model.buffers()]
        else:
            out = model(x, state.generators, **extra)
            output, aux = out if isinstance(out, tuple) else (out, {})
        # the embeddings the memory takes and batch_map reads: a list's first output
        emb = (output[0] if isinstance(output, (list, tuple)) else output).detach()
        if xbm is not None:  # inserted before the losses read it (train_step.py:338-347)
            state.xbm_state = xbm.update(state.xbm_state, emb, labels, index)
        total, parts, new_loss_states, vec = compute_losses(output, aux, labels, state,
                                                            hyper.get("ortho_scale"))
        if adaptive_weights:
            total = adaptive_backward(vec, named, loss_params, head, parts)
        elif total.requires_grad:
            total.backward()
        else:  # no term reaches a parameter (a MultiLoss with no branch loss): zero gradients
            for p in params:
                if p.requires_grad:
                    p.grad = torch.zeros_like(p)
        if chunked:
            with torch.no_grad():
                for b, saved in zip(model.buffers(), buffers):
                    b.copy_(saved)

        # frozen parameters train in no optimizer and count in no norm: the
        # JAX step's zeroed frozen leaves add nothing to its norm either
        for name, p in named:
            if name in frozen:
                p.grad = None
        grads = [p.grad for p in params if p.grad is not None]
        # optax.global_norm: sqrt of the summed squares (torch.sum's cascade
        # sum: vector_norm accumulates less exactly on the CPU)
        grad_norm = torch.sqrt(torch.stack([torch.sum(g.float() ** 2) for g in grads]).sum())
        if clip_grad:
            scale = torch.clamp(clip_grad / (grad_norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        for entry in state.optimizer_entries:
            if not hyper["active"][entry.name]:
                continue  # warm-up gating: no update, moments untouched
            set_group_lrs(entry.optimizer, hyper["lrs"][entry.name])
            entry.optimizer.step()
        for opt in state.loss_optimizers.values():
            opt.step()
        state.loss_states = {str(idx): loss.step_update(new_loss_states.get(str(idx)) or {})
                             for idx, (loss, _) in enumerate(state.losses)}
        state.step += 1

        return {
            "total_loss": total.detach(),
            "grad_norm": grad_norm.detach(),
            "batch_map": batch_proxy_map(emb, labels, proxy_map_metric) if emb.dim() == 2
            else emb.new_zeros(()),
            **parts,
        }

    return step
