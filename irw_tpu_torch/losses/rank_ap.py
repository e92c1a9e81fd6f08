"""Differentiable ranking-AP losses (port of ``irw_tpu/losses/rank_ap.py``).

The square path builds the (B, B, B) score-difference tensor of a batch at
once.  The general path, (B, M) scores against the XBM memory, builds an
(M, M) difference tensor per query: at the CUB memory's M = 5824 that is
136 MB per query in float32, and reverse mode keeps several per query.  So
it runs over chunks of queries, each under ``torch.utils.checkpoint``: the
backward recomputes a chunk's forward instead of keeping it.  The arithmetic
per query is the JAX ``lax.scan`` body's.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from irw_tpu_torch.losses.base import (LossBase, LossContext, LossKind, absolute, clip, l2n,
                                       maximum)
from irw_tpu_torch.utils.label_matrix import create_label_matrix

# elements of one chunk's (queries, M, M) difference tensor in the general path
GENERAL_CHUNK_ELEMENTS = 1 << 27


def heaviside(x):
    """The step, 1 at 0, with no gradient."""
    return (x >= 0).to(x.dtype)


def tau_sigmoid(x, tau):
    """Temperature sigmoid with the exponent clamped to [−50, 50]."""
    exponent = clip(-x / tau, -50.0, 50.0)
    return 1.0 / (1.0 + torch.exp(exponent))


def _parse_tau(tau):
    if isinstance(tau, str):
        tau_n, tau_p = tau.split("_")
        return float(tau_n), float(tau_p)
    return float(tau), float(tau)


def step_rank(diff, pos3, tau, rho, offset, delta, start):
    """ROADMAP's piecewise rank surrogate: a sigmoid below 0; above it a
    sigmoid up to ``delta`` and a slope-``rho`` line past it; the step where
    ``pos3`` (a positive compared with a positive)."""
    tau_n, tau_p = _parse_tau(tau)
    neg_branch = tau_sigmoid(diff, tau_n)
    if delta is None:
        pos_side = rho * diff + offset
    else:
        if offset is None:
            offset_v = tau_sigmoid(torch.tensor(delta, dtype=diff.dtype, device=diff.device),
                                   tau_p) + start
        else:
            offset_v = offset
        pos_side = torch.where(diff > delta, rho * (diff - delta) + offset_v,
                               start + tau_sigmoid(diff, tau_p))
    out = torch.where(diff > 0, pos_side, neg_branch)
    return torch.where(pos3, heaviside(diff), out)


def _general_pos3(diff, target):
    """The general path's positive-positive mask: column j is a positive of
    the query, broadcast over the rows i."""
    return (target[..., None, :] > 0).expand(diff.shape)


def _square_pos3(target):
    """The square path's mask: T3[q, i, j] = rel(i, j) & target[q, j], where
    rel is the label matrix of the label matrix (it differs from the label
    matrix itself for multi-label batches)."""
    rel_ij = create_label_matrix(target) > 0
    return rel_ij[None, :, :] & (target[:, None, :] > 0)


def _return(ap, return_type: str):
    if return_type == "AP":
        return ap
    if return_type == "mAP":
        return ap.mean()
    if return_type == "1-AP":
        return 1.0 - ap
    return 1.0 - ap.mean()


class SmoothRankAP(LossBase):
    """Differentiable AP through a rank approximation ``rank_approx``."""

    kind = LossKind.SCORES

    def __init__(self, return_type: str = "1-mAP"):
        super().__init__()
        assert return_type in ("1-mAP", "1-AP", "AP", "mAP")
        self.return_type = return_type

    def rank_approx(self, diff, target, general: bool = False):
        raise NotImplementedError

    def ap_per_query(self, scores, target):
        b = scores.shape[0]
        eye = torch.eye(b, dtype=scores.dtype, device=scores.device)
        mask = 1.0 - eye
        # diff[q, i, j] = s[q, j] − s[q, i]
        diff = scores[:, None, :] - scores[:, :, None]
        approx = self.rank_approx(diff, target)
        rk = 1.0 + torch.sum(approx * mask[None, :, :], dim=-1)
        pos_mask = target - eye
        pos_rk = (torch.sum(approx * pos_mask[None, :, :], dim=-1) + target) * target
        return torch.sum(pos_rk / rk, dim=1) / torch.clamp(target.sum(dim=1), min=1.0)

    def _ap_general_chunk(self, scores, target):
        """AP of each query of a (c, M) chunk against the memory."""
        m = scores.shape[1]
        mask = 1.0 - torch.eye(m, dtype=scores.dtype, device=scores.device)
        diff = scores[:, None, :] - scores[:, :, None]  # diff[q, i, j] = s[q, j] − s[q, i]
        approx = self.rank_approx(diff, target, general=True) * mask
        rk = 1.0 + torch.sum(approx, dim=-1)
        pos_rk = 1.0 + torch.sum(approx * target[:, None, :], dim=-1)
        return torch.sum(target * pos_rk / rk, dim=-1) / torch.clamp(target.sum(dim=-1), min=1.0)

    def ap_per_query_general(self, scores, target):
        """Non-square (B, M) scores, the memory path: chunks of queries, each
        recomputed in the backward."""
        m = scores.shape[1]
        chunk = max(1, GENERAL_CHUNK_ELEMENTS // (m * m))
        recompute = torch.is_grad_enabled() and scores.requires_grad
        aps = []
        for q in range(0, scores.shape[0], chunk):
            s, t = scores[q:q + chunk], target[q:q + chunk]
            aps.append(checkpoint(self._ap_general_chunk, s, t, use_reentrant=False)
                       if recompute else self._ap_general_chunk(s, t))
        return torch.cat(aps)

    def forward(self, ctx: LossContext, state=None):
        scores = ctx.scores
        target = ctx.label_matrix.to(scores.dtype)
        if scores.shape[0] == scores.shape[1]:
            ap = self.ap_per_query(scores, target)
        else:
            ap = self.ap_per_query_general(scores, target)
        return _return(ap, self.return_type), state


class HeavisideAP(SmoothRankAP):
    """Exact AP, with no gradient."""

    def rank_approx(self, diff, target, general: bool = False):
        return heaviside(diff)


class SmoothAP(SmoothRankAP):
    def __init__(self, tau: float = 0.01, **kw):
        super().__init__(**kw)
        self.tau = tau

    def rank_approx(self, diff, target, general: bool = False):
        return tau_sigmoid(diff, self.tau)


class SupAP(SmoothRankAP):
    """ROADMAP's SupAP: ``step_rank`` with the step on positive-positive
    comparisons."""

    def __init__(self, tau=0.01, rho=100.0, offset=None, delta=0.05, start=0.5, **kw):
        super().__init__(**kw)
        self.tau, self.rho, self.offset, self.delta, self.start = tau, rho, offset, delta, start

    def rank_approx(self, diff, target, general: bool = False):
        pos3 = _general_pos3(diff, target) if general else _square_pos3(target)
        return step_rank(diff, pos3, self.tau, self.rho, self.offset, self.delta, self.start)


class AffineAP(SmoothRankAP):
    """A clipped affine ramp clip(theta + x / (2·mu), 0, 1) (mu_n below 0,
    mu_p above), with SupAP's step on positive-positive comparisons."""

    def __init__(self, theta=0.5, mu_n=0.025, mu_p=0.025, **kw):
        super().__init__(**kw)
        self.theta, self.mu_n, self.mu_p = theta, mu_n, mu_p

    def rank_approx(self, diff, target, general: bool = False):
        pos3 = _general_pos3(diff, target) if general else _square_pos3(target)
        ramp = clip(self.theta + diff / torch.where(diff > 0, 2.0 * self.mu_p, 2.0 * self.mu_n),
                    0.0, 1.0)
        return torch.where(pos3, heaviside(diff), ramp)


def _linspace(start: float, stop: float, num: int, like) -> torch.Tensor:
    """``jnp.linspace``'s arithmetic in ``like``'s dtype: start·(1 − t) +
    stop·t at t = i / (num − 1), then the stop itself."""
    if num == 1:
        return torch.full((1,), start, dtype=like.dtype, device=like.device)
    div = torch.tensor(num - 1, dtype=like.dtype, device=like.device)
    t = torch.arange(num - 1, dtype=like.dtype, device=like.device) / div
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=like.dtype, device=like.device)])


class SoftBinAP(LossBase):
    """Quantized-histogram AP: similarities soft-assigned to ``nq``
    triangular bins, AP from the cumulative histogram precision.  The
    ``min`` / ``max`` keys of ``configs/loss/softbinap.yaml`` alias
    ``min_sim`` / ``max_sim``; any other key raises."""

    kind = LossKind.SCORES

    def __init__(self, nq: int = 25, min_sim: float = -1.0, max_sim: float = 1.0,
                 return_type: str = "1-mAP", **aliases):
        super().__init__()
        self.nq = nq
        self.min_sim = aliases.pop("min", min_sim)
        self.max_sim = aliases.pop("max", max_sim)
        assert not aliases, f"unknown SoftBinAP kwargs {sorted(aliases)}"
        self.return_type = return_type

    def forward(self, ctx: LossContext, state=None):
        scores = ctx.scores
        target = ctx.label_matrix.to(scores.dtype)
        centers = _linspace(self.max_sim, self.min_sim, self.nq, scores)
        width = (self.max_sim - self.min_sim) / (self.nq - 1)
        # triangular soft assignment, (Q, nq, G)
        w = maximum(1.0 - absolute(scores[:, None, :] - centers[None, :, None]) / width, 0.0)
        nbs = w.sum(dim=-1)
        rec = (w * target[:, None, :]).sum(dim=-1)
        prec = torch.cumsum(rec, dim=-1) / torch.clamp(torch.cumsum(nbs, dim=-1), min=1e-16)
        ap = torch.sum(prec * rec, dim=-1) / torch.clamp(target.sum(dim=-1), min=1e-16)
        return _return(ap, self.return_type), state


def _rank_of(scores):
    """1-based rank of each element under a descending sort, ties in index
    order (``jnp.argsort`` is stable)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (torch.argsort(order, dim=-1, stable=True) + 1).to(scores.dtype)


class TrueRanker(torch.autograd.Function):
    """Ranks, differentiated as a black box: the backward re-ranks the
    scores perturbed by λ · grad and returns the finite difference."""

    @staticmethod
    def forward(ctx, scores, lambda_val):
        ranks = _rank_of(scores)
        ctx.save_for_backward(scores, ranks)
        ctx.lambda_val = lambda_val
        return ranks

    @staticmethod
    def backward(ctx, grad_output):
        scores, ranks = ctx.saved_tensors
        ranks_new = _rank_of(scores + ctx.lambda_val * grad_output)
        return -(ranks - ranks_new) / (ctx.lambda_val + 1e-8), None


def true_ranker(scores, lambda_val):
    return TrueRanker.apply(scores, lambda_val)


class BlackBoxAP(LossBase):
    """AP from black-box-differentiated ranks of the scores, positives
    lifted by ``margin`` first."""

    kind = LossKind.SCORES

    def __init__(self, lambda_val: float = 4.0, margin: float = 0.02,
                 return_type: str = "1-mAP"):
        super().__init__()
        self.lambda_val = lambda_val
        self.margin = margin
        self.return_type = return_type

    def forward(self, ctx: LossContext, state=None):
        scores = ctx.scores
        pos = ctx.label_matrix.to(scores.dtype)
        ranks = true_ranker(scores - self.margin * pos, self.lambda_val)
        # positives ranked at or above each element: the (Q, G, G) comparison
        # one chunk of queries at a time (it carries no gradient)
        g = scores.shape[1]
        chunk = max(1, GENERAL_CHUNK_ELEMENTS // (g * g))
        with torch.no_grad():
            pos_above = torch.cat([
                torch.sum((r[:, None, :] <= r[:, :, None]).to(scores.dtype) * p[:, None, :],
                          dim=-1)
                for r, p in zip(ranks.split(chunk), pos.split(chunk))])
        ap = (torch.sum(torch.where(pos > 0, pos_above / ranks, 0.0), dim=-1)
              / torch.clamp(pos.sum(-1), min=1.0))
        return _return(ap, self.return_type), state


class FastAP(LossBase):
    """Histogram-binned AP on the squared L2 distances of the normalised
    embeddings, over ``num_bins`` triangular bins of [0, 4]."""

    kind = LossKind.EMBEDDINGS

    def __init__(self, num_bins: int = 10):
        super().__init__()
        self.num_bins = num_bins

    def forward(self, ctx: LossContext, state=None):
        emb = l2n(ctx.embeddings)
        b = emb.shape[0]
        eye = torch.eye(b, dtype=emb.dtype, device=emb.device)
        target = create_label_matrix(ctx.labels, dtype=emb.dtype) * (1.0 - eye)
        d = maximum(2.0 - 2.0 * emb @ emb.T, 0.0)
        delta = 4.0 / self.num_bins
        centers = torch.arange(self.num_bins + 1, dtype=emb.dtype, device=emb.device) * delta
        w = maximum(1.0 - absolute(d[:, None, :] - centers[None, :, None]) / delta, 0.0)
        w = w * (1.0 - eye)[:, None, :]
        h_pos = (w * target[:, None, :]).sum(-1)
        h_all = w.sum(-1)
        cum_pos = torch.cumsum(h_pos, dim=-1)
        cum_all = torch.cumsum(h_all, dim=-1)
        n_pos = target.sum(-1)
        ap = (torch.sum(h_pos * cum_pos / torch.clamp(cum_all, min=1e-16), dim=-1)
              / torch.clamp(n_pos, min=1e-16))
        valid = n_pos > 0
        loss = 1.0 - (torch.sum(torch.where(valid, ap, 0.0))
                      / torch.clamp(valid.sum(), min=1).to(emb.dtype))
        return loss, state
