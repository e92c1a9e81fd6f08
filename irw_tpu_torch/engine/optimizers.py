"""Config-driven optimizers and schedules (port of
``irw_tpu/engine/optimizers.py:42-156, 198-346`` and
``irw_tpu/getter.py:88-125``).

The config is a LIST of entries::

    - name: AdamW
      params: <top-level submodule name, or null for the whole model>
      kwargs: {lr, weight_decay, ...}
      bias_kwargs: {...}          # overrides for biases / 1-D params
      modules: [{name: conv1, kwargs: {lr: ...}}]   # per-module groups
      scheduler_on_epoch: {name: CosineAnnealingLR, kwargs: {...}}
      scheduler_on_step:  {name: warmcos, kwargs: {...}}
      scheduler_on_val:   {name: ReduceLROnPlateau, kwargs: {...}, key: map}

Each entry becomes one ``torch.optim`` optimizer whose param groups carry a
``label`` as the JAX package's ``_label_tree`` assigns it: ``frozen``
(left out of the optimizer: the reference's ``requires_grad=False``), a
configured module name, ``bias`` (1-D or bias leaves) or ``weight``.  Labels
match against the port's parameter names (``backbone.vit.blocks.0…``).  The
engine recomputes every group's learning rate on the host from the
torch-semantics schedule functions below and writes it into the group
before each step (``set_group_lrs``).  ``AdamW`` is torch's, whose
decoupled decay equals optax's ``adamw``; ``Adam`` and ``SGD`` couple the
decay into the gradient, as ``optax.add_decayed_weights`` before the update
does.  ``RMSprop``, ``Adagrad``, ``LARS`` and ``Lamb`` are the optax
transforms of those names (``optax.rmsprop``, ``adagrad``, ``lars``,
``lamb``, optax 0.2.6), not torch's optimizers: their defaults (RMSprop's
decay 0.9 with eps inside the square root, Adagrad's accumulator 0.1 and eps
1e-7, LARS's trust coefficient 1e-3 and momentum 0.9, Lamb's eps 1e-6) and
their arithmetic, one parameter at a time as ``optax.multi_transform``
applies them to a group's leaves.  A kwarg the optax transform does not take
raises ``TypeError``, as the JAX package's ``ctor(learning_rate, **kwargs)``
does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

from irw_tpu_torch.utils.freezing import frozen_names

# ---------------------------------------------------------------------------
# torch-semantics LR schedules: fn(counter) -> multiplicative factor
# ---------------------------------------------------------------------------


def _cosine(T_max, eta_min=0.0, base_lr=1.0, **_):
    def f(t):
        return (eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * min(t, T_max) / T_max)) / 2) / base_lr

    return f


def _multistep(milestones, gamma=0.1, **_):
    milestones = sorted(milestones)

    def f(t):
        return gamma ** sum(1 for m in milestones if t >= m)

    return f


def _step(step_size, gamma=0.1, **_):
    def f(t):
        return gamma ** (t // step_size)

    return f


def _exponential(gamma, **_):
    def f(t):
        return gamma**t

    return f


def _linear(start_factor=1.0 / 3, end_factor=1.0, total_iters=5, **_):
    def f(t):
        if t >= total_iters:
            return end_factor
        return start_factor + (end_factor - start_factor) * t / total_iters

    return f


def _warmcos(total_steps, warmup_steps=100, **_):
    """getter.py:129-141: min(linear warmup, cosine)."""

    def f(t):
        return min((t + 1) / warmup_steps, (1 + math.cos(math.pi * t / total_steps)) / 2)

    return f


def _constant(**_):
    return lambda t: 1.0


def _onecycle(max_lr, epochs=100, steps_per_epoch=100, pct_start=0.3,
              div_factor=25.0, final_div_factor=1e4, base_lr=1.0,
              total_steps=None, **_):
    """torch OneCycleLR (anneal_strategy='cos'): cosine ramp from
    max_lr/div_factor up to max_lr over pct_start of the run, then cosine
    anneal down to initial/final_div_factor.  Returned as a scale relative
    to the optimizer's base lr."""
    total = int(total_steps or (epochs * steps_per_epoch))
    initial = max_lr / div_factor
    minimum = initial / final_div_factor
    up = max(int(pct_start * total), 1)

    def interp(a, b, frac):
        return b + (a - b) * (1 + math.cos(math.pi * frac)) / 2

    def f(t):
        t = min(t, total)
        if t < up:
            lr = interp(initial, max_lr, t / up)
        else:
            lr = interp(max_lr, minimum, (t - up) / max(total - up, 1))
        return lr / base_lr

    return f


def make_schedule(config: dict, base_lr: float = 1.0) -> Callable[[int], float]:
    name = config["name"]
    kwargs = dict(config.get("kwargs") or {})
    if name == "CosineAnnealingLR":
        return _cosine(base_lr=base_lr, **kwargs)
    if name == "MultiStepLR":
        kwargs.pop("last_epoch", None)
        return _multistep(**kwargs)
    if name == "StepLR":
        return _step(**kwargs)
    if name == "ExponentialLR":
        return _exponential(**kwargs)
    if name == "LinearLR":
        return _linear(**kwargs)
    if name == "warmcos":
        return _warmcos(**kwargs)
    if name == "ConstantLR":
        return _constant()
    if name == "OneCycleLR":
        # steps_per_epoch may arrive as an unresolved/absent interpolation
        kwargs.setdefault("steps_per_epoch", 100)
        kwargs.pop("last_epoch", None)
        return _onecycle(base_lr=base_lr, **kwargs)
    if name == "SequentialLR":
        # getter.py:143-146: piecewise schedules switched at milestones
        subs = [make_schedule(s, base_lr) for s in kwargs["schedulers"]]
        milestones = list(kwargs["milestones"])

        def f(t):
            idx, offset = 0, 0
            for i, m in enumerate(milestones):
                if t >= m:
                    idx, offset = i + 1, m
            return subs[idx](t - offset)

        return f
    raise ValueError(f"unknown scheduler {name!r}")


class ReduceOnPlateau:
    """Host-side plateau scheduler for scheduler_on_val (keyed on an eval
    metric, train.py:168-180)."""

    def __init__(self, mode="max", factor=0.1, patience=10, key="map", **_):
        self.mode, self.factor, self.patience, self.key = mode, factor, patience, key
        self.best = None
        self.bad = 0
        self.scale = 1.0

    def update(self, value: float) -> float:
        better = self.best is None or (
            value > self.best if self.mode == "max" else value < self.best
        )
        if better:
            self.best, self.bad = value, 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale *= self.factor
                self.bad = 0
        return self.scale


# ---------------------------------------------------------------------------
# optimizer construction
# ---------------------------------------------------------------------------

def _bias_correction(decay: float, count: int, like: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay**count``, computed in float32 (with the double
    ``1 - 0.999`` Adam's second moment would be off by 1e-5)."""
    return 1 - torch.tensor(decay, dtype=torch.float32, device=like.device) ** count


def _rmsprop_update(p, g, state, h):
    """``optax.rmsprop``: ``scale_by_rms`` (or ``scale_by_stddev`` when
    centered), the learning rate, then ``trace`` with a momentum."""
    decay = h["decay"]
    if not state:
        state["nu"] = torch.full_like(p, h["initial_scale"])
        if h["centered"]:
            state["mu"] = torch.zeros_like(p)
        if h["momentum"] is not None:
            state["trace"] = torch.zeros_like(p)
        state["count"] = 0
    state["nu"] = (1 - decay) * (g * g) + decay * state["nu"]
    nu = state["nu"]
    if h["centered"]:
        state["mu"] = (1 - decay) * g + decay * state["mu"]
    mu = state.get("mu")
    if h["bias_correction"]:
        state["count"] += 1
        correction = _bias_correction(decay, state["count"], nu)
        nu = nu / correction
        mu = None if mu is None else mu / correction
    if mu is not None:
        nu = nu - mu * mu
    if h["eps_in_sqrt"]:
        u = torch.rsqrt(nu + h["eps"]) * g
    else:
        u = 1 / (torch.sqrt(nu) + h["eps"]) * g
    u = u * -h["lr"]
    if h["momentum"] is not None:
        state["trace"] = u + h["momentum"] * state["trace"]
        u = u + h["momentum"] * state["trace"] if h["nesterov"] else state["trace"]
    return u


def _adagrad_update(p, g, state, h):
    """``optax.adagrad``: ``scale_by_rss``, then the learning rate."""
    if not state:
        state["sum_of_squares"] = torch.full_like(p, h["initial_accumulator_value"])
    state["sum_of_squares"] = g * g + state["sum_of_squares"]
    t = state["sum_of_squares"]
    u = torch.where(t > 0, torch.rsqrt(t + h["eps"]), 0.0) * g
    return u * -h["lr"]


def _trust_ratio(u, p, coefficient: float, eps: float):
    """``scale_by_trust_ratio`` (min_norm 0): u · c‖p‖ / (‖u‖ + eps), or u
    where either norm is 0."""
    p_norm = torch.sqrt(torch.sum(p * p))
    u_norm = torch.sqrt(torch.sum(u * u))
    ratio = coefficient * p_norm / (u_norm + eps)
    return u * torch.where((p_norm == 0) | (u_norm == 0), 1.0, ratio)


def _lars_update(p, g, state, h):
    """``optax.lars``: decayed weights, the trust ratio (each under its
    mask), the learning rate, then ``trace``."""
    if not state:
        state["trace"] = torch.zeros_like(p)
    u = g + h["weight_decay"] * p if h["weight_decay_mask"] else g
    if h["trust_ratio_mask"]:
        u = _trust_ratio(u, p, h["trust_coefficient"], h["eps"])
    u = u * -h["lr"]
    state["trace"] = u + h["momentum"] * state["trace"]
    return u + h["momentum"] * state["trace"] if h["nesterov"] else state["trace"]


def _lamb_update(p, g, state, h):
    """``optax.lamb``: ``scale_by_adam``, decayed weights, the trust ratio
    (coefficient 1, eps 0), then the learning rate."""
    b1, b2 = h["b1"], h["b2"]
    if not state:
        state["mu"], state["nu"], state["count"] = torch.zeros_like(p), torch.zeros_like(p), 0
    state["mu"] = (1 - b1) * g + b1 * state["mu"]
    state["nu"] = (1 - b2) * (g * g) + b2 * state["nu"]
    state["count"] += 1
    mu_hat = state["mu"] / _bias_correction(b1, state["count"], p)
    nu_hat = state["nu"] / _bias_correction(b2, state["count"], p)
    u = mu_hat / (torch.sqrt(nu_hat + h["eps_root"]) + h["eps"])
    u = u + h["weight_decay"] * p
    return _trust_ratio(u, p, 1.0, 0.0) * -h["lr"]


class OptaxOptimizer(torch.optim.Optimizer):
    """One optax transform as a torch optimizer: each param group carries
    the transform's keyword arguments (its defaults filled in) and ``lr``,
    and ``step`` applies ``update(p, grad, state, group)`` to every
    parameter with a gradient, in float32 arithmetic as optax does."""

    def __init__(self, params, update):
        super().__init__(params, {})
        self.update = update

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(self.update(p, p.grad, self.state[p], group))


# name → (the optax transform's keyword arguments and defaults, its update)
_OPTAX = {
    "RMSprop": ({"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0, "eps_in_sqrt": True,
                 "centered": False, "momentum": None, "nesterov": False,
                 "bias_correction": False}, _rmsprop_update),
    "Adagrad": ({"initial_accumulator_value": 0.1, "eps": 1e-7}, _adagrad_update),
    "LARS": ({"weight_decay": 0.0, "weight_decay_mask": True, "trust_coefficient": 0.001,
              "eps": 0.0, "trust_ratio_mask": True, "momentum": 0.9, "nesterov": False},
             _lars_update),
    "Lamb": ({"b1": 0.9, "b2": 0.999, "eps": 1e-6, "eps_root": 0.0, "weight_decay": 0.0},
             _lamb_update),
}
_NAMES = sorted(["Adam", "AdamW", "SGD", *_OPTAX])


def _group_hyper(name: str, kwargs: dict) -> tuple[float, dict]:
    """(lr, the other hyperparameters of one param group) from a config's
    kwargs, with the JAX package's defaults (``_base_tx``)."""
    kwargs = dict(kwargs)
    lr = kwargs.pop("lr", kwargs.pop("learning_rate", 1e-3))
    if name in ("Adam", "AdamW"):
        return lr, {"weight_decay": kwargs.pop("weight_decay", 0.0 if name == "Adam" else 1e-2),
                    "betas": tuple(kwargs.pop("betas", (0.9, 0.999))),
                    "eps": kwargs.pop("eps", 1e-8)}
    if name == "SGD":
        momentum = kwargs.pop("momentum", 0.0) or 0.0
        return lr, {"momentum": momentum, "weight_decay": kwargs.pop("weight_decay", 0.0),
                    # optax drops nesterov without momentum; torch would refuse it
                    "nesterov": bool(kwargs.pop("nesterov", False)) and momentum > 0}
    if name in _OPTAX:
        defaults = _OPTAX[name][0]
        unknown = sorted(set(kwargs) - set(defaults))
        if unknown:
            raise TypeError(f"{name.lower()}() got an unexpected keyword argument "
                            f"{unknown[0]!r}")
        return lr, {**defaults, **kwargs}
    raise ValueError(f"unknown optimizer {name!r}; available: {_NAMES}")


_TORCH = {"Adam": torch.optim.Adam, "AdamW": torch.optim.AdamW, "SGD": torch.optim.SGD}


def _make_optimizer(name: str, groups: list) -> torch.optim.Optimizer:
    if name in _OPTAX:
        return OptaxOptimizer(groups, _OPTAX[name][1])
    return _TORCH[name](groups)


def _param_label(name: str, param: torch.Tensor, module_names, frozen: set) -> str:
    """``_label_tree``'s rule for one parameter (``frozen``: the names the
    freezing set selects)."""
    if name in frozen:
        return "frozen"
    for mod in module_names:
        if mod in name:
            return mod
    if param.dim() <= 1 or "bias" in name:
        return "bias"
    return "weight"


@dataclass
class OptimizerEntry:
    name: str  # config entry target key ('net' or a submodule name)
    optimizer: torch.optim.Optimizer
    target: str | None  # submodule (None = the whole model)
    group_base_lr: dict = field(default_factory=dict)  # label → base lr
    epoch_schedule: Callable | None = None
    step_schedule: Callable | None = None
    plateau: ReduceOnPlateau | None = None

    def group_lrs(self, epoch: int, step: int, val_scale: float = 1.0) -> dict:
        factor = 1.0
        if self.epoch_schedule is not None:
            # torch on_epoch semantics: scheduler.step() fires AFTER each
            # epoch, so epoch E trains at f(E-1) — epoch 1 at the base LR
            factor *= self.epoch_schedule(max(epoch - 1, 0))
        if self.step_schedule is not None:
            factor *= self.step_schedule(step)
        if self.plateau is not None:
            factor *= self.plateau.scale
        return {label: base * factor * val_scale for label, base in self.group_base_lr.items()}


def set_group_lrs(optimizer: torch.optim.Optimizer, lrs: dict) -> None:
    """Write per-label learning rates into the optimizer's param groups."""
    for group in optimizer.param_groups:
        if group["label"] in lrs:
            group["lr"] = float(lrs[group["label"]])


def build_optimizers(opt_config: list, model: torch.nn.Module,
                     frozen_collections=None) -> list[OptimizerEntry]:
    """One ``OptimizerEntry`` per config entry.  ``frozen_collections``
    (default: the model's ``frozen_param_collections``) is a freezing set
    (``utils.freezing``) whose parameters no optimizer holds."""
    if frozen_collections is None:
        frozen_collections = getattr(model, "frozen_param_collections", ())
    entries = []
    for cfg in opt_config:
        cfg = dict(cfg)
        name = cfg["name"]
        target = cfg.get("params")
        kwargs = dict(cfg.get("kwargs") or {})
        modules_cfg = list(cfg.get("modules") or [])
        module_names = [m["name"] for m in modules_cfg]

        group_kwargs = {"weight": kwargs, "bias": {**kwargs, **(cfg.get("bias_kwargs") or {})}}
        for mod in modules_cfg:
            group_kwargs[mod["name"]] = {**kwargs, **(mod.get("kwargs") or {})}
        members = {label: [] for label in group_kwargs}
        module = model if target is None else model.get_submodule(target)
        frozen = frozen_names(module, frozen_collections)
        for pname, param in module.named_parameters():
            label = _param_label(pname, param, module_names, frozen)
            if label != "frozen":
                members[label].append(param)

        groups, base_lrs = [], {}
        for label, kw in group_kwargs.items():
            lr, hyper = _group_hyper(name, kw)
            base_lrs[label] = lr
            if members[label]:
                groups.append({"params": members[label], "label": label, "lr": lr, **hyper})
        entry = OptimizerEntry(name=target or "net", optimizer=_make_optimizer(name, groups),
                               target=target, group_base_lr=base_lrs)
        lr_w = base_lrs["weight"]
        if cfg.get("scheduler_on_epoch"):
            entry.epoch_schedule = make_schedule(cfg["scheduler_on_epoch"], lr_w)
        if cfg.get("scheduler_on_step"):
            entry.step_schedule = make_schedule(cfg["scheduler_on_step"], lr_w)
        if cfg.get("scheduler_on_val"):
            sval = cfg["scheduler_on_val"]
            entry.plateau = ReduceOnPlateau(key=sval.get("key", "map"), **(sval.get("kwargs") or {}))
        entries.append(entry)
    return entries


def build_loss_optimizers(loss_config, losses) -> dict:
    """loss index → the optimizer of that loss's own parameters
    (``Getter.get_loss_optimizer``): each entry's ``kwargs.optimizer``
    config, AdamW(lr 1e-4, weight decay 1e-4) by default, ``Adam`` without
    decay, ``SGD`` with optional momentum.  Losses without parameters get
    none."""
    entries = list(loss_config or [])
    out = {}
    for idx, (loss, _) in enumerate(losses):
        params = list(loss.parameters())
        if not params:
            continue
        opt_cfg = ((entries[idx].get("kwargs") or {}).get("optimizer") if idx < len(entries)
                   else None) or {}
        kw = dict(opt_cfg.get("kwargs") or {})
        for k in ("lr", "weight_decay", "momentum"):  # arcface.yaml keys them at the top
            if k not in kw and opt_cfg.get(k) is not None:
                kw[k] = opt_cfg[k]
        lr = kw.pop("lr", 1e-4)
        wd = kw.pop("weight_decay", 1e-4)
        name = opt_cfg.get("name", "AdamW")
        if name == "Adam":
            opt = torch.optim.Adam(params, lr=lr)
        elif name == "SGD":
            opt = torch.optim.SGD(params, lr=lr, momentum=kw.get("momentum") or 0.0)
        else:
            opt = torch.optim.AdamW(params, lr=lr, weight_decay=wd)
        out[str(idx)] = opt
    return out
