"""The port's RMSprop, Adagrad, LARS and Lamb against optax's, through both
packages' ``build_optimizers``.

Five steps on the same parameters and gradients: a two-layer stack (two
weights, two biases, the first bias at zero so that LARS's and Lamb's trust
ratio meets a zero norm), each step at a new host learning rate written by
``set_group_lrs``.  The JAX side labels the same flat names as the port
(``bias`` for 1-D leaves, a configured module's name before that).
Tolerance: the parameters' moves within 1e-6 relative to the leaf's largest
move, plus one unit in the last place of the parameter itself (f32 on both
sides, optax's ``rsqrt`` against torch's; a move read back from a parameter
near 1 carries that parameter's rounding).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irw_tpu.engine import optimizers as jax_optimizers
from irw_tpu_torch.engine import optimizers

SHAPES = {"0.weight": (5, 3), "0.bias": (5,), "1.weight": (2, 5), "1.bias": (2,)}
STEPS = 5
TOL = 1e-6

CASES = {
    "RMSprop": {"kwargs": {"lr": 1e-2}},
    "RMSprop-centered-momentum": {
        "name": "RMSprop", "kwargs": {"lr": 1e-2, "momentum": 0.9, "centered": True},
        "bias_kwargs": {"lr": 2e-2, "decay": 0.8}},
    "RMSprop-eps-outside-nesterov": {
        "name": "RMSprop", "kwargs": {"lr": 1e-2, "eps_in_sqrt": False, "bias_correction": True,
                                      "momentum": 0.5, "nesterov": True, "initial_scale": 0.1}},
    "Adagrad": {"kwargs": {"lr": 1e-2}},
    "Adagrad-config": {"name": "Adagrad",
                       "kwargs": {"lr": 5e-2, "initial_accumulator_value": 0.5, "eps": 1e-6},
                       "modules": [{"name": "1.", "kwargs": {"lr": 1e-2}}]},
    "LARS": {"kwargs": {"lr": 1e-1}},
    "LARS-config": {"name": "LARS",
                    "kwargs": {"lr": 1e-1, "weight_decay": 1e-2, "momentum": 0.8,
                               "nesterov": True},
                    "bias_kwargs": {"weight_decay": 0.0, "trust_ratio_mask": False}},
    "Lamb": {"kwargs": {"lr": 1e-2}},
    "Lamb-config": {"name": "Lamb", "kwargs": {"lr": 1e-2, "weight_decay": 1e-2, "b1": 0.8},
                    "bias_kwargs": {"weight_decay": 0.0, "eps": 1e-5}},
}


def _config(case):
    cfg = dict(CASES[case])
    cfg.setdefault("name", case)
    cfg["params"] = None
    return cfg


def _draws(seed):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params["0.bias"][:] = 0.0
    grads = [{k: rng.randn(*s).astype(np.float32) * (0.1 + i) for k, s in SHAPES.items()}
             for i in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    cfg = _config(case)
    params, grads = _draws(len(case))
    module = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.Linear(5, 2))
    module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    (entry,) = optimizers.build_optimizers([cfg], module)
    (jentry,) = jax_optimizers.build_optimizers([cfg], {k: jnp.asarray(v)
                                                         for k, v in params.items()})
    assert isinstance(entry.optimizer, optimizers.OptaxOptimizer)
    assert entry.group_base_lr == jentry.group_base_lr
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = jentry.tx.init(jparams)
    named = dict(module.named_parameters())
    for i, g in enumerate(grads):
        scale = 1.0 - 0.15 * i  # a host-side schedule
        lrs = {label: base * scale for label, base in entry.group_base_lr.items()}
        opt_state = jax_optimizers.set_group_lrs(
            opt_state, {k: jnp.float32(v) for k, v in lrs.items()})
        updates, opt_state = jentry.tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                              opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in named.items():
            p.grad = torch.from_numpy(g[name].copy())
        optimizers.set_group_lrs(entry.optimizer, lrs)
        entry.optimizer.step()
        for name, p in named.items():
            ref = np.asarray(jparams[name])
            move = ref - params[name]
            assert np.abs(move).max() > 0, (case, i, name)
            bound = TOL * np.abs(move).max() + np.spacing(np.abs(ref))
            err = np.abs(p.detach().numpy() - ref)
            assert np.all(err <= bound), (case, i, name, float((err - bound).max()))


@pytest.mark.parametrize("name,kwarg", [("RMSprop", "alpha"), ("Adagrad", "lr_decay"),
                                        ("LARS", "dampening"), ("Lamb", "betas")])
def test_torch_only_kwarg_raises_type_error_as_jax(name, kwarg):
    cfg = {"name": name, "params": None, "kwargs": {"lr": 1e-3, kwarg: 0.5}}
    params = {"w": jnp.zeros((2, 2))}
    with pytest.raises(TypeError, match=kwarg):
        jax_optimizers.build_optimizers([cfg], params)[0].tx.init(params)
    with pytest.raises(TypeError, match=kwarg):
        optimizers.build_optimizers([cfg], torch.nn.Linear(2, 2))


def test_unknown_optimizer_lists_all_seven():
    with pytest.raises(ValueError) as ours:
        optimizers.build_optimizers([{"name": "Adamax", "kwargs": {}}], torch.nn.Linear(2, 2))
    with pytest.raises(ValueError) as ref:
        jax_optimizers.build_optimizers([{"name": "Adamax", "kwargs": {}}],
                                        {"w": jnp.zeros((2, 2))})
    assert str(ours.value) == str(ref.value)
    for name in ("Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "LARS", "Lamb"):
        assert repr(name) in str(ours.value)


def test_optax_state_survives_a_checkpoint_round_trip():
    """An optax optimizer's moments and step count come back from its
    ``state_dict``, and the next step is the same as without the round trip."""
    params, grads = _draws(3)
    steps = []
    for reload in (False, True):
        module = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.Linear(5, 2))
        module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
        (entry,) = optimizers.build_optimizers([_config("Lamb-config")], module)
        for i, g in enumerate(grads):
            if reload and i == 2:
                saved = entry.optimizer.state_dict()
                (entry,) = optimizers.build_optimizers([_config("Lamb-config")], module)
                entry.optimizer.load_state_dict(saved)
            for name, p in module.named_parameters():
                p.grad = torch.from_numpy(g[name].copy())
            entry.optimizer.step()
        steps.append([p.detach().clone() for p in module.parameters()])
    for a, b in zip(*steps):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
