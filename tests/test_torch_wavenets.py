"""The port's in-model-DWT wavelet CNNs and the cross-band gates against
irw_tpu's, same weights.

- ``decompose_to_bands`` (haar and cdf97 at levels 1 and 2, and a size that
  does not divide, which takes the plain lifting) against JAX's, 1e-6 of
  max(1, max|ref|) for haar and, as ``tests/test_torch_lifting.py`` holds
  the same lifting, 1e-5 for cdf97 (XLA contracts its four lifting steps
  into other multiply-adds: about 5 f32 ulps of the input's scale);
- ``ChannelGate1D`` and ``CrossBandAttention`` (``no_spatial`` True and
  False) on a (2, 4, 5, 5, 8) stack, 1e-5;
- ``WaveResNet`` with no gate, each gate (``eca``, ``cbam``, ``channel``)
  and ``ll_only``, and ``WaveResNetCE``: the eval outputs, the training
  outputs (the CE logits) and the updated running statistics, and
  ``frozen_bn`` (statistics untouched, the gradient still reaching the
  BatchNorms' scale and bias).  The JAX classes hard-code ResNet-50 at width
  64; the reference's trunk class is replaced inside the test by a subclass
  of the same name (so flax still names it ``BandedResNet_0``) at width 8
  and one bottleneck a stage (each JAX compile of the four-band trunk is
  what the file's time goes to; the full-depth ResNet-50 branches are held
  in ``tests/test_torch_wcnn.py``), and the port's likewise.  32² images,
  so the 1×1-stem branches run on 16² bands and reach 2² at stage 4;
  batch 3;
- ``wresnet_ce`` in bfloat16 builds with its branches' ``frozen_bn`` and
  every conv and BatchNorm in that dtype (its numerics are
  ``tests/test_torch_trunks_half.py``'s).

Weights: numpy draws in the shapes of the JAX init (``numpy_init``: the
classifiers drawn, not zero), one trunk shared by every variant, carried by
``bridge.load_jax_variables``; the JAX variants are applied inside one jit
each for eval and training, so XLA compiles their shared trunk once.
Tolerances: 1e-4 on L2-normalised embeddings and gates; on unnormalised
features and logits 1e-4 · max(1, max|out|), and 1e-3 · max(1, max|out|)
in training, where BatchNorm normalises stage 4's 2² maps over 3 samples
(``tests/test_torch_wcnn.py`` explains why).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.models import attention_blocks as jax_blocks
from irw_tpu.models import wresnet as jax_wresnet
from irw_tpu_torch.bridge import from_jax_variables, load_jax_variables
from irw_tpu_torch.models import MODEL_REGISTRY, attention_blocks, wresnet
from irw_tpu_torch.models.resnet import BatchNorm, Conv2d
from test_torch_fusion_heads import numpy_init

TOL = 1e-4
TRAIN_TOL = 1e-3
NARROW = 8
SHALLOW = (1, 1, 1, 1)   # one bottleneck a stage: the full ResNet-50 is tests/test_torch_wcnn.py's
IMG, BATCH = 32, 3

_CACHE = {}


class BandedResNet(jax_wresnet.BandedResNet):
    """The JAX trunk at width 8 and one block a stage, under the class name
    flax auto-names (``WaveResNet`` passes ResNet-50's stage sizes)."""

    width: int = NARROW

    def __post_init__(self):
        object.__setattr__(self, "stage_sizes", SHALLOW)
        super().__post_init__()


class NarrowBandedResNet(wresnet.BandedResNet):
    def __init__(self, num_bands=4, stage_sizes=None, block="bottleneck", **kw):
        super().__init__(num_bands, SHALLOW, block, **dict(kw, width=NARROW))


def _close(ours, ref, tol):
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


# --- decompose_to_bands ----------------------------------------------------------------


@pytest.mark.parametrize("basis,levels,size", [("haar", 1, (16, 24)), ("haar", 2, (16, 24)),
                                               ("cdf97", 1, (16, 24)), ("cdf97", 2, (16, 24)),
                                               ("haar", 2, (18, 20))])
def test_decompose_to_bands_matches_jax(basis, levels, size, monkeypatch):
    """The coarsest level's [LL, LH, HL, HH] as (B, 4, h, w, C); a size that
    divides by 2ˡ makes one ``lifting_multi_level`` call over the B·C
    planes (kernel K4 on the card), another the plain lifting."""
    x = np.random.RandomState(levels).randn(2, *size, 3).astype(np.float32)
    ref = np.asarray(jax_wresnet.decompose_to_bands(jnp.asarray(x), levels, basis))
    calls = []
    kernel = wresnet.lifting_multi_level
    monkeypatch.setattr(wresnet, "lifting_multi_level",
                        lambda planes, *a: calls.append(planes.shape) or kernel(planes, *a))
    out = wresnet.decompose_to_bands(torch.from_numpy(x), levels, basis)
    _close(out, ref, 1e-6 if basis == "haar" else 1e-5)
    divides = size[0] % 2 ** levels == 0 and size[1] % 2 ** levels == 0
    assert calls == ([(6, *size)] if divides else [])


@pytest.mark.cuda
def test_decompose_to_bands_launches_k4_once_on_the_card():
    """On the card: one K4 launch a call, equal to the plain version; an
    input that requires grad raises (K4 has no backward)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from irw_tpu_torch.ops.wavelets import lifting_multi_level, lifting_multi_level_plain

    x = torch.randn(4, 224, 224, 3, device="cuda")
    before = lifting_multi_level.launches
    out = wresnet.decompose_to_bands(x, 1, "haar")
    assert lifting_multi_level.launches == before + 1
    planes = x.permute(0, 3, 1, 2).reshape(12, 224, 224)
    ref = lifting_multi_level_plain(planes, 1, "haar").reshape(4, 3, 4, 112, 112)
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 4, 1), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="no backward"):
        wresnet.decompose_to_bands(x.requires_grad_(), 1, "haar")


# --- ChannelGate1D and CrossBandAttention ------------------------------------------------


def test_channel_gate_1d_sums_the_gated_bands_as_jax():
    x = np.random.RandomState(0).randn(6, 4, 24).astype(np.float32)
    jgate = jax_blocks.ChannelGate1D(num_subbands=4)
    variables = numpy_init(jgate, jnp.asarray(x), seed=1)
    fused_ref, scale_ref = jgate.apply(variables, jnp.asarray(x))
    gate = attention_blocks.ChannelGate1D(4)
    load_jax_variables(gate, variables)
    fused, scale = gate(torch.from_numpy(x))
    np.testing.assert_allclose(fused.detach().numpy(), np.asarray(fused_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(scale.detach().numpy(), np.asarray(scale_ref), rtol=0, atol=1e-5)
    # the weighted SUM: no / S, where the subband gate takes the mean
    np.testing.assert_allclose(fused.detach().numpy(),
                               np.einsum("bsd,bs->bd", x, scale.detach().numpy()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("no_spatial", [True, False])
def test_cross_band_attention_matches_jax(no_spatial):
    """Band-major channels (s·C + c): the gate of channel c of band s is
    ``scale[:, s·C + c]``; the spatial branch's BatchNorm reads its running
    statistics (redrawn here) in both modes."""
    x = np.random.RandomState(2).randn(2, 4, 5, 5, 8).astype(np.float32)
    jatt = jax_blocks.CrossBandAttention(no_spatial=no_spatial)
    variables = numpy_init(jatt, jnp.asarray(x), seed=3)
    out_ref, scale_ref = jatt.apply(variables, jnp.asarray(x))
    att = attention_blocks.CrossBandAttention(4 * 8, no_spatial=no_spatial)
    load_jax_variables(att, variables)
    for mode in (False, True):
        att.train(mode)
        bands = [torch.from_numpy(x[:, s]).permute(0, 3, 1, 2) for s in range(4)]
        out, scale = att(bands)
        out = torch.stack([y.permute(0, 2, 3, 1) for y in out], dim=1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), rtol=0, atol=1e-5)
        np.testing.assert_allclose(scale.detach().numpy(), np.asarray(scale_ref), rtol=0,
                                   atol=1e-5)
    if no_spatial:  # band-major: band 1's channel 3 is scaled by gate 8 + 3
        np.testing.assert_allclose(out[:, 1, ..., 3].detach().numpy(),
                                   x[:, 1, ..., 3] * scale[:, 11, None, None].detach().numpy(),
                                   rtol=1e-6, atol=1e-6)


# --- WaveResNet and WaveResNetCE at width 8 ---------------------------------------------

GATES = {"eca": jax_blocks.SubbandEca, "cbam": jax_blocks.SubbandCBAM,
         "channel": jax_blocks.SubbandChannelGate}
EVAL_CASES = ("none", "eca", "cbam", "channel", "ce", "ll_only")
TRAIN_CASES = ("none", "eca", "ce", "ce_frozen")


def _jax_module(case):
    if case == "ll_only":
        return jax_wresnet.WaveResNet(ll_only=True, attention="eca")
    if case.startswith("ce"):
        return jax_wresnet.WaveResNetCE(num_classes=5, frozen_bn=case == "ce_frozen")
    return jax_wresnet.WaveResNet(attention=None if case == "none" else case)


def _variables(case, trunk, gates):
    """One case's flax variables: the shared trunk (its first band alone for
    ``ll_only``), the case's gate or classifiers."""
    params = {"BandedResNet_0": trunk["params"]["BandedResNet_0"]}
    stats = {"BandedResNet_0": trunk["batch_stats"]["BandedResNet_0"]}
    if case == "ll_only":
        params, stats = jax.tree_util.tree_map(lambda a: a[:1], (params, stats))
    elif case.startswith("ce"):
        params["branch_classifiers"] = trunk["params"]["branch_classifiers"]
    elif case != "none":
        params[f"{GATES[case].__name__}_0"] = gates[case]["params"]
    return {"params": params, "batch_stats": stats}


def wave_results():
    """(images, variables per case, JAX eval outputs, JAX training outputs
    with updated statistics), computed once under the narrow trunk.

    The whole JAX model runs for ``WaveResNet`` without a gate (eval and
    training) and ``WaveResNetCE`` (eval).  The other cases share that
    trunk, so their JAX outputs are the JAX heads applied to its features
    as the JAX modules apply them: the gate module on the (B, S, D)
    features (wresnet.py:108-111), ``branch_classifiers``' kernel and bias
    on them (:135-141), the eval features for ``frozen_bn``, whose
    statistics flax leaves as they were, and band 0's features for
    ``ll_only`` (its one branch holds band 0's parameters, :101-104).  Each
    full model is one XLA compile, which is what this file's time goes to."""
    if "wave" in _CACHE:
        return _CACHE["wave"]
    x = np.random.RandomState(0).randn(BATCH, IMG, IMG, 3).astype(np.float32)
    xj = jnp.asarray(x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wresnet, "BandedResNet", BandedResNet)
        trunk = numpy_init(_jax_module("ce"), xj, train=True, seed=0)
        feats = jnp.zeros((BATCH, 4, 32 * NARROW))
        gates = {k: numpy_init(cls(num_subbands=4), feats, seed=i + 1)
                 for i, (k, cls) in enumerate(GATES.items())}
        variables = {c: _variables(c, trunk, gates) for c in (*EVAL_CASES, "ce_frozen")}
        evals = jax.jit(lambda v, x: {c: _jax_module(c).apply(v[c], x, train=False)
                                      for c in ("none", "ce")})(variables, xj)
        (out, aux), updated = jax.jit(lambda v, x: _jax_module("none").apply(
            v, x, train=True, mutable=["batch_stats"]))(variables["none"], xj)
    feats_eval = evals["none"][0].reshape(BATCH, 4, -1)
    feats_train = out.reshape(BATCH, 4, -1)
    evals["ll_only"] = (feats_eval[:, 0], aux)   # band 0's branch alone, no gate
    for case, cls in GATES.items():
        fused, alphas = cls(num_subbands=4).apply(gates[case], feats_eval)
        evals[case] = (fused, dict(aux, gate=alphas))
    head = trunk["params"]["branch_classifiers"]

    def logits(f):
        y = np.asarray(f) @ head["kernel"] + head["bias"]
        return [y[:, i] for i in range(4)]

    fused, alphas = GATES["eca"](num_subbands=4).apply(gates["eca"], feats_train)
    trains = {"none": ((out, aux), updated), "eca": ((fused, dict(aux, gate=alphas)), updated),
              "ce": ((logits(feats_train), aux), updated),
              "ce_frozen": ((logits(feats_eval), aux),
                            {"batch_stats": variables["ce_frozen"]["batch_stats"]})}
    _CACHE["wave"] = (x, variables, evals, trains)
    return _CACHE["wave"]


def _port_model(case, variables):
    kind = {"ll_only": ("wresnet", {"ll_only": True, "attention": "eca"}),
            "none": ("wresnet", {}), "ce": ("wresnet_ce", {"num_classes": 5}),
            "ce_frozen": ("wresnet_ce", {"num_classes": 5, "frozen_bn": True})}
    name, kw = kind.get(case, ("wresnet", {"attention": case}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wresnet, "BandedResNet", NarrowBandedResNet)
        model = MODEL_REGISTRY[name](torch.device("cpu"), **kw)
    return load_jax_variables(model, variables).eval()


@pytest.mark.parametrize("case", EVAL_CASES)
def test_wave_resnet_eval_matches_jax(case):
    """Eval: ``WaveResNet``'s unnormalised output (the gate's fused (B, D),
    or the flat (B, S·D)) and gate; ``WaveResNetCE``'s unit embedding."""
    x, variables, evals, _ = wave_results()
    model = _port_model(case, variables[case])
    with torch.no_grad():
        out, aux = model(torch.from_numpy(x))
    ref, aux_ref = evals[case]
    bands = 1 if case == "ll_only" else 4
    assert out.shape == (BATCH, (32 * NARROW) * (1 if case in GATES else bands))
    assert set(aux) == set(aux_ref) and float(aux["ortho_loss"]) == 0.0
    if case == "ce":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)
        np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0, atol=1e-6)
    else:
        _close(out, ref, TOL)
        assert float(np.abs(np.linalg.norm(np.asarray(ref), axis=-1) - 1.0).max()) > 1e-2
    if "gate" in aux:
        np.testing.assert_allclose(aux["gate"].numpy(), np.asarray(aux_ref["gate"]), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_wave_resnet_training_matches_jax(case):
    """Training: the outputs (the CE model's per-band logits) and every
    running statistic as flax leaves them: moved by the batch, or with
    ``frozen_bn`` untouched; then the gradient of the logits reaches every
    BatchNorm's scale and bias all the same."""
    x, variables, _, trains = wave_results()
    model = _port_model(case, variables[case]).train()
    before = copy.deepcopy(model.state_dict())
    (ref, _), updated = trains[case]
    out, aux = model(torch.from_numpy(x))
    outs, refs = (out, ref) if case.startswith("ce") else ([out], [ref])
    assert len(outs) == len(refs) == (4 if case.startswith("ce") else 1)
    for ours, r in zip(outs, refs):
        _close(ours, r, TRAIN_TOL)
    moved = {"params": variables[case]["params"], **updated}
    stats = {k: v for k, v in from_jax_variables(moved).items()
             if k.endswith(("running_mean", "running_var"))}
    sd = model.state_dict()
    for key, value in stats.items():
        np.testing.assert_allclose(sd[key].numpy(), value, rtol=0, atol=1e-5, err_msg=key)
    untouched = [k for k in stats if torch.equal(sd[k], before[k])]
    assert len(untouched) == (len(stats) if case == "ce_frozen" else 0)
    if case.startswith("ce"):
        sum(o.square().sum() for o in out).backward()
        norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
        assert all(m.weight.grad is not None and m.weight.grad.abs().sum() > 0
                   and m.bias.grad.abs().sum() > 0 for m in norms)
        assert all(not m.training for m in norms) == (case == "ce_frozen")


def test_dtype_other_than_float32_names_a10e():
    """A bf16 ``wresnet_ce`` builds, its branches keep ``frozen_bn`` (pinned
    in training) and compute in bf16 while the parameters stay float32."""
    with torch.device("meta"):
        model = MODEL_REGISTRY["wresnet_ce"](torch.device("cpu"), dtype="bfloat16",
                                             frozen_bn=True)
        f32 = MODEL_REGISTRY["wresnet"](torch.device("cpu"), dtype="float32", frozen_bn=True)
    assert f32.backbone.branches[0].frozen_bn
    assert all(b.frozen_bn for b in model.backbone.branches)
    assert {m.dtype for m in model.modules() if isinstance(m, (BatchNorm, Conv2d))} \
        == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    model.train()
    assert not any(m.training for m in model.modules() if isinstance(m, BatchNorm))
