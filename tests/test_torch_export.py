"""The exported eval forward (``irw_tpu_torch.tools.export_serving``)
against the eager port and ``tools/export_serving.py``, and the kernels'
``torch.library`` custom ops (``irw_tpu_torch.ops.library``).

The run is ``test_torch_run_tools``'s: the port's run of the flagship
study's job at test width (4 bands of a 64-wide, 2-block ``test_tiny`` ViT
on 16², f32) with ``vmem_attn`` on, as the card sets it for an unfrozen
tower (K2's op in the program), its weights carried into the JAX model
(without ``vmem_attn``, whose Pallas kernel does not run here) through the
bridge's inverse.  Each artifact is
saved, loaded in this process (``torch.export.load``) and held bit for bit
to the eager forward of the same model, and its codes to the JAX
``export_model``'s on the same weights (the codes of both within 1e-5,
which for ±1 codes is equality).
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irw_tpu.getter import Getter as JaxGetter
from irw_tpu_torch import run as port_run
from irw_tpu_torch.config import compose
from irw_tpu_torch.ops import attention, flash_attention
from irw_tpu_torch.ops.library import OPS
from irw_tpu_torch.ops.wavelets import lifting_dwt, swt
from irw_tpu_torch.run_dir import load_run
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.tools import export_serving as port_export
from test_torch_run_tools import jax_variables, job_overrides
from test_torch_runner import _job
from tools import export_serving as jax_export

SHAPE = (4, 16, 16, 3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's run dir of the cut job, and its model rebuilt."""
    root = tmp_path_factory.mktemp("export")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        port_run.run(compose(CONFIG_DIR, "default", job_overrides(root) + [
            "+model.kwargs.vit_kwargs.vmem_attn=true"]), device="cpu")
    run_dir = str(root / _job()[0])
    return run_dir, load_run(run_dir, device="cpu")


def _bands(seed, batch):
    return np.random.RandomState(seed).rand(batch, *SHAPE).astype(np.float32)


def _jax_codes(config, variables, x, **kw):
    """``tools/export_serving.export_model`` of the run's JAX model on the
    same weights, called on ``x``."""
    model_cfg = dict(config.model)
    kwargs = dict(model_cfg["kwargs"])
    vit_kwargs = {k: v for k, v in (kwargs.get("vit_kwargs") or {}).items() if k != "vmem_attn"}
    kwargs["vit_kwargs"] = dict(vit_kwargs, **({"quant_int8": True}
                                               if kw.get("compress_int8") else {}))
    model_cfg["kwargs"] = kwargs
    model = JaxGetter().get_model(model_cfg)
    tree = jax.tree_util.tree_map(jnp.asarray, variables)
    exported = jax_export.export_model(model, tree, kw.pop("input_shape", SHAPE),
                                       platforms=("cpu",), **kw)
    args = (x,) if kw.get("bake_weights", True) else (tree, x)
    return np.asarray(exported.call(*args))


def test_exported_program_is_the_eager_forward_at_any_batch(run, tmp_path):
    """Baked, symbolic batch: saved, loaded and called at batches 3 and 5,
    bit for bit the eager forward, K2's op inside; the codes as JAX's."""
    run_dir, rebuilt = run
    path = tmp_path / "m.pt2"
    exported = port_export.export_model(rebuilt.model, None, SHAPE, out_path=str(path))
    ops = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    assert "irw_tpu_torch.attention_fwd.default" in ops
    serve = torch.export.load(str(path)).module()
    for seed, batch in ((0, 3), (1, 5)):
        x = torch.from_numpy(_bands(seed, batch))
        with torch.no_grad():
            out, eager = serve(x), rebuilt.model(x)[0]
        assert out.shape == (batch, 64) and torch.equal(out, eager)
    ref = _jax_codes(rebuilt.config, jax_variables(rebuilt.model), _bands(1, 5))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_exported_program_without_weights_takes_the_state(run, tmp_path):
    """``--no-bake-weights``: ``serve(state, bands)``, the artifact a few
    hundred bytes a tensor lighter than the baked one; the same codes."""
    run_dir, rebuilt = run
    port_export.main(["--run", run_dir, "--out", str(tmp_path / "nb.pt2"), "--no-bake-weights",
                      "--height", "16", "--width", "16", "--device", "cpu"])
    port_export.main(["--run", run_dir, "--out", str(tmp_path / "b.pt2"), "--height", "16",
                      "--width", "16", "--device", "cpu"])
    weights = sum(t.numel() * t.element_size() for t in rebuilt.model.state_dict().values())
    baked, light = ((tmp_path / f).stat().st_size for f in ("b.pt2", "nb.pt2"))
    assert baked - light >= weights
    serve = torch.export.load(str(tmp_path / "nb.pt2")).module()
    x = _bands(2, 4)
    with torch.no_grad():
        out = serve(dict(rebuilt.model.state_dict()), torch.from_numpy(x))
        assert torch.equal(out, rebuilt.model(torch.from_numpy(x))[0])
    ref = _jax_codes(rebuilt.config, jax_variables(rebuilt.model), x, bake_weights=False)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_int8_artifact_bakes_int8_weights(run, tmp_path):
    """``--quant int8``: the quant-path weights stored as int8 buffers and
    f32 scales, dequantized in the program; its codes those of the
    ``quant_int8`` model on the float weights (the reconstruction within
    1 ulp of them) and of the JAX int8 artifact."""
    run_dir, _ = run
    path = tmp_path / "q.pt2"
    port_export.main(["--run", run_dir, "--out", str(path), "--quant", "int8", "--height", "16",
                      "--width", "16", "--device", "cpu"])
    program = torch.export.load(str(path))
    int8 = [k for k, v in program.state_dict.items() if v.dtype == torch.int8]
    assert len(int8) == 2 * 6   # 2 blocks × q, k, v, out, fc1, fc2 (each with its band axis)
    quant = load_run(run_dir, device="cpu", quant="int8")
    assert type(quant.model.backbone.vit.blocks[0].attn).__name__ == "QuantMHA"
    x = _bands(3, 4)
    with torch.no_grad():
        out = program.module()(torch.from_numpy(x))
        assert torch.equal(out, quant.model(torch.from_numpy(x))[0])
    ref = _jax_codes(quant.config, jax_variables(quant.model), x, compress_int8=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_artifact_with_the_transform_takes_uint8(run, tmp_path):
    """``--with-transform``: the run's eval device stage (the SWT, K1's
    op) folded in, raw (B, 16, 16, 3) uint8 at a fixed serve batch."""
    run_dir, rebuilt = run
    path = tmp_path / "t.pt2"
    port_export.main(["--run", run_dir, "--out", str(path), "--with-transform",
                      "--serve-batch", "6", "--height", "16", "--width", "16",
                      "--device", "cpu"])
    program = torch.export.load(str(path))
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"irw_tpu_torch.haar_swt2.default", "irw_tpu_torch.attention_fwd.default"} <= ops
    images = np.random.RandomState(4).randint(0, 256, (6, 16, 16, 3)).astype(np.uint8)
    with torch.no_grad():
        out = program.module()(torch.from_numpy(images))
        eager = rebuilt.model(rebuilt.device_test(images))[0]
    assert torch.equal(out, eager)
    ref = _jax_codes(rebuilt.config, jax_variables(rebuilt.model), images,
                     input_shape=(16, 16, 3), device_transform=_jax_transform(rebuilt.config),
                     symbolic_batch=6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def _jax_transform(config):
    _, (_, device_test) = JaxGetter().get_transform(config.get("transform", {}))
    return device_test


def test_with_transform_needs_a_run(tmp_path):
    with pytest.raises(SystemExit, match="needs --run"):
        port_export.main(["--out", str(tmp_path / "x.pt2"), "--with-transform",
                          "--device", "cpu"])


def _opcheck_cases():
    gen = torch.Generator().manual_seed(0)
    q, k, v = torch.randn(3, 2, 9, 2, 32, generator=gen).unbind(0)
    fused = torch.randn(2, 9, 3, 2, 32, generator=gen).unbind(2)   # strided views
    planes = torch.randn(3, 8, 16, generator=gen)
    return {
        "haar_swt2": [(planes,), (planes.to(torch.bfloat16),)],
        "lifting_multi_level": [(planes, 1, "haar"), (planes, 2, "cdf97")],
        "attention_fwd": [(q, k, v, 0.3, False), (q, k, v, 0.3, True), (*fused, 0.2, False),
                          (q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
                           0.3, True)],
        "flash_attention_fwd": [(q, k, v, False), (*fused, True)],
    }


PLAIN = {"haar_swt2": lambda x: swt.haar_swt2_plain(x),
         "lifting_multi_level": lambda x, lv, b: lifting_dwt.lifting_multi_level_plain(x, lv, b),
         "attention_fwd": lambda q, k, v, s, st: attention.attention_plain(q, k, v, s,
                                                                           with_stats=st),
         "flash_attention_fwd": lambda q, k, v, r: flash_attention.flash_attention_plain(
             q, k, v, save_residuals=r)}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_custom_op_cpu_implementation_is_the_plain_version(name):
    """``torch.library.opcheck`` (schema, fake shapes against the CPU
    implementation, the dispatch tests) on each op, and its CPU result the
    plain version's bit for bit."""
    op = OPS[name]["op"]
    for args in _opcheck_cases()[name]:
        torch.library.opcheck(op, args)
        out, plain = op(*args), PLAIN[name](*args)
        if name == "flash_attention_fwd" and args[-1]:
            plain = (plain[0], torch.stack(plain[1:]))
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        plain if isinstance(plain, tuple) else (plain,)):
            assert torch.equal(a, b) and a.is_contiguous()
