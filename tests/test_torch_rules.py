"""Rules of the port: it imports no JAX, its entry points run on the card
unless told otherwise, its wrappers never hide a missing kernel (on the CPU
each runs its plain version and counts no launch, on a device that is
neither CPU nor CUDA it raises), and what is not ported names its ROADMAP
item."""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import irw_tpu_torch
from irw_tpu_torch.data import SyntheticVOCDataset
from irw_tpu_torch.engine import compute_embeddings, evaluate
from irw_tpu_torch.engine.landmark import landmark_evaluation
from irw_tpu_torch.models import get_model
from irw_tpu_torch.models.vit import make_vit
from irw_tpu_torch.ops.attention import (
    attention_plain,
    attention_plain_bwd,
    fused_attention,
    fused_attention_bwd,
)
from irw_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_plain,
    flash_attention_plain_bwd,
)
from irw_tpu_torch.ops.qkv_attention import fused_qkv_attention, qkv_attention_plain
from irw_tpu_torch.ops.wavelets import (
    haar_swt2,
    haar_swt2_plain,
    lifting_multi_level,
    lifting_multi_level_plain,
)
from irw_tpu_torch.transforms import DeviceTransform

REPO = Path(__file__).resolve().parents[1]
TINY = {"backbone": "test_tiny", "fusion_config": {"type": "cross_attention_advanced",
                                                    "output_dim": 64, "num_heads": 2},
        "vit_kwargs": {"img_size": 16}}
GND = [{"easy": [0], "hard": [], "junk": []}, {"easy": [1], "hard": [], "junk": []}]
# configs/model/wcnn_attention_ce.yaml's dialect on resnet18 branches
WCNN_KW = {"backbone_name": "wcnn_attention_ce", "attention": True, "attention_type": "cbam",
           "num_classes": 4, "with_autocast": True, "backbone": "resnet18"}


def test_port_and_chip_smoke_import_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(irw_tpu_torch.__path__,
                                                           "irw_tpu_torch."))
    assert "irw_tpu_torch.ops.attention" in modules and "irw_tpu_torch.bridge" in modules
    assert {"irw_tpu_torch.engine.train_step", "irw_tpu_torch.engine.optimizers",
            "irw_tpu_torch.losses.hashing"} <= set(modules)
    assert {"irw_tpu_torch.ops.wavelets.lifting", "irw_tpu_torch.ops.wavelets.lifting_families",
            "irw_tpu_torch.ops.wavelets.lifting_dwt", "irw_tpu_torch.models.resnet",
            "irw_tpu_torch.models.attention_blocks", "irw_tpu_torch.models.wresnet",
            "irw_tpu_torch.models.mtwavenet", "irw_tpu_torch.ops.flash_attention"} <= set(modules)
    assert {"irw_tpu_torch.ops.qkv_attention", "irw_tpu_torch.ops.fused_ln",
            "irw_tpu_torch.utils.flops", "irw_tpu_torch.benchmarks",
            "irw_tpu_torch.benchmarks.vmem_qkv_micro", "irw_tpu_torch.benchmarks.vmem_attn_micro",
            "irw_tpu_torch.benchmarks.infer_vmem_ab"} <= set(modules)
    assert {"irw_tpu_torch.samplers", "irw_tpu_torch.samplers.samplers",
            "irw_tpu_torch.data.loader", "irw_tpu_torch.engine.train",
            "irw_tpu_torch.engine.checkpoint", "irw_tpu_torch.engine.xbm",
            "irw_tpu_torch.utils.meters"} <= set(modules)
    assert {"irw_tpu_torch.config", "irw_tpu_torch.config.yaml_lite",
            "irw_tpu_torch.config.compose", "irw_tpu_torch.transforms.host",
            "irw_tpu_torch.data.registry", "irw_tpu_torch.getter", "irw_tpu_torch.run",
            "irw_tpu_torch.single_experiment_runner", "irw_tpu_torch.studies",
            "irw_tpu_torch.studies.run_plan"} <= set(modules)
    assert {"irw_tpu_torch.native", "irw_tpu_torch.native.build", "irw_tpu_torch.data.base",
            "irw_tpu_torch.data.cifar", "irw_tpu_torch.data.datasets_image",
            "irw_tpu_torch.data.datasets_multilabel"} <= set(modules)
    assert {"irw_tpu_torch.data.landmarks", "irw_tpu_torch.engine.landmark",
            "irw_tpu_torch.benchmarks.landmark_bench"} <= set(modules)
    assert {"irw_tpu_torch.models.siglip", "irw_tpu_torch.models.hf_towers",
            "irw_tpu_torch.models.hf_wrapper"} <= set(modules)
    assert set(RUN_TOOLS) <= set(modules)
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r} + ['irw_tpu_torch', 'chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'irw_tpu', 'yaml', 'PIL',\n"
        "                                    'transformers'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# the packages no module of the port (nor chip_smoke.py) may import: the
# reference and its stack, and what the card's machine does not have
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sklearn", "irw_tpu")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        (REPO / "irw_tpu_torch").rglob("*.py")) + ["chip_smoke.py"])
def test_module_imports_nothing_forbidden(path):
    """No import statement of the module names a forbidden package, at any
    depth (a function-level import included)."""
    import ast

    tree = ast.parse((REPO / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))


def test_engine_extras_import_without_the_reference_stack():
    """The engine extras' modules load with no forbidden package in
    ``sys.modules`` afterwards (scikit-learn's folds are the port's own)."""
    modules = ["irw_tpu_torch.engine.splits", "irw_tpu_torch.engine.dsch",
               "irw_tpu_torch.engine.batch_map", "irw_tpu_torch.hooks",
               "irw_tpu_torch.hooks.instrumentation", "irw_tpu_torch.engine.optimizers",
               "irw_tpu_torch.engine.train_step", "irw_tpu_torch.run"]
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# the tools that read a run and the serving extras (ROADMAP A15b, A14)
RUN_TOOLS = ("irw_tpu_torch.evaluate", "irw_tpu_torch.attention", "irw_tpu_torch.alpha_weights",
             "irw_tpu_torch.plot_exemples", "irw_tpu_torch.run_dir", "irw_tpu_torch.tools",
             "irw_tpu_torch.tools.convert_torch_weights", "irw_tpu_torch.tools.export_serving",
             "irw_tpu_torch.utils.pretrained", "irw_tpu_torch.ops.quant",
             "irw_tpu_torch.ops.library")


@pytest.mark.parametrize("module", RUN_TOOLS)
def test_run_tools_import_no_reference_nor_pillow(module):
    """The run tools and the serving extras name no JAX, flax, irw_tpu,
    Pillow or transformers import at any depth (the JAX CLIs they port
    read images with Pillow and HF weights through transformers)."""
    import ast

    path = REPO / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {*FORBIDDEN, "PIL", "transformers"}


def test_kernel_ops_are_the_plain_version_and_the_kernel():
    """Every ``torch.library`` op of the port (``ops.library.OPS``: the
    launches an eval forward reaches, K1, K2, K4 and K6-fwd) has a CPU
    implementation that is its plain version (it calls the module's plain
    function and nothing of ``cuda_lib``), a CUDA implementation that
    launches the kernel or raises (it loads the library, checks the launch's
    status and counts it in the wrapper's ``launches``, and catches
    nothing), a fake one, and nothing else."""
    import inspect

    from irw_tpu_torch.ops.library import NAMESPACE, OPS

    plain = {"haar_swt2": "haar_swt2_plain(", "attention_fwd": "attention_plain(",
             "lifting_multi_level": "lifting_multi_level_plain(",
             "flash_attention_fwd": "flash_attention_plain("}
    wrapper = {"haar_swt2": "haar_swt2", "attention_fwd": "fused_attention",
               "lifting_multi_level": "lifting_multi_level",
               "flash_attention_fwd": "flash_attention_fwd"}
    assert set(OPS) == set(plain)
    for name, entry in OPS.items():
        qualified = f"{NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), (name, key)
        for key in ("XPU", "MPS"):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), (name, key)
        cpu, cuda = inspect.getsource(entry["plain"]), inspect.getsource(entry["kernel"])
        assert plain[name] in cpu and "cuda_lib" not in cpu and "launches" not in cpu
        assert "cuda_lib.load(" in cuda and "cuda_lib.check(" in cuda
        assert f"{wrapper[name]}.launches += 1" in cuda
        assert "try:" not in cuda and "except" not in cuda


def test_no_port_module_waits_for_a14_or_a15b():
    """ROADMAP A14 (int8, export) and A15b (the run tools) are ported: no
    raise or docstring of the port names them."""
    hits = [f"{p.relative_to(REPO)}:{i}" for p in (REPO / "irw_tpu_torch").rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if "A14" in line or "A15" in line]
    assert hits == []


def test_no_port_module_waits_for_a12():
    """ROADMAP A12 (the engine extras) is ported: no raise or docstring of
    the port names it."""
    hits = [f"{p.relative_to(REPO)}:{i}" for p in (REPO / "irw_tpu_torch").rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1) if "A12" in line]
    assert hits == []


def test_files_load_through_the_library_without_pillow(tmp_path):
    """A VOC tree of baseline JPEGs loads through the port with its library
    built, and Pillow never loads: it is the fallback's alone."""
    from test_torch_native_loader import write_voc_tree

    data_dir = write_voc_tree(tmp_path, n_train=8, n_val=2, special={})
    code = (
        "import json, sys\n"
        "from irw_tpu_torch.data import EpochLoader, get_dataset\n"
        "from irw_tpu_torch.transforms import HostTransform\n"
        f"ds = get_dataset('VOC2012Hashing', data_dir={data_dir!r})\n"
        "ops = [('Resize', {'size': 40}), ('RandomResizedCrop', {'size': 32}),\n"
        "       ('ColorJitter', {'brightness': 0.25, 'contrast': 0.25, 'saturation': 0.25}),\n"
        "       ('RandomHorizontalFlip', {})]\n"
        "loader = EpochLoader(ds, [[0, 1, 2, 3], [4, 5, 6, 7]], HostTransform(ops),\n"
        "                     num_workers=2)\n"
        "shapes = [b['image'].shape for b in loader]\n"
        "shapes.append(ds.load_image(5).shape)\n"
        "print(json.dumps([sorted(set(loader.routes.values())), 'PIL' in sys.modules,\n"
        "                  len(shapes)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [["native"], False, 3]


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("multidino_attention_hashing", **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceTransform([("SWTTransform", {})])
    model = get_model("multidino_attention_hashing", device="cpu", **TINY)
    ds = SyntheticVOCDataset(num_train=4, image_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate(model, ds, distance_metric="hamming")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_embeddings(model, ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        landmark_evaluation(np.eye(2, dtype=np.float32), np.eye(2, dtype=np.float32), GND)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("multidino_attention_hashing", device="cuda", **TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("RetrievalNet", **WCNN_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceTransform([("CustomTransform", {"decompose_levels": 1})])


def test_entry_points_run_on_cpu_when_asked(no_card):
    model = get_model("multidino_attention_hashing", device="cpu", **TINY)
    ds = SyntheticVOCDataset(num_train=6, image_size=16)
    res = evaluate(model, ds, DeviceTransform([("SWTTransform", {})], device="cpu"),
                   batch_size=4, distance_metric="hamming", device="cpu")
    assert res["num_k_level0"] == 5 and np.isfinite(list(res.values())).all()
    maps = landmark_evaluation(np.eye(2, dtype=np.float32), np.eye(2, dtype=np.float32), GND,
                               device="cpu")
    assert maps == {"map_medium": 1.0, "map_hard": 0.0}


def test_wcnn_entry_points_run_on_cpu_when_asked(no_card):
    from irw_tpu_torch.data import SyntheticDataset
    from irw_tpu_torch.models.wresnet import WCNNAttention

    model = get_model("RetrievalNet", device="cpu", **WCNN_KW)
    assert isinstance(model, WCNNAttention) and model.ce and not model.training
    assert all(p.dtype == torch.float32 and p.device.type == "cpu" for p in model.parameters())
    ds = SyntheticDataset(num_samples=6, num_classes=2, image_size=32)
    transform = DeviceTransform([("CustomTransform", {"decompose_levels": 1})], device="cpu")
    res = evaluate(model, ds, transform, batch_size=4, device="cpu")
    assert res["num_k_level0"] == 5 and np.isfinite(list(res.values())).all()


HF_TINY = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
           "image_size": 16, "patch_size": 8, "intermediate_size": 64}


@pytest.mark.parametrize("name", ["clip", "vit_b16_hf", "siglip2"])
def test_hf_towers_run_on_cpu_only_when_asked(no_card, name):
    """The HF wrapper's presets and the configs that wrap them build on the
    card by default and raise without one; on the CPU when asked they run."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(name, config_overrides=HF_TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("RetrievalNet", backbone_name="siglip2", embed_dim=8)
    model = get_model(name, device="cpu", config_overrides=HF_TINY)
    assert not model.training and all(p.device.type == "cpu" for p in model.parameters())
    with torch.no_grad():
        out, aux = model(torch.rand(2, 16, 16, 3))
    assert out.shape == (2, 32) and torch.allclose(out.norm(dim=-1), torch.ones(2))
    assert float(aux["ortho_loss"]) == 0.0


def test_cpu_tensors_take_the_plain_path_uncounted():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 8, 10).astype(np.float32))
    q, k, v = (torch.from_numpy(rng.randn(2, 9, 2, 32).astype(np.float32)) for _ in range(3))
    before = (haar_swt2.launches, fused_attention.launches, fused_attention_bwd.launches,
              lifting_multi_level.launches)
    torch.testing.assert_close(haar_swt2(x), haar_swt2_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(lifting_multi_level(x, 1, "cdf97"),
                               lifting_multi_level_plain(x, 1, "cdf97"), rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(fused_attention(q, k, v), attention_plain(q, k, v),
                                   rtol=0, atol=0)
    for a, b in zip(fused_attention_bwd(q, k, v, q), attention_plain_bwd(q, k, v, q)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fused_attention(*leaves).sum().backward()
    assert (haar_swt2.launches, fused_attention.launches, fused_attention_bwd.launches,
            lifting_multi_level.launches) == before
    with pytest.raises(ValueError):
        haar_swt2(x[0])
    with pytest.raises(ValueError, match="divide"):
        lifting_multi_level(x, 2)
    with pytest.raises(ValueError, match="unknown lifting basis"):
        lifting_multi_level(x, 1, "db2")
    with torch.no_grad(), pytest.raises(ValueError):
        fused_attention(q, k[:, :5], v)


def test_cpu_tensors_take_the_flash_plain_path_uncounted():
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 140, 2, 32).astype(np.float32))
                   for _ in range(4))
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    o, l, m = flash_attention_fwd(q, k, v, save_residuals=True)
    ro, rl, rm = flash_attention_plain(q, k, v, save_residuals=True)
    for a, b in ((o, ro), (l, rl), (m, rm)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(flash_attention_bwd(q, k, v, o, do, l, m),
                    flash_attention_plain_bwd(q, k, v, o, do, l, m)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*leaves).sum().backward()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == before
    with torch.no_grad(), pytest.raises(ValueError):
        flash_attention(q, k[:, :5], v)


def test_cpu_tensors_take_the_qkv_plain_path_uncounted():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 9, 64).astype(np.float32))
    ws = [torch.from_numpy((rng.randn(64, 64) / 8).astype(np.float32)) for _ in range(3)]
    bs = [torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)) for _ in range(3)]
    before = (fused_qkv_attention.launches, fused_attention.launches)
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (x, *ws, *bs)]
        torch.testing.assert_close(fused_qkv_attention(*args, heads=2),
                                   qkv_attention_plain(*args, heads=2), rtol=0, atol=0)
    assert (fused_qkv_attention.launches, fused_attention.launches) == before
    with pytest.raises(NotImplementedError, match="no backward"):
        fused_qkv_attention(x.clone().requires_grad_(), *ws, *bs, heads=2)


def test_other_devices_raise_instead_of_falling_back():
    with pytest.raises(ValueError, match="no kernel"):
        haar_swt2(torch.empty(2, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        lifting_multi_level(torch.empty(2, 4, 4, device="meta"))
    q = torch.empty(1, 4, 1, 32, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        fused_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        fused_attention_bwd(q, q, q, q)
    with pytest.raises(ValueError, match="no kernel"):  # a CPU gradient for meta inputs
        fused_attention_bwd(q, q, q, torch.zeros(1, 4, 1, 32))
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)
    stats = torch.empty(1, 1, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bwd(q, q, q, q, q, stats, stats)
    with pytest.raises(ValueError, match="no kernel"):  # a CPU output gradient for meta inputs
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 4, 1, 32), stats, stats)
    x, w, b = (torch.empty(s, device="meta") for s in ((1, 4, 64), (64, 64), (64,)))
    with pytest.raises(ValueError, match="no kernel"):
        fused_qkv_attention(x, w, w, w, b, b, b, heads=2)
    with pytest.raises(ValueError, match="no kernel"):  # CPU weights for a meta x
        fused_qkv_attention(x, *(torch.zeros(64, 64),) * 3, *(torch.zeros(64),) * 3, heads=2)


@pytest.mark.parametrize("call", ["fused_attention", "fused_attention_bwd", "flash_attention",
                                  "fused_qkv_attention", "haar_swt2", "lifting_multi_level"])
def test_refusals_name_the_supported_surface(call):
    """A wrapper that refuses a tensor says what its kernel takes (ROADMAP
    C6): the dtypes and, for attention, the head dims."""
    q = torch.empty(1, 4, 1, 32, device="meta")
    x, w, b = (torch.empty(s, device="meta") for s in ((1, 4, 64), (64, 64), (64,)))
    calls = {
        "fused_attention": lambda: fused_attention(q, q, q),
        "fused_attention_bwd": lambda: fused_attention_bwd(q, q, q, q),
        "flash_attention": lambda: flash_attention(q, q, q),
        "fused_qkv_attention": lambda: fused_qkv_attention(x, w, w, w, b, b, b, heads=2),
        "haar_swt2": lambda: haar_swt2(torch.empty(2, 4, 4, device="meta")),
        "lifting_multi_level": lambda: lifting_multi_level(torch.empty(2, 4, 4, device="meta")),
    }
    wanted = {"haar_swt2": "floating", "lifting_multi_level": "float32"}.get(
        call, r"float32 or bfloat16.*head_dim in \(32, 64, 128\)")
    with torch.no_grad(), pytest.raises(ValueError, match=f"no kernel.*the kernel takes .*{wanted}"):
        calls[call]()


class _CudaFloat64:
    """Stands in for an f64 tensor on the card, which this machine cannot
    make: what ``lifting_multi_level`` reads before it would launch."""

    device = torch.device("cuda")
    dtype = torch.float64
    shape = (2, 8, 8)

    def dim(self):
        return 3

    def is_floating_point(self):
        return True


def test_lifting_kernel_refuses_other_dtypes_on_the_card():
    """K4 takes f32, bf16 and f16 on the card; another float dtype is
    refused by name, before a launch."""
    before = lifting_multi_level.launches
    with pytest.raises(NotImplementedError, match="bfloat16 or float16, not torch.float64"):
        lifting_multi_level(_CudaFloat64())
    assert lifting_multi_level.launches == before


def test_unported_models_and_heads_name_their_roadmap_item():
    # the ResNet/DenseNet trunks in another dtype than float32 (A10e)
    for name, kw in (("wresnet", {}), ("mtwavenet50_fusion", {}),
                     ("hybrid_mtwavenet_v2_ce", {}), ("wcnn", {}),
                     ("resnet_ce", {"depth": 18})):
        with pytest.raises(NotImplementedError, match="A10e"):
            get_model(name, device="cpu", dtype="bfloat16", **kw)
    # the scanned layouts are only parameter layouts, accepted and ignored
    vit = make_vit("test_tiny", scan_blocks=True, scan_group=2, fused_qkv=False)
    assert len(vit.blocks) == 2


@pytest.mark.parametrize("flag", ["fused_qkv", "split_cls", "ln_fused"])
def test_block_variants_build_and_run_on_the_cpu(flag):
    """The ported Block variants (irw_tpu/models/vit.py:326-334): a bare ViT
    and the banded model build with each and give finite outputs."""
    gen = torch.Generator().manual_seed(0)
    vit = make_vit("test_tiny", img_size=16, **{flag: True})
    vit.reset_parameters(gen)
    with torch.no_grad():
        cls = vit(torch.rand(2, 16, 16, 3, generator=gen))
    assert cls.shape == (2, 64) and torch.isfinite(cls).all()
    model = get_model("multidino_attention_hashing", device="cpu",
                      **dict(TINY, vit_kwargs={"img_size": 16, flag: True}))
    with torch.no_grad():
        codes, _ = model(torch.rand(3, 4, 16, 16, 3, generator=gen))
    assert codes.shape == (3, 64) and set(codes.unique().tolist()) <= {-1.0, 1.0}


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "card"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
