"""Runs that read their images from files, through both packages.

``studies/voc_lambda_ablation.yaml``'s first job (ortho_weight 0) over a VOC
tree the test writes (12 train and 6 val JPEGs of 40-96 × 30-64, among them
a CMYK JPEG, a grayscale JPEG, a PNG named ``.jpg`` and two cut files):
``dataset=voc``, ``transform=swt`` cut to 32² crops, ``loss=hash_loss``, batch
6, one epoch of two steps and one Hamming eval, with the model at the width
``tests/test_torch_smoke_plan.py`` runs (``single_band_tiny``: 64 bits over
band 0 of a vit_tiny) in place of the flagship and its ortho weight.  The
flagship's JAX init alone takes about 22 s op by op on the CPU;
``tests/test_torch_runner.py`` runs the flagship's study at test width.
Both packages' ``run`` train from the same weights
(``test_torch_default_runs.run_both``); irw_tpu's native route runs the
port's library (``test_torch_native_loader``), so both decode the batches
alike.  Tolerances: the metrics to 1e-5 relative.

One ``dataset=cub`` job (``transform=cub_dwt``, ``model=wcnn_attention_ce``)
builds its datasets and first batch in both packages: the host stage's
images to 1 LSB, the DWT bands to 1e-5.
"""

import torch_threads  # noqa: F401  (first: one PyTorch thread a worker)
import jax
import numpy as np
import pytest

from irw_tpu.config import compose as jax_compose
from irw_tpu.getter import Getter as JaxGetter
from irw_tpu_torch.config import compose
from irw_tpu_torch.data import EpochLoader
from irw_tpu_torch.getter import Getter
from irw_tpu_torch.single_experiment_runner import CONFIG_DIR
from irw_tpu_torch.studies import run_plan
# _no_tensorboard: the autouse fixture that keeps TensorFlow from importing
from test_torch_datasets import assert_same, write_cub
from test_torch_default_runs import LOCAL, _no_tensorboard, check_runs, run_both  # noqa: F401
from test_torch_native_loader import jax_on_port_library, library, write_voc_tree  # noqa: F401

STUDY = f"{CONFIG_DIR}/../studies/voc_lambda_ablation.yaml"
SMALL = ["model=single_band_tiny", "transform.train.RandomResizedCrop.size=32",
         "transform.test.Resize.size=32", "dataset.sampler.kwargs.batch_size=6",
         "experience.sub_batch=6", "experience.max_iter=1", "experience.step_per_epoch=2",
         "experience.test_eval_freq=1", "experience.eval_bs=8",
         "experience.evaluation.top_k=12"] + LOCAL


def test_voc_ablation_job_from_files_runs_as_jax(tmp_path, jax_on_port_library):  # noqa: F811
    name, overrides = run_plan.expand_jobs(run_plan.load_plan(STUDY))[0]
    assert "model.kwargs.fusion_config.ortho_weight=0" in overrides and "dataset=voc" in overrides
    data_dir = write_voc_tree(tmp_path / "voc")
    overrides = ([o for o in overrides if not o.startswith(("experience.log_dir=", "model"))]
                 + SMALL + [f"dataset.kwargs.data_dir={data_dir}"])
    routes = []
    load_batch = EpochLoader._load_batch

    def recording(self, batch_idx, indices):
        out = load_batch(self, batch_idx, indices)
        routes.append(self.routes[batch_idx])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EpochLoader, "_load_batch", recording)
        jax_metrics, metrics, _, cfg = run_both(overrides, tmp_path)
    assert cfg.dataset.name == "VOC2012Hashing" and cfg.model.name == "single_band_net"
    assert cfg.transform.train.SWTTransform and cfg.loss[0].name == "HashLoss"
    # two train steps, the eval's query (1 batch) and gallery (2): every one
    # decoded from the files by the library
    assert routes == ["native"] * 5
    check_runs(tmp_path, cfg, jax_metrics, metrics)
    assert 0 < metrics["test"]["map_level0"] <= 1


def test_cub_job_builds_its_datasets_and_first_batch_as_jax(tmp_path):
    data_dir = write_cub(tmp_path / "cub", np.random.RandomState(1), image_files=True)
    overrides = ["dataset=cub", "transform=cub_dwt", "model=wcnn_attention_ce",
                 f"dataset.kwargs.data_dir={data_dir}", "dataset.sampler.kwargs.batch_size=8"]
    cfg, jcfg = (compose(CONFIG_DIR, "default", overrides),
                 jax_compose(CONFIG_DIR, "default", overrides))
    (train, evals), (jtrain, jevals) = (Getter().get_dataset(cfg.dataset),
                                        JaxGetter().get_dataset(jcfg.dataset))
    assert_same(train, jtrain)
    assert_same(evals["test"], jevals["test"])
    assert len(train) == len(evals["test"]) == 24
    (host, device), _ = Getter().get_transform(cfg.transform, device="cpu")
    (jhost, jdevice), _ = JaxGetter().get_transform(jcfg.transform)
    sampler, jsampler = (g.get_sampler(ds, cfg.dataset.sampler)
                         for g, ds in ((Getter(), train), (JaxGetter(), jtrain)))
    sampler.seed = jsampler.seed = 333
    first = sampler.reshuffle(0).batches[0]
    np.testing.assert_array_equal(first, jsampler.reshuffle(0).batches[0])
    # run.py's first batch: load_image and the train host stage from RandomState(seed)
    images = host.batch([train.load_image(int(i)) for i in first], np.random.RandomState(333),
                        True)
    rng = np.random.RandomState(333)
    ref = np.stack([jhost(jtrain.load_image(int(i)), rng, True) for i in first])
    assert images.shape == ref.shape == (8, 224, 224, 3)
    assert np.abs(images.astype(int) - ref).max() <= 1
    bands = device(ref).numpy()
    jbands = np.asarray(jax.device_get(jdevice(ref)))
    assert bands.shape == jbands.shape == (8, 4, 112, 112, 3)
    np.testing.assert_allclose(bands, jbands, rtol=0, atol=1e-5 * max(1.0, np.abs(jbands).max()))
    # and the loader's first train batch, on the route each package takes
    batch, = EpochLoader(train, [first], host, num_workers=0, seed=333)
    assert batch["image"].shape == (8, 224, 224, 3)
    np.testing.assert_array_equal(batch["label"], jtrain.labels[first])
