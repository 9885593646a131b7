"""The port's configuration, imports and device rule.

  * every YAML under ``configs/`` parses to the same dict through the
    port's own ``Hparams`` copy as through the JAX package's;
  * no ``.py`` file of ``vae_gslm_tpu_torch/``, and not ``chip_smoke.py``,
    imports ``jax``, ``flax`` or ``vae_gslm_tpu``;
  * the builders, the sampler and the trainer run on CUDA by default
    and raise on a machine without it unless the caller passes
    ``device="cpu"``."""
import ast
import glob
import os

import pytest
import torch

from tests.test_e2e_lvtr import TRAIN_HP, VOCODER_HP
from tests.test_models import HFG_HP
from tests.test_torch_trunk import N_MELS, TINY_YAML
from vae_gslm_tpu.hparams.hp import Hparams as JHparams
from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.inference.speech.sampler import ARTRSampler
from vae_gslm_tpu_torch.models.speech.lvtr import LVTR
from vae_gslm_tpu_torch.models.vocoder.hfgan import Generator
from vae_gslm_tpu_torch.trainers.speech.lvtr import LVTRTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.y*ml"),
                       recursive=True))
PORT_FILES = sorted(
    [os.path.relpath(p, ROOT)
     for p in glob.glob(os.path.join(ROOT, "vae_gslm_tpu_torch", "**",
                                     "*.py"), recursive=True)]
    + ["chip_smoke.py"])
FORBIDDEN = ("jax", "flax", "vae_gslm_tpu")


def test_configs_found():
    assert len(CONFIGS) >= 5, CONFIGS
    assert "configs/train/speech/vae-gslm.yaml" in CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_config_parses_like_jax(path):
    full = os.path.join(ROOT, path)
    ours = Hparams.from_yamlfile(full)
    ref = JHparams.from_yamlfile(full)
    assert ours.to_dict() == ref.to_dict()
    assert Hparams.from_dict(ours.to_dict()) == ours


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [
    "vae_gslm_tpu_torch/parallel/mesh.py",
    "vae_gslm_tpu_torch/parallel/tp.py",
    "vae_gslm_tpu_torch/training/logging.py",
    "vae_gslm_tpu_torch/scripts/train.py"])
def test_import_guard_covers_training_slice(path):
    """The data-parallel training slice's modules are among the guarded
    files and import no JAX."""
    assert path in PORT_FILES
    test_port_imports_no_jax(path)


def _tiny_lvtr(**kw):
    return LVTR(Hparams.from_yaml(TINY_YAML), input_dim=N_MELS, **kw)


def _train_hp(tmp_path):
    """``tests/test_e2e_lvtr.py``'s training config; its vocoder
    directory holds only the ``hp.yaml`` the port's trainer reads."""
    (tmp_path / "hp.yaml").write_text(VOCODER_HP)
    return Hparams.from_yaml(TRAIN_HP.format(
        log_dir=tmp_path, vocoder_dir=tmp_path, corpus=tmp_path))


@pytest.mark.parametrize("builder", ["lvtr", "generator", "sampler",
                                     "sampler_int8", "trainer"])
def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path,
                                                     builder):
    sampler = builder.startswith("sampler")
    cpu_model = _tiny_lvtr(device="cpu") if sampler else None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "lvtr": _tiny_lvtr,
        "generator": lambda **kw: Generator(
            Hparams.from_dict(HFG_HP.to_dict()), **kw),
        "sampler": lambda **kw: ARTRSampler(cpu_model, **kw),
        "sampler_int8": lambda **kw: ARTRSampler(
            cpu_model, quantize_weights=True, **kw),
        "trainer": lambda **kw: LVTRTrainer(_train_hp(tmp_path), **kw),
    }[builder]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(device="cuda")
    built = build(device="cpu")
    if builder == "trainer":
        assert {p.device.type for p in built.params} == {"cpu"}
    elif not sampler:
        assert {p.device.type for p in built.parameters()} == {"cpu"}
    else:
        assert built.device == torch.device("cpu")
        int8 = cpu_model.transformer.layers[0].linear1.weight.dtype \
            == torch.int8
        assert int8 == (builder == "sampler_int8")
