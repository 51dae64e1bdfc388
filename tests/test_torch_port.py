"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points refuse to run on the CPU unless asked."""

import ast
import pathlib

import pytest
import torch

from apex_tpu_torch import amp
from apex_tpu_torch.models import generate as tgen
from apex_tpu_torch.models.config import gpt_tiny
from apex_tpu_torch.models.gpt import make_gpt_train_step
from apex_tpu_torch.models.transformer_lm import init_gpt_params
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.utils.registry import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "apex_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "apex_tpu"}, roots


# port modules whose JAX counterpart has another name, or none
COUNTERPARTS = {
    "ops/_kernel_utils.py": "ops/_pallas_utils.py",
    "models/convert.py": None,          # the numpy bridge between the two
    "utils/prng.py": None,              # jax.random's threefry, in torch
}


def test_port_tree_mirrors_the_jax_package():
    for path in (ROOT / "apex_tpu_torch").rglob("*.py"):
        rel = path.relative_to(ROOT / "apex_tpu_torch").as_posix()
        twin = COUNTERPARTS.get(rel, rel)
        if twin is not None:
            assert (ROOT / "apex_tpu" / twin).exists(), rel


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["init_gpt_params", "init_kv_cache",
                                   "prefill", "decode_step", "generate"])
def test_entry_points_raise_without_device_or_cuda(monkeypatch, entry):
    _no_cuda(monkeypatch)
    cfg = gpt_tiny(num_layers=1, compute_dtype=torch.float32)
    params = init_gpt_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.zeros(1, 3, dtype=torch.long)
    cache = tgen.init_kv_cache(cfg, 1, 8, device="cpu")
    calls = {
        "init_gpt_params": lambda: init_gpt_params(cfg),
        "init_kv_cache": lambda: tgen.init_kv_cache(cfg, 1, 8),
        "prefill": lambda: tgen.prefill(params, prompt, cfg),
        "decode_step": lambda: tgen.decode_step(
            params, torch.zeros(1, dtype=torch.long), cache, cfg),
        "generate": lambda: tgen.generate(params, prompt, cfg,
                                          max_new_tokens=2),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["make_gpt_train_step", "initialize",
                                   "init_loss_scale"])
def test_train_entry_points_raise_without_device_or_cuda(monkeypatch,
                                                          entry):
    _no_cuda(monkeypatch)
    cfg = gpt_tiny(num_layers=1)
    calls = {
        "make_gpt_train_step": lambda: make_gpt_train_step(cfg, fused_adam()),
        "initialize": lambda: amp.initialize("O2"),
        "init_loss_scale": lambda: amp.init_loss_scale(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
