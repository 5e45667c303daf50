"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU.

Every module of ``src/repro_torch``, ``chip_smoke.py``, the port's
scripts (``scripts/torch_*.py``) and its examples (``examples/torch/``)
imports neither ``jax`` nor ``repro`` (an AST scan, plus subprocesses that
import each module of the package, each example and each script with both
blocked); the test modules that the two-rank worlds' ranks
import (the harness, the mesh runner and the files that name its arch)
import neither at their top level. Entry points called without ``device=`` on a
machine with no card raise instead of running on the CPU, and
``chip_smoke.py`` exits non-zero with no result line there, and also when
it stands alone in a directory without the rest of the repository.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SCRIPTS = sorted((ROOT / "scripts").glob("torch_*.py"))
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("*.py"))
FILES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + SCRIPTS
         + EXAMPLES)
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in PKG.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


RANK_MODULES = [ROOT / "tests" / f for f in (
    "torch_dist_harness.py", "torch_mesh_models.py",
    "test_torch_mesh_rwkv.py", "test_torch_mesh_zamba.py",
    "test_torch_mesh_mixtral.py", "test_torch_mesh_deepseek.py")]


@pytest.mark.parametrize("path", RANK_MODULES, ids=lambda p: p.name)
def test_rank_modules_import_no_jax_at_top_level(path):
    top = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            top += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            top.append(node.module)
    bad = [m for m in top if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert top and not bad, f"{path} imports {bad} at its top level"


def test_modules_import_with_jax_and_repro_blocked():
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for mod in {MODULES!r}:\n"
            "    importlib.import_module(mod)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 15


def test_examples_and_scripts_import_with_jax_and_repro_blocked():
    code = ("import importlib.util, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for i, path in enumerate({[str(p) for p in EXAMPLES + SCRIPTS]!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'm{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(EXAMPLES) == 6 and SCRIPTS


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_jax
    from repro_torch.models import model
    from repro_torch.serve import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, {})
    params = model.init(cfg, device="cpu")
    prompts = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.generate(params, cfg, prompts, 2)
    assert engine.generate(params, cfg, prompts, 2, device="cpu").shape \
        == (1, 2)


def test_training_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.convert import state_from_jax
    from repro_torch.optim import adamw, powersgd
    from repro_torch.train import train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    opt = adamw.AdamWConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.init_train_state(0, cfg, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_jax(cfg, {"params": {}})
    state = train_step.init_train_state(0, cfg, opt, device="cpu")
    assert all(p.requires_grad and p.device.type == "cpu"
               for p in state["params"].parameters())
    extra = powersgd.init(powersgd.PowerSGDConfig(min_size=1024),
                          state["params"])
    assert sorted(extra) == ["embed.table", "lm_head.table"]
    assert all(t.device.type == "cpu" for st in extra.values()
               for t in st.values())


def test_new_modules_are_scanned():
    for mod in ("repro_torch.core.perf_model", "repro_torch.kernels.reduce",
                "repro_torch.models.losses", "repro_torch.optim.adamw",
                "repro_torch.optim.powersgd", "repro_torch.optim.schedule",
                "repro_torch.train.train_step",
                "repro_torch.data.pipeline", "repro_torch.kernels.quant",
                "repro_torch.layout", "repro_torch.analysis",
                "repro_torch.analysis.contracts", "repro_torch.linalg",
                "repro_torch.linalg.tsqr", "repro_torch.ft",
                "repro_torch.ft.abft", "repro_torch.ft.inject",
                "repro_torch.ft.watchdog", "repro_torch.ft.elastic",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.launch.train", "repro_torch.models.rwkv6",
                "repro_torch.configs.rwkv6_1p6b",
                "repro_torch.configs.llama3p2_3b",
                "repro_torch.configs.mistral_nemo_12b",
                "repro_torch.configs.qwen2_72b",
                "repro_torch.kernels.compat",
                "repro_torch.linalg.tree_tsqr",
                "repro_torch.distributed",
                "repro_torch.distributed.sharding",
                "repro_torch.distributed.pipeline",
                "repro_torch.launch.mesh", "repro_torch.models.moe",
                "repro_torch.configs.mixtral_8x7b",
                "repro_torch.configs.deepseek_v3_671b",
                "repro_torch.models.heads", "repro_torch.analysis.lint",
                "repro_torch.analysis.audit",
                "repro_torch.analysis.kernel_verify"):
        assert mod in MODULES
    for path in (*(EXAMPLES[0].parent / f"{n}.py" for n in (
            "quickstart", "powersgd_abft", "train_lm", "serve_lm", "rsvd",
            "kmeans")), ROOT / "scripts" / "torch_check_contracts.py"):
        assert path in FILES


def _smoke(cwd, claim_a_card=False):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    # claim_a_card: pretend a card is present, to reach the checks after
    # the first one.
    code = ("import runpy, torch\n"
            f"if {claim_a_card!r}:\n"
            "    torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path, claim_a_card=True)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "src/repro_torch is missing" in out.stderr
