"""paddle_tpu_torch stands alone: it never imports `jax` or anything of
the JAX package, and its entry points refuse to run on the CPU unless
asked to."""
import ast
import os
import subprocess
import sys

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "paddle_tpu_torch")


def _package_files():
    for dirpath, _, files in os.walk(_PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _forbidden(module):
    """`jax`, `jax.*`, `paddle_tpu`, `paddle_tpu.*` — but not the port,
    which shares the `paddle_tpu` prefix."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def test_no_source_file_imports_jax_or_the_jax_package():
    offenders = []
    files = list(_package_files())
    assert len(files) >= 10
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, _ROOT)}: {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_forbidden_matches_prefixes_not_the_port():
    assert _forbidden("jax.numpy") and _forbidden("paddle_tpu.serving")
    assert not _forbidden("paddle_tpu_torch.serving")


def test_importing_every_submodule_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(len(mods), bad)\n"
        "assert len(mods) >= 10 and not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# the modules of the served path's host runtime, the memory observatory
# and the fleet tier: each keeps its own copy of what it needs from a
# JAX-package module that imports no JAX (the fleet modules, the retry
# module's HTTP helpers, the sink's record makers, trace_check's rules)
_SERVING_MODULES = (
    "paddle_tpu_torch.prng", "paddle_tpu_torch.monitor",
    "paddle_tpu_torch.resilience", "paddle_tpu_torch.resilience.retry",
    "paddle_tpu_torch.telemetry.sink", "paddle_tpu_torch.telemetry.reqtrace",
    "paddle_tpu_torch.telemetry.metrics_http",
    "paddle_tpu_torch.serving.engine", "paddle_tpu_torch.serving.http",
    "paddle_tpu_torch.serving.resilience",
    "paddle_tpu_torch.serving.scheduler",
    "paddle_tpu_torch.telemetry.mem_obs",
    "paddle_tpu_torch.telemetry.ledger_check",
    "paddle_tpu_torch.fleet", "paddle_tpu_torch.fleet.replica",
    "paddle_tpu_torch.fleet.router", "paddle_tpu_torch.fleet.http",
    "paddle_tpu_torch.fleet.drill")


def test_serving_runtime_modules_stand_alone():
    code = (
        "import importlib, sys\n"
        f"mods = {list(_SERVING_MODULES)!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = {os.path.relpath(p, _ROOT) for p in _package_files()}
    for m in _SERVING_MODULES:
        rel = m.replace(".", "/")
        assert f"{rel}.py" in files or f"{rel}/__init__.py" in files, m


def test_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.moe import GPTMoE, gpt_moe_tiny_config
    from paddle_tpu_torch.serving import ServingEngine
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_heads=1, max_seq_len=16)
    model = GPTForPretraining(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForPretraining(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTMoE(gpt_moe_tiny_config())
    ids = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.generate(ids, max_new_tokens=2)
    # asked for explicitly, the CPU works
    assert ServingEngine(model, device="cpu").device.type == "cpu"
    assert model.generate(ids, max_new_tokens=2,
                          device="cpu")[0].shape == (1, 5)
    assert GPTMoE(gpt_moe_tiny_config(), device="cpu").moe_num_experts == 4


def test_fleet_replicas_and_drill_raise_without_cuda(monkeypatch, tmp_path):
    """A replica (`fleet.drill --serve`) and the drill run on the card
    unless `device="cpu"` is asked for: without a card they raise before
    building anything, so the replica process exits non-zero."""
    from paddle_tpu_torch.fleet import drill
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drill.serve(0, 0, str(tmp_path / "r.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drill.drill(str(tmp_path))
    assert not (tmp_path / "r.jsonl").exists()


def test_no_module_reads_the_tools_directory():
    """The port never reaches into the JAX package's tools/ (its ledger
    rules are its own copy, telemetry/ledger_check.py)."""
    offenders = []
    for path in _package_files():
        text = open(path).read()
        for needle in ("sys.path.insert", "import trace_check",
                       "from tools", "import tools"):
            if needle in text:
                offenders.append(f"{os.path.relpath(path, _ROOT)}: {needle}")
    assert offenders == []
