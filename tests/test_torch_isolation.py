# The port stands alone: flashy_tpu_torch and chip_smoke.py import
# neither jax nor the JAX package, the package imports in a process
# where jax cannot be imported at all, and no entry point runs on the
# CPU unless asked to.
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "flashy_tpu_torch"


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "flax", "optax",
                                   "flashy_tpu"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_package_imports_with_jax_unimportable():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'flashy_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import flashy_tpu_torch.serve.scheduler, "
        "flashy_tpu_torch.models.convert, flashy_tpu_torch.ops.paged_decode\n"
        "import flashy_tpu_torch.models.ssd, flashy_tpu_torch.ops.ssd_scan\n"
        "import flashy_tpu_torch.models.moe, flashy_tpu_torch.parallel.moe_ep, "
        "flashy_tpu_torch.ops.grouped_matmul\n"
        "import flashy_tpu_torch.examples.lm.solver, "
        "flashy_tpu_torch.ops.losses, flashy_tpu_torch.checkpoint\n"
        "import flashy_tpu_torch.parallel.mesh, "
        "flashy_tpu_torch.parallel.ring, flashy_tpu_torch.parallel.ring_fused\n"
        "import flashy_tpu_torch.info, flashy_tpu_torch.ema, "
        "flashy_tpu_torch.loggers.tensorboard, flashy_tpu_torch.loggers.wandb\n"
        "import flashy_tpu_torch.serve, flashy_tpu_torch.serve.draft, "
        "flashy_tpu_torch.serve.__main__\n"
        "import flashy_tpu_torch.models.quantize, "
        "flashy_tpu_torch.models.decoding, flashy_tpu_torch.serve.engine, "
        "flashy_tpu_torch.serve.paged, flashy_tpu_torch.ops.paged_attention\n"
        "import flashy_tpu_torch.observability, "
        "flashy_tpu_torch.observability.roofline, "
        "flashy_tpu_torch.observability.telemetry\n"
        "import flashy_tpu_torch.resilience, "
        "flashy_tpu_torch.resilience.chaos, "
        "flashy_tpu_torch.serve.tracing, flashy_tpu_torch.serve.metrics\n"
        "import flashy_tpu_torch.resilience.retry, "
        "flashy_tpu_torch.resilience.integrity, "
        "flashy_tpu_torch.resilience.preemption, "
        "flashy_tpu_torch.resilience.hang, "
        "flashy_tpu_torch.resilience.__main__\n"
        "import flashy_tpu_torch.datapipe, flashy_tpu_torch.datapipe.__main__, "
        "flashy_tpu_torch.launch, flashy_tpu_torch.sweep, "
        "flashy_tpu_torch.resilience.campaign, "
        "flashy_tpu_torch.analysis.registry\n"
        "import flashy_tpu_torch.data, flashy_tpu_torch.data.loader, "
        "flashy_tpu_torch.parallel.data_parallel, flashy_tpu_torch.distrib\n"
        "import flashy_tpu_torch.parallel.schedules, "
        "flashy_tpu_torch.parallel.pipeline, "
        "flashy_tpu_torch.models.pipelined\n"
        "import chip_smoke\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'flashy_tpu') "
        "for m in sys.modules if sys.modules[m] is not None)\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from flashy_tpu_torch.models.decoding import generate
    from flashy_tpu_torch.models.transformer import (TransformerConfig,
                                                     TransformerLM)
    from flashy_tpu_torch.serve.engine import DecodeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, dim=16, num_layers=1,
                            num_heads=2, max_seq_len=32,
                            dtype=torch.float32, attention="dense")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(cfg)
    model = TransformerLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, np.zeros((1, 2), np.int32), max_new_tokens=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, slots=1, block_size=4)


def test_lm_solver_without_device_raises_when_cuda_is_absent(monkeypatch):
    import yaml
    from flashy_tpu_torch.examples.lm.solver import LMSolver
    from flashy_tpu_torch.xp import Config, temporary_xp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = PORT / "examples" / "lm" / "config" / "config.yaml"
    cfg = Config(yaml.safe_load(config.read_text()))
    assert cfg.device is None
    with temporary_xp(cfg):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMSolver(cfg)


def test_chip_smoke_refuses_to_run_without_a_card():
    # here there is no card: the script must fail and print no result
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    result = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                            cwd=ROOT, capture_output=True, text=True,
                            timeout=300)
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
