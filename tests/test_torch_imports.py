"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, it imports with JAX blocked, and its entry points (the
launcher, the analyzer's training through its constructor and
``load_analyzer``, the continuous batcher among them) refuse to run
quietly on the CPU when no CUDA device is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in PORT.rglob("*.py")) + ["chip_smoke.py"] + \
    sorted(p.relative_to(ROOT).as_posix()
           for p in (ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax_and_no_reference(rel):
    bad = [m for m in _imported_modules(ROOT / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "import repro_torch.serving.engine, repro_torch.cache.semantic\n"
        "import repro_torch.core.analyzer, repro_torch.adaptive\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.models.model, repro_torch.serving.runner\n"
        "import repro_torch.serving.catalog, repro_torch.training.steps\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.ssd_scan\n"
        "import repro_torch.kernels.moe_gating\n"
        "import repro_torch.obs, repro_torch.core.telemetry\n"
        "import repro_torch.checkpoint\n"
        "import repro_torch.launch.serve, repro_torch.core.merging\n"
        "import repro_torch.serving.scheduler\n"
        "import repro_torch.serving.async_engine\n"
        "import repro_torch.training.optimizer\n"
        "import repro_torch.sharding.rules, repro_torch.launch.mesh\n"
        "import repro_torch.launch.shapes, repro_torch.launch.dryrun\n"
        "import repro_torch.analysis.lint, repro_torch.analysis.hazards\n"
        "import repro_torch.analysis.kernel_oracle\n"
        "import repro_torch.analysis.locks, repro_torch.analysis.sanitize\n"
        "from repro_torch.serving import AsyncServingEngine, MicroBatcher\n"
        "from repro_torch.configs import ARCH_NAMES, get_config\n"
        "assert len([get_config(n) for n in ARCH_NAMES]) == 10\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _entry_points():
    from repro_torch.adaptive import LinearBandit
    from repro_torch.cache.semantic import SemanticCache
    from repro_torch.core.analyzer import AnalyzerConfig, TaskAnalyzer
    from repro_torch.core.mres import MRES
    from repro_torch.core.orchestrator import OptiRoute
    from repro_torch.core.routing import RoutingEngine
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.serving.catalog import build_catalog
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_routing_mesh
    from repro_torch.serving.runner import ModelRunner
    from repro_torch.serving.scheduler import ContinuousBatcher

    cfg = AnalyzerConfig(vocab_size=64, d_model=8, n_layers=1, n_heads=2,
                         d_ff=16, max_len=8)
    e = np.ones((4, 8), np.float32)
    return {
        "TaskAnalyzer": lambda: TaskAnalyzer(cfg),
        "RoutingEngine": lambda: RoutingEngine(MRES()),
        "make_routing_mesh": lambda: make_routing_mesh(4),
        "OptiRoute": lambda: OptiRoute(MRES(), None),
        "SemanticCache": lambda: SemanticCache(capacity=4),
        "LinearBandit": lambda: LinearBandit(4),
        "ops.router_topk": lambda: ops.router_topk(e, e, 1),
        "ops.bandit_update": lambda: ops.bandit_update(
            np.ones((1, 9)), np.ones((1, 4)), np.ones(1), np.ones((1, 9)),
            np.ones((4, 9)), np.ones((4, 9, 9)), 0.5),
        "ModelRunner": lambda: ModelRunner(get_smoke("llama3.2-1b")),
        "build_catalog": lambda: build_catalog(
            smoke_runners=True, archs=["mamba2-1.3b"]),
        "ContinuousBatcher": lambda: ContinuousBatcher(
            get_smoke("llama3.2-1b"), {}),
        "load_analyzer": lambda: serve.load_analyzer("missing.npz"),
        "serve.main": lambda: serve.main(["--requests", "1"]),
    }


@pytest.mark.parametrize("name", ["TaskAnalyzer", "RoutingEngine",
                                  "make_routing_mesh", "OptiRoute", "SemanticCache",
                                  "LinearBandit", "ops.router_topk",
                                  "ops.bandit_update", "ModelRunner",
                                  "build_catalog", "ContinuousBatcher",
                                  "load_analyzer", "serve.main"])
def test_entry_point_without_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_resolve_device_rules():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("which", ["router_topk", "router_topk_q8",
                                   "bandit_update", "flash_attention",
                                   "ssd_scan", "moe_gating"])
def test_kernel_wrappers_never_fall_back_off_the_cpu(which):
    """A tensor that is not on the CPU never takes the plain version:
    the wrapper launches its kernel or raises (here: a meta tensor)."""
    from repro_torch.kernels import bandit_update as BU
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gating as MG
    from repro_torch.kernels import router_topk as RT
    from repro_torch.kernels import ssd_scan as SS

    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
    calls = {
        "router_topk": lambda: RT.router_topk(
            m(4, 8), m(16, 8), m(1, 16, dt=torch.uint8),
            m(4, dt=torch.int32), 2),
        "router_topk_q8": lambda: RT.router_topk_q8(
            m(4, 8, dt=torch.int8), m(16, 8, dt=torch.int8), m(4), m(16),
            m(1, 16, dt=torch.uint8), m(4, dt=torch.int32), 2),
        "bandit_update": lambda: BU.bandit_update(
            m(2, 16), m(2, 9), m(2), m(3, 9), m(16, 9), m(16, 9, 9), 0.5),
        "flash_attention": lambda: FA.flash_attention(
            m(2, 4, 8, 64), m(2, 2, 8, 64), m(2, 2, 8, 64)),
        "ssd_scan": lambda: SS.ssd_scan(
            m(2, 8, 3, 16), m(2, 8, 3), m(3), m(2, 8, 4), m(2, 8, 4)),
        "moe_gating": lambda: MG.moe_gating(m(16, 8), 2),
    }
    with pytest.raises(ValueError, match="cuda or cpu"):
        calls[which]()
