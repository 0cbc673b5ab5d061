"""The port stands alone: kubeflow_tpu_torch/ and chip_smoke.py import
nothing of JAX, flax or the JAX package, and the port's entry points
refuse to run quietly on the CPU when no device was asked for."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kubeflow_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "kubeflow_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN  # "kubeflow_tpu_torch" is its own top level


def test_no_port_source_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 15
    offenders = [
        (os.path.relpath(p, REPO), m)
        for p in sources for m in _imported_modules(p) if _forbidden(m)
    ]
    assert offenders == []
    assert not _forbidden("kubeflow_tpu_torch.serving.engine")
    assert _forbidden("kubeflow_tpu.serving.engine")


def test_importing_the_whole_port_loads_no_jax():
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__"
        )
        for p in _port_sources() if not p.endswith("chip_smoke.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.main import build_server

    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("gpt_tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_server("gpt_tiny")
    model = get_model("gpt_tiny", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine("t", model)
    eng = DecodeEngine("t", model, device="cpu", autostart=False)
    eng.close()

    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    cfg = TrainingConfig(model="gpt_tiny", global_batch_size=2, steps=1,
                         seq_len=16, dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(cfg)
    assert Trainer(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_needs_nvcc_and_says_so(monkeypatch):
    from kubeflow_tpu_torch.native import build

    assert build.kernel_sources() == ["flash_attention", "paged_attention"]
    monkeypatch.setenv("PATH", "")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed here")
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.nvcc_path()
