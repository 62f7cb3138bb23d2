"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to carry on on the CPU when asked for CUDA, and its
kernel wrappers never choose the plain version for a tensor that is not on
the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from viscoin_tpu_torch.ops import _kernels, bias_act, setup_filter, upfirdn2d
from viscoin_tpu_torch.ops.bias_act import _bias_act_grad_cuda

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "viscoin_tpu_torch"


def _modules() -> list[str]:
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_package_imports_neither_jax_nor_viscoin_tpu():
    mods = _modules()
    assert len(mods) >= 25
    assert {"viscoin_tpu_torch.train", "viscoin_tpu_torch.train.viscoin",
            "viscoin_tpu_torch.train.losses", "viscoin_tpu_torch.models.lpips"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'viscoin_tpu' or n.startswith('viscoin_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_imports_neither_jax_nor_viscoin_tpu():
    """chip_smoke.py reads no module of the JAX package (checked on its
    source: importing it would need a card)."""
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1]
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "viscoin_tpu"), line


def test_engine_default_device_raises_without_cuda(monkeypatch):
    from viscoin_tpu_torch.serve.engine import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(None)


def test_default_models_default_to_cuda(monkeypatch):
    """Model construction defaults to the card too, and fails without one."""
    from viscoin_tpu_torch.models.bundle import default_models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if torch.backends.cuda.is_built():
        pytest.skip("a CUDA build of torch may create CUDA tensors lazily")
    with pytest.raises((RuntimeError, AssertionError)):
        default_models(n_classes=2, n_concepts=2, img_resolution=8, channel_base=64,
                       channel_max=8)


@pytest.mark.parametrize("op", ["bias_act", "upfirdn2d", "bias_act_grad"])
def test_wrappers_never_go_plain_off_the_cpu(monkeypatch, op):
    """A tensor that is not on the CPU reaches the kernel route and raises
    there; claiming CUDA is available does not make the wrapper fall back,
    and a failing build is never caught. CPU tensors never build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = []

    def fake_entry(name):
        built.append(name)
        raise RuntimeError("build failed")

    monkeypatch.setattr(_kernels, "entry", fake_entry)
    f = setup_filter([1.0, 3.0, 3.0, 1.0])

    def grad(x):  # the backward kernel's wrapper; on the CPU, the Function's backward
        if x.device.type != "cpu":
            return _bias_act_grad_cuda(x, None, torch.ones_like(x), act="lrelu", alpha=None,
                                       gain=1.0, clamp=None)[0]
        x.requires_grad_(True)
        return torch.autograd.grad(bias_act(x, act="lrelu").sum(), x)[0]

    call = {"bias_act": lambda x: bias_act(x, act="lrelu"),
            "upfirdn2d": lambda x: upfirdn2d(x, f, up=2, padding=(2, 1, 2, 1)),
            "bias_act_grad": grad}[op]
    with pytest.raises((ValueError, RuntimeError)):
        call(torch.empty(1, 2, 4, 4, device="meta"))
    assert call(torch.ones(1, 2, 4, 4)).device.type == "cpu"
    assert built == []


def test_kernel_launch_check_raises_and_counts():
    """A non-zero CUDA status raises; a zero one counts one launch."""
    before = _kernels.launch_counts()["bias_act"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _kernels.check("bias_act", 700)
    assert _kernels.launch_counts()["bias_act"] == before
    _kernels.check("bias_act", 0)
    assert _kernels.launch_counts()["bias_act"] == before + 1
    _kernels.reset_launch_counts()
    assert set(_kernels.launch_counts().values()) == {0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises rather than leaving the kernels unbuilt."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc at its default place")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build_all()
