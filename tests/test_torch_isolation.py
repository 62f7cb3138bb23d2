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
            "viscoin_tpu_torch.train.losses", "viscoin_tpu_torch.models.lpips",
            "viscoin_tpu_torch.data.loader", "viscoin_tpu_torch.data.datasets",
            "viscoin_tpu_torch.native", "viscoin_tpu_torch.eval.viscoin",
            "viscoin_tpu_torch.utils.checkpoints", "viscoin_tpu_torch.cli.train",
            "viscoin_tpu_torch.__main__", "viscoin_tpu_torch.train.gan",
            "viscoin_tpu_torch.train.augment", "viscoin_tpu_torch.utils.porting",
            "viscoin_tpu_torch.utils.exporting", "viscoin_tpu_torch.utils.dataclasses",
            "viscoin_tpu_torch.cli.port_weights", "viscoin_tpu_torch.cli.test",
            "viscoin_tpu_torch.models.inception", "viscoin_tpu_torch.eval.fid",
            "viscoin_tpu_torch.eval.classifiers",
            "viscoin_tpu_torch.train.classifiers", "viscoin_tpu_torch.data.stylegan_zip",
            "viscoin_tpu_torch.cli.dataset_tool", "viscoin_tpu_torch.cli.generate",
            "viscoin_tpu_torch.cli.style_mixing", "viscoin_tpu_torch.cli.project",
            "viscoin_tpu_torch.cli.fid", "viscoin_tpu_torch.eval.ppl",
            "viscoin_tpu_torch.eval.projection", "viscoin_tpu_torch.utils.gradcam",
            "viscoin_tpu_torch.utils.maths", "viscoin_tpu_torch.utils.images",
            "viscoin_tpu_torch.utils.plotting", "viscoin_tpu_torch.eval.concepts",
            "viscoin_tpu_torch.eval.spaces", "viscoin_tpu_torch.cli.serve",
            "viscoin_tpu_torch.cli.amplify", "viscoin_tpu_torch.cli.amplify_pca",
            "viscoin_tpu_torch.cli.concepts", "viscoin_tpu_torch.cli.concept_heatmaps",
            "viscoin_tpu_torch.cli.logs", "viscoin_tpu_torch.cli.to_pickle",
            "viscoin_tpu_torch.parallel", "viscoin_tpu_torch.parallel.mesh",
            "viscoin_tpu_torch.parallel.spatial",
            "viscoin_tpu_torch.ops.library", "viscoin_tpu_torch.serve.export",
            "viscoin_tpu_torch.example", "viscoin_tpu_torch.utils.cudnn",
            "viscoin_tpu_torch.models.clip", "viscoin_tpu_torch.models.concept2clip",
            "viscoin_tpu_torch.eval.concept2clip", "viscoin_tpu_torch.train.concept2clip",
            "viscoin_tpu_torch.utils.metrics", "viscoin_tpu_torch.captions",
            "viscoin_tpu_torch.captions.cub", "viscoin_tpu_torch.data"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'viscoin_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_package_imports_no_matplotlib():
    """No module of the port imports matplotlib, at its top or inside a
    function (checked on the sources): the port draws its figures itself,
    and the card's machines have no matplotlib."""
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) >= 25
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] != "matplotlib", (path, line)


def test_chip_smoke_imports_neither_jax_nor_viscoin_tpu():
    """chip_smoke.py reads no module of the JAX package (checked on its
    source: importing it would need a card)."""
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1]
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                             "viscoin_tpu"), line


def test_engine_default_device_raises_without_cuda(monkeypatch):
    from viscoin_tpu_torch.serve.engine import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(None)


def test_train_command_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    """`python -m viscoin_tpu_torch train viscoin` runs on the card unless
    given --device cpu; without a card it raises before building anything."""
    from viscoin_tpu_torch.__main__ import build_parser, main

    assert build_parser().parse_args(["train", "viscoin"]).device == "cuda"
    assert build_parser().parse_args(["train", "viscoin", "--model-parallel", "2"]).device \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "viscoin", "--dataset", "synthetic"])
    # Model parallelism too is refused without a card, not run on the CPU.
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "viscoin", "--dataset", "synthetic", "--model-parallel", "2"])


def test_train_gan_command_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    """`python -m viscoin_tpu_torch train gan` runs on the card unless given
    --device cpu; without a card it raises before building anything."""
    from viscoin_tpu_torch.__main__ import build_parser, main

    assert build_parser().parse_args(["train", "gan"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "gan", "--dataset", "synthetic"])


@pytest.mark.parametrize("argv", [
    ["port-weights", "lpips", "src", "dst"],
    ["port-weights", "export-classifier", "src", "dst"],
    ["train", "classifier", "--dataset", "synthetic"],
    ["test", "classifier", "--dataset", "synthetic"],
    ["train", "concept2clip", "--dataset", "synthetic"],
    ["port-weights", "clip", "src", "dst"],
], ids=lambda a: " ".join(a[:2]))
def test_new_commands_default_to_cuda_and_raise_without_a_card(monkeypatch, argv):
    """`port-weights` (its export kinds and `clip` too), `train classifier`,
    `train concept2clip` and `test` run on the card unless given --device
    cpu; without a card they raise before reading or building anything."""
    from viscoin_tpu_torch.__main__ import build_parser, main

    assert build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("argv", [
    ["generate", "--gan", "."],
    ["style-mixing", "--gan", "."],
    ["project", "--gan", ".", "--target", "."],
    ["fid", "--gan", ".", "--dataset", "synthetic"],
], ids=lambda a: a[0])
def test_gan_tools_default_to_cuda_and_raise_without_a_card(monkeypatch, argv):
    """`generate`, `style-mixing`, `project` and `fid` run on the card unless
    given --device cpu; without a card they raise before reading anything.
    (`dataset-tool` packs images on the host and has no --device, as in the
    JAX package.)"""
    from viscoin_tpu_torch.__main__ import build_parser, main

    assert build_parser().parse_args(argv).device == "cuda"
    assert not hasattr(build_parser().parse_args(["dataset-tool", "--source", "a", "--dest",
                                                  "b"]), "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("argv", [
    ["serve"],
    ["serve", "--from-artifact", "art"],
    ["export-serving", "-o", "art"],
    ["amplify", "--concept-top-k", "1"],
    ["amplify-pca"],
    ["concepts"],
    ["concept-heatmaps"],
    ["to-pickle", "--checkpoints", ".", "--output", "out"],
], ids=lambda a: " ".join(a[:2]) if "--from-artifact" in a else a[0])
def test_serving_and_analysis_commands_default_to_cuda_and_raise_without_a_card(
        monkeypatch, argv):
    """`serve` (of a bundle or of an artifact), `export-serving` and the
    analysis commands of a bundle run on the card unless given --device cpu;
    without a card they raise before reading anything. `logs` reads and
    draws on the host only and has no --device, as `dataset-tool`."""
    from viscoin_tpu_torch.__main__ import build_parser, main

    assert build_parser().parse_args(argv).device == "cuda"
    assert build_parser().parse_args(["export-serving", "-o", "x"]).device == "cuda"
    assert not hasattr(build_parser().parse_args(["logs", "--logs-path", "x"]), "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_fid_detectors_and_the_classifier_trainer_default_to_cuda():
    import inspect

    from viscoin_tpu_torch.cli.train import build_classifier
    from viscoin_tpu_torch.models import inception

    for fn in (inception.make_fid_detector, inception.make_nvlabs_fid_detector,
               inception.make_torchscript_fid_detector, inception.InceptionV3Features,
               build_classifier):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_gan_trainer_entry_points_default_to_cuda(monkeypatch):
    """The GAN trainer's modules are built on the card by default (and fail
    without one); its per-step draws name their device explicitly; the
    command's function defaults to cuda and raises without a card."""
    import inspect

    from viscoin_tpu_torch.cli.train import _train_gan, build_gan_modules
    from viscoin_tpu_torch.train.gan import draw_step

    assert inspect.signature(build_gan_modules).parameters["device"].default == "cuda"
    assert inspect.signature(_train_gan).parameters["device"].default == "cuda"
    assert inspect.signature(draw_step).parameters["device"].default is inspect.Parameter.empty
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _train_gan("synthetic", None, 1, 4, "out")
    if torch.backends.cuda.is_built():
        pytest.skip("a CUDA build of torch may create CUDA tensors lazily")
    with pytest.raises((RuntimeError, AssertionError)):
        build_gan_modules(8, 64, 8, 2)


def test_train_viscoin_and_bundle_loading_default_to_cuda(monkeypatch):
    import inspect

    from viscoin_tpu_torch.train.viscoin import train_viscoin
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin_bundle

    assert inspect.signature(train_viscoin).parameters["device"].default == "cuda"
    assert inspect.signature(load_viscoin_bundle).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_viscoin(None, None, None, None, None, None)


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
            return _bias_act_grad_cuda(x, None, torch.ones_like(x), None, act="lrelu",
                                       alpha=None, gain=1.0, clamp=None)[0]
        x.requires_grad_(True)
        return torch.autograd.grad(bias_act(x, act="lrelu").sum(), x)[0]

    call = {"bias_act": lambda x: bias_act(x, act="lrelu"),
            "upfirdn2d": lambda x: upfirdn2d(x, f, up=2, padding=(2, 1, 2, 1)),
            "bias_act_grad": grad}[op]
    with pytest.raises((ValueError, RuntimeError)):
        call(torch.empty(1, 2, 4, 4, device="meta"))
    assert call(torch.ones(1, 2, 4, 4)).device.type == "cpu"
    assert built == []


@pytest.mark.parametrize("op", ["bias_act", "bias_act_grad", "upfirdn2d"])
def test_registered_ops_cuda_implementations_never_go_plain(monkeypatch, op):
    """Each viscoin:: operator has a CUDA kernel in the dispatcher, the
    implementation of ops/library.py. Given a tensor that is not a CUDA
    tensor, that implementation raises in the kernel's wrapper: it never
    runs a plain version (each patched here to fail loudly), and a failing
    build is not caught."""
    import importlib

    from viscoin_tpu_torch.ops import library

    ba_mod = importlib.import_module("viscoin_tpu_torch.ops.bias_act")
    up_mod = importlib.import_module("viscoin_tpu_torch.ops.upfirdn2d")

    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"viscoin::{op}", "CUDA")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"viscoin::{op}", "CPU")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran")

    for mod, name in ((ba_mod, "bias_act_plain"), (ba_mod, "bias_act_grad_plain"),
                      (ba_mod, "_bias_act_cpu"), (ba_mod, "_bias_act_grad_cpu"),
                      (up_mod, "upfirdn2d_plain"), (up_mod, "_upfirdn2d_cpu")):
        monkeypatch.setattr(mod, name, plain)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = []

    def fake_entry(name):
        built.append(name)
        raise RuntimeError("build failed")

    monkeypatch.setattr(_kernels, "entry", fake_entry)
    impl = library.IMPLS[(op, "CUDA")]
    taps = list(setup_filter([1.0, 3.0, 3.0, 1.0]).taps)
    for device in ("cpu", "meta"):
        x = torch.ones(1, 2, 4, 4, device=device)
        args = {"bias_act": (x, None, "lrelu", None, 1.0, None),
                "bias_act_grad": (x, None, x, None, "lrelu", None, 1.0, None, True),
                "upfirdn2d": (x, taps, [2, 2], [1, 1], [2, 1, 2, 1], False, 4.0)}[op]
        with pytest.raises(ValueError, match="kernel takes CUDA tensors"):
            impl(*args)
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
