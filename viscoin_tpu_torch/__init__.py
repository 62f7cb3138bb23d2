"""viscoin_tpu_torch — the PyTorch/CUDA port of viscoin_tpu for NVIDIA Hopper.

The JAX package ``viscoin_tpu`` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports ``torch`` and
never ``jax`` or ``viscoin_tpu``.

Layout:
    ops/       bias_act and upfirdn2d (hand-written CUDA kernels in csrc/,
               forward and backward, plain torch versions for CPU tensors),
               conv2d_resample, modulated_conv2d.
    models/    ResNet-50 classifier f, ConceptExtractor Psi, Explainer Theta,
               the adapted and the original StyleGAN2 generators, LPIPS-VGG,
               and the VisCoINModels bundle.
    data/      the host eval transform and the on-device preprocess.
    serve/     InferenceEngine (classify, reconstruct), MicroBatcher, and the
               stdlib HTTP server.
    train/     the VisCoIN training step and its losses.
    utils/     weights: carry the JAX package's variables into the modules.
    csrc/      CUDA C++ sources, built at first use into csrc/build/.
"""

__version__ = "0.1.0"
