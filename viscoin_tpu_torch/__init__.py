"""viscoin_tpu_torch — the PyTorch/CUDA port of viscoin_tpu for NVIDIA Hopper.

The JAX package ``viscoin_tpu`` is the reference; this package mirrors its
module paths so each counterpart is easy to find. It imports ``torch`` and
never ``jax`` or ``viscoin_tpu``.

Layout:
    ops/       bias_act and upfirdn2d (hand-written CUDA kernels in csrc/,
               forward and backward, plain torch versions for CPU tensors,
               registered as viscoin:: operators in library.py),
               conv2d_resample, modulated_conv2d.
    models/    ResNet-50 classifier f, ConceptExtractor Psi, Explainer Theta,
               the adapted and the original StyleGAN2 generators and the
               discriminator, LPIPS-VGG, the FID Inception, and the
               VisCoINModels bundle.
    manifests/ the key and shape inventories of the reference's torch
               networks (copies of the JAX package's).
    data/      datasets, the DataLoader and DevicePrefetcher, host transforms
               and the on-device preprocess.
    native/    the host crop + resize of the loader (C++, built with g++).
    eval/      the ensemble's and the classifier's test metrics,
               amplification, the faithfulness probe, FID, KID and
               precision/recall.
    serve/     InferenceEngine (classify, reconstruct, explain, amplify),
               MicroBatcher, the stdlib HTTP server, and sealed torch.export
               artifacts (export.py).
    train/     the classifier, VisCoIN and StyleGAN2 trainers (steps, losses,
               loops), ADA.
    utils/     weights (JAX variables <-> modules), porting and exporting
               (the reference's torch state_dicts <-> JAX variables),
               checkpoints, jsonl logging.
    cli/       `python -m viscoin_tpu_torch <command>` (port-weights, train,
               test, serve, export-serving, the GAN tools, the analysis).
    csrc/      CUDA C++ sources, built at first use into csrc/build/.
    example.py `python -m viscoin_tpu_torch.example`: the forward on two images.
"""

__version__ = "0.1.0"
