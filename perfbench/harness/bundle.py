"""The measured program's VisCoIN bundle built at a configuration's sizes,
with the benchmark's seeded weights loaded by name (no initialisation of
the program's own runs)."""

from __future__ import annotations

from perfbench.harness import weights

NETS = ("classifier", "concept_extractor", "explainer", "gan")


def viscoin_bundle(s: dict, states: dict, device):
    from viscoin_tpu_torch.models.bundle import VisCoINModels
    from viscoin_tpu_torch.models.concept_extractor import ConceptExtractor
    from viscoin_tpu_torch.models.explainer import Explainer
    from viscoin_tpu_torch.models.resnet import Classifier
    from viscoin_tpu_torch.models.stylegan import GeneratorAdapted

    models = VisCoINModels(
        classifier=Classifier(output_classes=s["n_classes"], device=device),
        concept_extractor=ConceptExtractor(n_concepts=s["n_concepts"], device=device),
        explainer=Explainer(n_concepts=s["n_concepts"], n_classes=s["n_classes"],
                            device=device),
        gan=GeneratorAdapted(z_dim=s["n_concepts"], w_dim=s["w_dim"],
                             img_resolution=s["resolution"], channel_base=s["channel_base"],
                             channel_max=s["channel_max"], device=device))
    for name in NETS:
        weights.load(getattr(models, name), states[name])
    return models
