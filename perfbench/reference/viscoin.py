"""VisCoIN's other networks in plain PyTorch (arXiv:2407.01331): the
ResNet-50 classifier f (eval-mode BatchNorm, frozen), the concept extractor
Psi, the explainer Theta and LPIPS on VGG16 (Zhang et al., arXiv:1801.03924,
v0.1 shift and scale), with parameter names as in the measured program's
state dicts."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.stylegan import PERTURB

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DROPOUT = 0.01


def lecun(t: torch.Tensor):
    return ("normal", 0.0, 1.0 / math.sqrt(t[0].numel()))


def zero():
    return ("normal", 0.0, PERTURB)


def preprocess(images_u8: torch.Tensor, flips: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W, 3) u8 -> ImageNet-normalised (B, 3, H, W) fp32, x-flipped
    where ``flips``."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    if flips is not None:
        x = torch.where(flips[:, None, None, None], x.flip(3), x)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def denormalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return x * std + mean


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, act=True):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def init_plan(self):
        return {"conv.weight": lecun(self.conv.weight), "bn.weight": ("normal", 1.0, PERTURB),
                "bn.bias": zero(), "bn.running_mean": zero(),
                "bn.running_var": ("normal", 1.0, PERTURB)}

    def forward(self, x):
        x = F.batch_norm(self.conv(x), self.bn.running_mean, self.bn.running_var,
                         self.bn.weight, self.bn.bias, training=False, eps=self.bn.eps)
        return torch.relu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        mid = cout // 4
        self.conv1 = ConvBN(cin, mid, 1)
        self.conv2 = ConvBN(mid, mid, 3, stride)
        self.conv3 = ConvBN(mid, cout, 1, act=False)
        self.shortcut = (ConvBN(cin, cout, 1, stride, act=False)
                         if cin != cout or stride != 1 else None)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return torch.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNetBackbone(nn.Module):
    def __init__(self, widths=(256, 512, 1024, 2048), depths=(3, 4, 6, 3), stem=64):
        super().__init__()
        self.embedder = ConvBN(3, stem, 7, 2)
        self.stages = []
        ch = stem
        for i, (w, d) in enumerate(zip(widths, depths)):
            names = []
            for j in range(d):
                stride = 2 if i > 0 and j == 0 else 1
                self.add_module(f"stage{i}_block{j}", Bottleneck(ch, w, stride))
                names.append(f"stage{i}_block{j}")
                ch = w
            self.stages.append(names)

    def forward(self, x):
        x = F.max_pool2d(self.embedder(x), 3, 2, 1)
        hidden = [x]
        for names in self.stages:
            for n in names:
                x = getattr(self, n)(x)
            hidden.append(x)
        return x.mean(dim=(2, 3)), hidden


class Classifier(nn.Module):
    """ResNet-50 (the HF microsoft/resnet-50 layout) with a linear head."""

    def __init__(self, n_classes):
        super().__init__()
        self.resnet = ResNetBackbone()
        self.linear = nn.Linear(2048, n_classes)

    def init_plan(self):
        return {"linear.weight": ("normal", 0.0, math.sqrt(2.0 / 2048)), "linear.bias": zero()}

    def forward(self, x):
        pooled, hidden = self.resnet(x)
        return self.linear(pooled), hidden


class ConceptExtractor(nn.Module):
    """Psi: the last three hidden states to a common 8x8 grid (at 256²),
    mixed, then Phi (B, K, 3, 3) and Phi' (B, 9K)."""

    def __init__(self, n_concepts, lc=512):
        super().__init__()
        self.conv1 = nn.Conv2d(512, lc, 5, stride=4, padding=2)
        self.conv2 = nn.Conv2d(1024, lc, 3, stride=2, padding=1)
        self.conv3 = nn.Conv2d(2048, lc, 3, stride=1, padding=1)
        self.conv4 = nn.Conv2d(3 * lc, 3 * lc, 3, padding=1)
        self.conv5 = nn.Conv2d(3 * lc, n_concepts, 1)
        self.linear1 = nn.Linear(9 * 3 * lc, 9 * n_concepts)
        self.linear2 = nn.Linear(9 * n_concepts, 9 * n_concepts, bias=False)

    def init_plan(self):
        plan = {}
        for name, p in self.named_parameters():
            plan[name] = lecun(p) if name.endswith("weight") else zero()
        return plan

    def forward(self, hidden):
        a, b, c = hidden[-3:]
        x = torch.cat([torch.relu(self.conv1(a)), torch.relu(self.conv2(b)),
                       torch.relu(self.conv3(c))], dim=1)
        x = torch.relu(self.conv4(x))
        phi = F.adaptive_avg_pool2d(torch.relu(self.conv5(x)), 3)
        y = F.adaptive_avg_pool2d(x, 3).reshape(x.shape[0], -1)
        return phi, torch.relu(self.linear2(torch.relu(self.linear1(y))))


class Explainer(nn.Module):
    """Theta: dropout 0.01 on Phi in training (a keep mask drawn from the
    generator, kept values scaled by 1 / 0.99), max over each 3x3 map, a
    linear layer."""

    def __init__(self, n_concepts, n_classes):
        super().__init__()
        self.linear = nn.Linear(n_concepts, n_classes)

    def init_plan(self):
        return {"linear.weight": lecun(self.linear.weight), "linear.bias": zero()}

    def forward(self, phi, generator=None, train=False):
        if train:
            keep = torch.rand(phi.shape, generator=generator, device=phi.device) < 1.0 - DROPOUT
            phi = torch.where(keep, phi / (1.0 - DROPOUT), torch.zeros((), device=phi.device))
        return self.linear(phi.amax(dim=(2, 3)))


SLICES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        i, ch = 0, 3
        for sl in SLICES:
            for c in sl:
                self.add_module(f"conv{i}", nn.Conv2d(ch, c, 3, padding=1))
                i, ch = i + 1, c

    def init_plan(self):
        return {n: (lecun(p) if n.endswith("weight") else zero())
                for n, p in self.named_parameters()}

    def forward(self, x):
        outs, i = [], 0
        for s, sl in enumerate(SLICES):
            if s:
                x = F.max_pool2d(x, 2, 2)
            for _ in sl:
                x = torch.relu(getattr(self, f"conv{i}")(x))
                i += 1
            outs.append(x)
        return outs


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, sl in enumerate(SLICES):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.empty(sl[-1])))

    def init_plan(self):
        return {f"lin{i}": ("uniform", 0.0, 1.0) for i in range(len(SLICES))}

    def forward(self, x, y):
        shift = torch.tensor(SHIFT, device=x.device)[:, None, None]
        scale = torch.tensor(SCALE, device=x.device)[:, None, None]
        total = 0.0
        fx, fy = self.vgg((x - shift) / scale), self.vgg((y - shift) / scale)
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (a.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            b = b / (b.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
            lin = getattr(self, f"lin{i}")[:, None, None]
            total = total + (lin * (a - b).square()).sum(dim=1).mean(dim=(1, 2))
        return total


def factories(s: dict) -> dict:
    """Builders of the VisCoIN configuration's reference networks, by the
    names the benchmark's weights are drawn under: the bundle's four, the
    presampler's original generator and LPIPS."""
    from perfbench.reference import stylegan as SG

    res, cb, cm = s["resolution"], s["channel_base"], s["channel_max"]
    return {
        "classifier": lambda: Classifier(s["n_classes"]),
        "concept_extractor": lambda: ConceptExtractor(s["n_concepts"]),
        "explainer": lambda: Explainer(s["n_concepts"], s["n_classes"]),
        "gan": lambda: SG.GeneratorAdapted(s["n_concepts"], s["w_dim"], res, cb, cm),
        "generator": lambda: SG.Generator(s["z_dim"], s["w_dim"], res, s["mapping_layers"], cb, cm),
        "lpips": LPIPS,
    }
