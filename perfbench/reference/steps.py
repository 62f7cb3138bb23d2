"""The plain reference of each timed entry: VisCoIN's training step and its
presampler, StyleGAN2-ADA's training step with its random draws, and the
reconstruct endpoint's forward.

The random numbers are worked out again from the run's seed by the rules
the measured program documents: a step's generator is seeded by
``fold_seed(seed, step)`` (numpy's SeedSequence), its draws follow in the
order the step consumes them. Nothing here reads a tensor the program made.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import stylegan as SG
from perfbench.reference import viscoin as VC

SAMPLER_TAG = 0x53414D50
RANK_TAG = 0x52414E4B
DEVICE_TAG = 0x44455643
NOISE_TAGS = {"g": 1, "d": 2, "ppl": 3}


def fold_seed(seed: int, *data: int) -> int:
    words = np.random.SeedSequence([int(seed), *map(int, data)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _unit_rows(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def cross_ce(pred, target):
    return torch.mean(torch.sum(-torch.softmax(target, dim=1) * F.log_softmax(pred, dim=1), dim=1))


# --------------------------------- VisCoIN ---------------------------------- #


@dataclass
class VisCoINHyper:
    """The paper's CUB settings."""

    lr: float = 1e-4
    cd_fid_iteration: int = 100
    alpha: float = 0.5
    beta: float = 3.0
    gamma: float = 0.1
    delta: float = 0.2
    k: int = 2


class VisCoINReference:
    """f, Psi, Theta, the adapted G (its mapping trained, its synthesis
    frozen), the original G (the presampler's) and LPIPS, with two Adams
    (Psi + Theta; the mapping)."""

    LOSSES = ("acc_loss", "cr_loss", "of_loss", "ortho_loss", "rec_loss", "gan_loss", "total_loss")

    def __init__(self, nets: dict, hyper: VisCoINHyper):
        self.n = nets
        self.h = hyper
        for name in ("classifier", "generator", "lpips"):
            nets[name].requires_grad_(False)
        nets["gan"].synthesis.requires_grad_(False)
        self.groups = {"concept_extractor": nets["concept_extractor"],
                       "explainer": nets["explainer"], "mapping": nets["gan"].mapping}

        def adam(params):
            return torch.optim.Adam(params, lr=hyper.lr, betas=(0.9, 0.999), eps=1e-8)

        self.opt = adam([*nets["concept_extractor"].parameters(), *nets["explainer"].parameters()])
        self.gan_opt = adam(list(nets["gan"].mapping.parameters()))

    def named_params(self) -> dict[str, torch.Tensor]:
        return {f"{g}.{n}": p for g, m in self.groups.items() for n, p in m.named_parameters()}

    def first_grads(self) -> dict[str, torch.Tensor]:
        """Each leaf's gradient of the first update, from Adam's first
        moment after it: m = (1 - beta1) g."""
        out = {}
        for opt in (self.opt, self.gan_opt):
            beta1 = opt.param_groups[0]["betas"][0]
            for p in opt.param_groups[0]["params"]:
                out[p] = opt.state[p]["exp_avg"] / (1.0 - beta1)
        return {n: out[p] for n, p in self.named_params().items()}

    @torch.no_grad()
    def sample_fakes(self, seed: int, group_start: int, rows: int, device) -> torch.Tensor:
        seeds = [fold_seed(seed, group_start + j, SAMPLER_TAG) for j in range(self.h.k)]
        g = self.n["generator"]
        z = torch.cat([torch.randn((rows, g.z_dim), device=device, generator=generator(s, device))
                       for s in seeds])
        fakes = g(z, "random", generator(fold_seed(seeds[0], 1), device))
        return fakes.reshape(len(seeds), rows, *fakes.shape[1:])

    def step(self, images_u8, labels, step: int, seed: int, fake) -> dict[str, float]:
        n, h = self.n, self.h
        device = images_u8.device
        rng = generator(fold_seed(seed, step), device)
        flips = torch.rand(images_u8.shape[0], device=device, generator=rng) < 0.5
        real = VC.preprocess(images_u8, flips)
        B = real.shape[0]
        all_images = torch.cat([real, fake])
        classes, hidden = n["classifier"](all_images)
        phi, phi_prime = n["concept_extractor"](hidden)
        expl = n["explainer"](phi, generator=rng, train=True)
        gate = float(step > h.cd_fid_iteration)
        pooled = phi.amax(dim=(2, 3))
        cr = gate * h.delta * (_unit_rows(pooled).abs().mean() + phi.abs().mean())
        of = gate * h.alpha * cross_ce(expl, classes.detach())
        w5 = n["concept_extractor"].conv5.weight
        k = w5.shape[0]
        wu = _unit_rows(w5.reshape(k, -1)).abs()
        ortho = (torch.sum(wu @ wu.T) - k) / k**2
        ws = n["gan"].mapping(phi, phi_prime)
        rebuilt = n["gan"].synthesis(ws, "random", rng)
        rebuilt_classes = n["classifier"](rebuilt)[0]
        diff = rebuilt - all_images
        rec = (diff.abs().mean() + diff.square().mean()
               + h.gamma * cross_ce(rebuilt_classes, classes.detach())
               + h.beta * n["lpips"](rebuilt, all_images).mean())
        gan = (ws - n["gan"].mapping.fixed_w_avg.detach()).square().mean()
        acc = -torch.gather(F.log_softmax(classes[:B], dim=-1), 1, labels[:, None]).mean()
        total = acc + cr + of + ortho + rec + gan
        self.opt.zero_grad(set_to_none=True)
        self.gan_opt.zero_grad(set_to_none=True)
        total.backward()
        self.opt.step()
        self.gan_opt.step()
        vals = torch.stack([torch.as_tensor(v, device=device, dtype=torch.float32)
                            for v in (acc, cr, of, ortho, rec, gan, total)]).detach().double().cpu()
        return dict(zip(self.LOSSES, vals.tolist()))


# ---------------------------------- GAN ------------------------------------ #


@dataclass
class GANHyper:
    """The measured program's GANTrainingParams defaults (r1_gamma 1, ema
    10 kimg, ADA target 0.6 every 4 steps over 500 kimg)."""

    lr: float = 2.5e-3
    beta2: float = 0.99
    r1_gamma: float = 1.0
    r1_interval: int = 16
    mixing: float = 0.9
    pl_weight: float = 2.0
    pl_interval: int = 4
    pl_decay: float = 0.01
    w_avg_beta: float = 0.995
    ema_kimg: float = 10.0
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0


@dataclass
class AugDraws:
    flip_do: torch.Tensor
    flip_coin: torch.Tensor
    r90_do: torch.Tensor
    r90_k: torch.Tensor
    xint_do: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    iso_do: torch.Tensor
    iso: torch.Tensor
    rot_do: torch.Tensor
    theta: torch.Tensor
    aniso_do: torch.Tensor
    aniso: torch.Tensor
    frac_do: torch.Tensor
    frac: torch.Tensor
    bright_do: torch.Tensor
    bright: torch.Tensor
    contrast_do: torch.Tensor
    contrast: torch.Tensor
    lumaflip_do: torch.Tensor
    lumaflip_coin: torch.Tensor
    hue_do: torch.Tensor
    hue: torch.Tensor
    sat_do: torch.Tensor
    sat: torch.Tensor


def draw_augment(batch: int, gen: torch.Generator) -> AugDraws:
    out = {}
    for f in fields(AugDraws):
        name = f.name
        if name.endswith(("_do", "_coin")):
            out[name] = torch.rand(batch, generator=gen)
        elif name == "r90_k":
            out[name] = torch.randint(0, 4, (batch,), generator=gen)
        elif name in ("tx", "ty"):
            out[name] = torch.rand(batch, generator=gen) * 0.25 - 0.125
        elif name in ("theta", "hue"):
            out[name] = torch.rand(batch, generator=gen) * (2 * math.pi) - math.pi
        else:
            out[name] = torch.randn((batch, 2) if name == "frac" else (batch,), generator=gen)
    return AugDraws(**out)


@dataclass
class GANDraws:
    flips: torch.Tensor
    z: torch.Tensor
    z_mix: torch.Tensor
    z2: torch.Tensor
    z2_mix: torch.Tensor
    cutoff: int
    cutoff2: int
    aug: list
    noise: dict
    zp: torch.Tensor | None = None
    pl_y: torch.Tensor | None = None


def draw_gan_step(h: GANHyper, batch: int, z_dim: int, resolution: int, seed: int, step: int,
                  device) -> GANDraws:
    """A step's random numbers for the whole (global) batch: host draws from
    a CPU generator seeded fold_seed(seed, step), device draws from one
    seeded fold_seed(seed, step, DEVICE_TAG)."""
    n_ws = SG.num_ws(resolution)
    host = torch.Generator().manual_seed(fold_seed(seed, step))
    dev = generator(fold_seed(seed, step, DEVICE_TAG), device)

    def cutoff():
        mix = float(torch.rand((), generator=host)) < h.mixing
        k = int(torch.randint(1, n_ws, (), generator=host))
        return k if mix else n_ws

    def z():
        return torch.randn((batch, z_dim), device=device, generator=dev)

    aug = [draw_augment(batch, host) for _ in range(3)]
    d = GANDraws(flips=torch.rand(batch, device=device, generator=dev) < 0.5, z=z(), z_mix=z(),
                 z2=z(), z2_mix=z(), cutoff=cutoff(), cutoff2=cutoff(), aug=aug,
                 noise={k: fold_seed(seed, step, t) for k, t in NOISE_TAGS.items()})
    if step % h.pl_interval == 0 and h.pl_weight > 0:
        d.zp = z()
        d.pl_y = torch.randn((batch, 3, resolution, resolution), device=device, generator=dev)
    return d


def _rot2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _spatial(d: AugDraws, p: float, H: int, W: int):
    flip = (d.flip_do < p) & (d.flip_coin < 0.5)
    k = torch.where(d.r90_do < p, d.r90_k, torch.zeros_like(d.r90_k))
    do = d.xint_do < p
    t_int = torch.stack([torch.where(do, torch.round(d.tx * W), 0.0),
                         torch.where(do, torch.round(d.ty * H), 0.0)], -1)
    s_iso = torch.where(d.iso_do < p, torch.exp2(d.iso * 0.2), 1.0)
    theta = torch.where(d.rot_do < p, d.theta, 0.0)
    s_aniso = torch.where(d.aniso_do < p, torch.exp2(d.aniso * 0.2), 1.0)
    frac = torch.where((d.frac_do < p)[:, None], d.frac * 0.125, 0.0)
    scale = torch.stack([s_aniso, torch.ones_like(s_aniso)], -1) * s_iso[:, None]
    A = torch.linalg.inv(_rot2(theta) * scale[:, None, :])
    v = -torch.einsum("bij,bj->bi", A, frac * torch.tensor([W, H], dtype=torch.float32)) - t_int
    r90 = torch.tensor([[0.0, -1.0], [1.0, 0.0]])
    rb = torch.stack([torch.eye(2), r90, r90 @ r90, r90 @ r90 @ r90])[k]
    A = torch.einsum("bij,bjk->bik", rb, A)
    v = torch.einsum("bij,bj->bi", rb, v)
    fvec = torch.stack([torch.where(flip, -1.0, 1.0), torch.ones(flip.shape)], -1)
    A, v = A * fvec[:, :, None], v * fvec
    ratio0 = A[:, 1, 0].abs() / (A[:, 0, 0].abs() + 1e-12)
    use_k1 = A[:, 1, 1].abs() / (A[:, 0, 1].abs() + 1e-12) < ratio0
    A = torch.where(use_k1[:, None, None],
                    torch.einsum("bij,jk->bik", A, torch.tensor([[0.0, 1.0], [-1.0, 0.0]])), A)
    skip = (((A - torch.eye(2)).abs().amax(dim=(1, 2)) < 1e-9) & (v.abs().amax(dim=1) < 1e-9)
            & ~use_k1)
    return A, v, use_k1, skip


def _color(d: AugDraws, p: float) -> torch.Tensor:
    B = d.bright.shape[0]
    eye = torch.eye(4)
    mats = eye.expand(B, 4, 4)
    m = eye.repeat(B, 1, 1)
    m[:, :3, 3] = torch.where(d.bright_do < p, d.bright * 0.2, 0.0)[:, None]
    mats = m @ mats
    c = torch.where(d.contrast_do < p, torch.exp2(d.contrast * 0.5), 1.0)
    mats = torch.diag_embed(torch.cat([c[:, None].expand(B, 3), torch.ones(B, 1)], 1)) @ mats
    v = torch.tensor([1.0, 1.0, 1.0, 0.0]) / math.sqrt(3.0)
    fl = (d.lumaflip_do < p) & (d.lumaflip_coin < 0.5)
    mats = torch.where(fl[:, None, None], (eye - 2.0 * torch.outer(v, v))[None], eye[None]) @ mats
    ang = torch.where(d.hue_do < p, d.hue, 0.0)
    k = v[:3]
    K = torch.tensor([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    m = eye.repeat(B, 1, 1)
    m[:, :3, :3] = (torch.eye(3) + torch.sin(ang)[:, None, None] * K
                    + (1 - torch.cos(ang))[:, None, None] * (K @ K))
    mats = m @ mats
    do = d.sat_do < p
    vv = torch.outer(v, v)
    m = vv[None] + (eye - vv)[None] * torch.where(do, torch.exp2(d.sat), 1.0)[:, None, None]
    return torch.where(do[:, None, None], m, eye[None]) @ mats


def _warp(images, A, v):
    """Bilinear sampling at src = A (p - c) + c + v, zero outside, as two
    passes (along y on the sheared lines, then along x)."""
    B, C, H, W = images.shape
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    a00, a01, a10, a11 = (A[:, i, j, None, None] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    vx, vy = v[:, 0, None, None], v[:, 1, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=images.device)
    ys = torch.arange(H, dtype=torch.float32, device=images.device)
    hat = lambda u: torch.clamp_min(1.0 - u.abs(), 0.0)  # noqa: E731
    syp = ((a10 / a00) * (xs[None, :, None] - cx - vx)
           + ((a00 * a11 - a01 * a10) / a00) * (ys[None, None, :] - cy) + cy + vy)
    tmp = torch.einsum("bxYy,bcyx->bcYx", hat(ys[None, None, None, :] - syp[..., None]), images)
    sx = a00 * (xs[None, None, :] - cx) + a01 * (ys[None, :, None] - cy) + cx + vx
    return torch.einsum("bYXx,bcYx->bcYX", hat(xs[None, None, None, :] - sx[..., None]), tmp)


def augment(images, p: float, d: AugDraws):
    """ADA's 'bgc' pipe (Karras et al., arXiv:2006.06676): the spatial
    transforms as one inverse affine map, the colour ones as one 4x4
    matrix, each transform hitting each image with probability p."""
    B, C, H, W = images.shape
    A, v, use_k1, skip = _spatial(d, p, H, W)
    x = images
    if not bool(skip.all()):
        dev = images.device
        warped = _warp(x, A.to(dev), v.to(dev))
        turned = torch.rot90(warped, 1, dims=(2, 3))
        warped = torch.where(use_k1.to(dev)[:, None, None, None], turned, warped)
        x = torch.where(skip.to(dev)[:, None, None, None], x, warped)
    mats = _color(d, p)
    if bool((mats == torch.eye(4)).all()):
        return x
    xh = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    return torch.einsum("bjhw,bij->bihw", xh, mats.to(x.device))[:, :3]


class GANReference:
    """StyleGAN2-ADA's alternating step: G with style mixing and, every
    pl_interval steps, the path-length penalty; D on the updated G's fakes
    and the reals, with lazy R1 every r1_interval; ADA's p controller; the
    tracked mean w; the generator EMA. Phase functions take a ``count``
    callback (phase name, function) so FLOPs can be counted by phase."""

    def __init__(self, G, D, g_ema, h: GANHyper, ada_p: float, ranks: int = 1):
        self.G, self.D, self.g_ema, self.h, self.ranks = G, D, g_ema, h, ranks
        g_ema.requires_grad_(False)

        def adam(params, interval):
            mb = interval / (interval + 1)
            return torch.optim.Adam(list(params), lr=h.lr * mb, betas=(0.0, h.beta2**mb), eps=1e-8)

        self.g_opt = adam(G.parameters(), h.pl_interval)
        self.d_opt = adam(D.parameters(), h.r1_interval)
        dev = next(G.parameters()).device
        self.w_avg = torch.zeros(G.mapping.fc0.weight.shape[0], device=dev)
        self.pl_mean = torch.zeros((), device=dev)
        self.ada_p = float(np.float32(ada_p))  # the program holds p in fp32
        self.ada_rt = torch.zeros((), device=dev)
        self.step_i = 0

    def named_params(self) -> dict[str, torch.Tensor]:
        return {**{f"G.{n}": p for n, p in self.G.named_parameters()},
                **{f"D.{n}": p for n, p in self.D.named_parameters()}}

    def ema_params(self) -> dict[str, torch.Tensor]:
        return {f"G_ema.{n}": p for n, p in self.g_ema.named_parameters()}

    def first_grads(self) -> dict[str, torch.Tensor]:
        by_p = {}
        for opt in (self.g_opt, self.d_opt):
            for p in opt.param_groups[0]["params"]:
                by_p[p] = opt.state[p]["exp_avg"]  # beta1 = 0: the gradient itself
        return {n: by_p[p] for n, p in self.named_params().items()}

    def _ws(self, z, z_mix, cutoff):
        ws = self.G.mapping(z)
        if cutoff >= ws.shape[1]:
            return ws, ws
        return torch.cat([ws[:, :cutoff], self.G.mapping(z_mix)[:, cutoff:]], dim=1), ws

    def _synth(self, ws, noise_seed):
        """On ``ranks`` > 1 cards each rank's rows draw their synthesis noise
        from a seed of their own: fold_seed(seed, RANK_TAG, rank)."""
        if self.ranks == 1:
            return self.G.synthesis(ws, "random", generator(noise_seed, ws.device))
        return torch.cat([self.G.synthesis(part, "random",
                                           generator(fold_seed(noise_seed, RANK_TAG, r), ws.device))
                          for r, part in enumerate(ws.chunk(self.ranks))])

    def _d(self, images, draws):
        return self.D(augment(images, self.ada_p, draws))

    def step(self, images_u8, d: GANDraws, count=None) -> dict[str, float]:
        h, i = self.h, self.step_i
        count = count or (lambda name, fn: fn())
        x = images_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        x = torch.where(d.flips[:, None, None, None], x.flip(3), x)
        B = x.shape[0]
        g_list, d_list = list(self.G.parameters()), list(self.D.parameters())

        def g_main():
            ws_used, ws = self._ws(d.z, d.z_mix, d.cutoff)
            logits = self._d(self._synth(ws_used, d.noise["g"]), d.aug[0])
            loss = F.softplus(-logits).mean()
            grads = torch.autograd.grad(loss, g_list, materialize_grads=True)
            return loss, grads, ws[:, 0].detach().mean(0)

        g_loss, g_grads, ws_mean = count("g_main", g_main)
        pl_len, new_pl_mean = torch.zeros((), device=x.device), self.pl_mean
        if i % h.pl_interval == 0 and h.pl_weight > 0:
            def g_pl():
                ws = self.G.mapping(d.zp)
                img = self._synth(ws, d.noise["ppl"])
                proj = (img * (d.pl_y / math.sqrt(img.shape[2] * img.shape[3]))).sum()
                (pg,) = torch.autograd.grad(proj, ws, create_graph=True)
                lengths = pg.square().sum(dim=2).mean(dim=1).sqrt()
                batch_mean = lengths.mean()
                new_mean = self.pl_mean + h.pl_decay * (batch_mean - self.pl_mean)
                pen = (lengths - new_mean).square().mean() * h.pl_weight * h.pl_interval
                grads = torch.autograd.grad(pen, g_list, materialize_grads=True)
                return grads, batch_mean, new_mean

            pl_grads, pl_len, new_pl_mean = count("g_pl", g_pl)
            g_grads = [a + b for a, b in zip(g_grads, pl_grads)]
            pl_len, new_pl_mean = pl_len.detach(), new_pl_mean.detach()
        _adam(self.g_opt, g_list, g_grads)

        do_r1 = i % h.r1_interval == 0

        def d_main():
            with torch.no_grad():
                fake = self._synth(self._ws(d.z2, d.z2_mix, d.cutoff2)[0], d.noise["d"])
            fake_logits = self._d(fake, d.aug[1])
            real = x.detach().requires_grad_(do_r1)
            real_logits = self._d(real, d.aug[2])
            loss = F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
            r1 = torch.zeros((), device=x.device)
            if do_r1:
                (gr,) = torch.autograd.grad(real_logits.sum(), real, create_graph=True)
                r1 = gr.square().sum(dim=(1, 2, 3)).mean()
                loss = loss + (h.r1_gamma / 2) * r1 * h.r1_interval
            return loss, torch.autograd.grad(loss, d_list, materialize_grads=True), r1.detach(), \
                torch.sign(real_logits.detach()).mean()

        d_loss, d_grads, r1, rt_batch = count("d_r1" if do_r1 else "d_main", d_main)
        _adam(self.d_opt, d_list, d_grads)
        with torch.no_grad():
            self.ada_rt = self.ada_rt + rt_batch
            if (i + 1) % h.ada_interval == 0:
                rt = float(self.ada_rt) / h.ada_interval
                step = (B * h.ada_interval) / (h.ada_kimg * 1000)
                adjust = float(np.sign(rt - h.ada_target)) * step
                self.ada_p = float(np.clip(np.float32(self.ada_p) + np.float32(adjust), 0.0, 1.0))
                self.ada_rt = torch.zeros_like(self.ada_rt)
            self.w_avg = ws_mean * (1 - h.w_avg_beta) + self.w_avg * h.w_avg_beta
            beta = float(np.float32(0.5) ** (np.float32(B) / np.float32(h.ema_kimg * 1000.0)))
            ema = list(self.g_ema.parameters())
            torch._foreach_mul_(ema, beta)
            torch._foreach_add_(ema, g_list, alpha=float(np.float32(1.0) - np.float32(beta)))
            self.pl_mean = new_pl_mean
        self.step_i = i + 1
        vals = torch.stack([g_loss.detach(), d_loss.detach(), r1, pl_len]).double().cpu().tolist()
        return {"g_loss": vals[0], "d_loss": vals[1], "r1": vals[2], "pl_lengths": vals[3],
                "ada_p": self.ada_p}


@torch.no_grad()
def _adam(opt, params, grads):
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


# --------------------------------- serving ---------------------------------- #


@torch.no_grad()
def reconstruct(nets: dict, images_u8: torch.Tensor) -> dict[str, torch.Tensor]:
    """f -> Psi -> Theta and G(Phi, Phi') with the constant noise: the
    classifier's and the explainer's logits and the reconstruction in [0,
    1] (before the endpoint's rounding to u8)."""
    logits, hidden = nets["classifier"](VC.preprocess(images_u8))
    phi, phi_prime = nets["concept_extractor"](hidden)
    expl = nets["explainer"](phi)
    recon = nets["gan"].synthesis(nets["gan"].mapping(phi, phi_prime), "const")
    return {"logits": logits, "expl_logits": expl,
            "image01": VC.denormalize(recon).clamp(0.0, 1.0).permute(0, 2, 3, 1)}
