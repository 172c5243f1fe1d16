"""FREE baseline: WGAN-GP + VAE feature generator with feature refinement
(port of ``hgr_tpu/baselines/free.py``).

The reference's ``baseline/FREE/`` (``model.py``, ``train_free.py``,
``center_loss.py``, ``classifier.py``): a conditional VAE-GAN over frozen
backbone features, conditioned on class embeddings:

- Encoder(feat, att) -> (mu, logvar); Generator(z, att) -> sigmoid(feat);
  Discriminator(feat, att) -> critic score;
- FR, the feature-refinement net: feat -> hidden -> (mu, sigma) -> sigmoid
  reconstruction of the attribute, with a critic and a seen-class head;
- losses: the WGAN-GP critic (the gradient penalty is a gradient inside a
  loss: ``torch.autograd.grad(..., create_graph=True)``), VAE = sum-BCE +
  KLD, WeightedL1, TripCenterLoss with a margin on FR's mu;
- synthesis: features for every class, then a softmax classifier.

The random draws (the generator's z, FR's eps, the penalty's alpha, the
other labels, the classifier's init and permutations) are arguments, so
that a test can hand in the very draws the JAX functions make; the
``draw_*`` helpers make them from a ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .optim import Adam, from_numpy, grads, tree_leaves


@dataclass
class FREEConfig:
    res_size: int = 2048     # feature dim (frozen ResNet50)
    att_size: int = 1024     # attribute / class-embedding dim
    latent_size: int = 1024
    ngh: int = 4096
    ndh: int = 4096
    nclass_seen: int = 983
    lr: float = 1e-4
    dec_lr: float = 1e-4
    beta1: float = 0.5
    critic_iter: int = 5
    lambda1: float = 10.0    # GP weight (adapted during training)
    gammaD: float = 10.0
    gammaG: float = 10.0
    recons_weight: float = 0.1
    center_weight: float = 0.5
    center_margin: float = 200.0
    incenter_weight: float = 0.8
    syn_num: int = 300       # synthesized features per unseen class


def _linear(g: torch.Generator, a: int, b: int) -> Dict:
    # the reference's weights_init: N(0, 0.02) weights, zero bias
    return {"w": 0.02 * torch.randn((a, b), generator=g, device=g.device),
            "b": torch.zeros(b, device=g.device)}


def free_init(generator: torch.Generator, cfg: FREEConfig, device=None) -> Dict:
    g, c = generator, cfg
    params = {
        "E": {"fc1": _linear(g, c.res_size + c.latent_size, c.ngh),
              "fc3": _linear(g, c.ngh, c.latent_size * 2),
              "mu": _linear(g, c.latent_size * 2, c.latent_size),
              "logvar": _linear(g, c.latent_size * 2, c.latent_size)},
        "G": {"fc1": _linear(g, c.latent_size * 2, c.ngh),
              "fc3": _linear(g, c.ngh, c.res_size)},
        "D": {"fc1": _linear(g, c.res_size + c.att_size, c.ndh),
              "fc2": _linear(g, c.ndh, 1)},
        "FR": {"fc1": _linear(g, c.res_size, c.ngh),
               "fc3": _linear(g, c.ngh, c.att_size * 2),
               "disc": _linear(g, c.att_size, 1),
               "cls": _linear(g, c.att_size, c.nclass_seen)},
        "centers": torch.randn((c.nclass_seen, c.att_size), generator=g, device=g.device),
    }
    return from_numpy(params, device)


def from_jax(params, device=None) -> Dict:
    """A JAX ``free_init`` tree (as numpy) -> the port's (same structure)."""
    return from_numpy(params, device)


def _apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def encoder(pE: Dict, feat: torch.Tensor, att: torch.Tensor):
    x = _lrelu(_apply(pE["fc1"], torch.cat([feat, att], -1)))
    x = _lrelu(_apply(pE["fc3"], x))
    return _apply(pE["mu"], x), _apply(pE["logvar"], x)


def generator(pG: Dict, z: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    x = _lrelu(_apply(pG["fc1"], torch.cat([z, att], -1)))
    return torch.sigmoid(_apply(pG["fc3"], x))


def discriminator(pD: Dict, feat: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    x = torch.cat([feat, att], -1)
    return _apply(pD["fc2"], _lrelu(_apply(pD["fc1"], x)))[:, 0]


def fr_forward(pFR: Dict, feat: torch.Tensor, eps: torch.Tensor, att_size: int,
               train_G: bool = False):
    """-> (mu, std, critic, class_logprobs, recon) (``model.py:104-127``);
    ``eps`` [B, att_size] is the reparameterisation's normal draw."""
    h = _lrelu(_apply(pFR["fc1"], feat))
    lat = _apply(pFR["fc3"], h)
    mu, std = lat[:, :att_size], torch.sigmoid(lat[:, att_size:])
    enc = eps * std + mu
    critic = _apply(pFR["disc"], mu if train_G else enc)[:, 0]
    logp = torch.log_softmax(_apply(pFR["cls"], mu), -1)
    return mu, std, critic, logp, torch.sigmoid(enc)


def vae_loss(recon, x, mu, logvar) -> torch.Tensor:
    """sum-BCE + KLD, batch-averaged (``train_free.py:83-88``)."""
    eps = 1e-12
    bce = -(x * torch.log(recon + eps) + (1 - x) * torch.log(1 - recon + eps)).sum()
    kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
    return (bce + kld) / x.shape[0]


def weighted_l1(pred, gt) -> torch.Tensor:
    """(``train_free.py:96-100``)."""
    wt = (pred - gt) ** 2
    wt = wt / torch.sqrt(wt.sum(1, keepdim=True) + 1e-12)
    return (wt * torch.abs(pred - gt)).sum() / pred.shape[0]


def trip_center_loss(centers, x, labels, other_labels, margin, incenter_weight):
    """TripCenterLoss_margin (``center_loss.py:16-45``)."""
    d = (x ** 2).sum(1, keepdim=True) + (centers ** 2).sum(1)[None, :] - 2 * x @ centers.T
    own = d.gather(1, labels.long()[:, None])[:, 0]
    other = d.gather(1, other_labels.long()[:, None])[:, 0]
    return torch.clamp_min(margin + incenter_weight * own - (1 - incenter_weight) * other,
                           0.0).sum() / x.shape[0]


def gradient_penalty(critic_fn: Callable, alpha: torch.Tensor, real: torch.Tensor,
                     fake: torch.Tensor) -> torch.Tensor:
    """WGAN-GP on interpolates (``train_free.py:111-127``); ``alpha`` [B, 1]
    is the uniform draw. The gradient keeps its graph, so the penalty's own
    gradient reaches the critic's weights."""
    inter = (alpha * real + (1 - alpha) * fake).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(critic_fn(inter).sum(), inter, create_graph=True)
    norms = torch.sqrt((g ** 2).sum(1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def other_labels(labels: torch.Tensor, num_classes: int, offsets: torch.Tensor) -> torch.Tensor:
    """Different-class labels (``center_loss.py:9-13``): ``labels`` plus the
    uniform draws ``offsets`` in [0, num_classes), wrapped."""
    out = labels + offsets
    return torch.where(out >= num_classes, out - num_classes, out)


def draw_d(g: torch.Generator, cfg: FREEConfig, batch: int,
           num_classes: int) -> Dict[str, torch.Tensor]:
    """The draws of one ``d_step``, on ``g``'s device: the generator's ``z``,
    FR's ``eps``, the penalty's ``alpha`` and the other labels' ``offsets``."""
    dev = g.device
    return {"z": torch.randn((batch, cfg.latent_size), generator=g, device=dev),
            "eps": torch.randn((batch, cfg.att_size), generator=g, device=dev),
            "alpha": torch.rand((batch, 1), generator=g, device=dev),
            "offsets": torch.randint(0, num_classes, (batch,), generator=g, device=dev)}


def draw_g(g: torch.Generator, cfg: FREEConfig, batch: int) -> Dict[str, torch.Tensor]:
    """The draws of one ``g_step``, on ``g``'s device: the encoder's ``z``
    noise and FR's ``eps``."""
    return {"z": torch.randn((batch, cfg.latent_size), generator=g, device=g.device),
            "eps": torch.randn((batch, cfg.att_size), generator=g, device=g.device)}


def make_free_steps(cfg: FREEConfig):
    """(D + FR + centers) and (E + G) update steps, each optimizer
    ``optax.adam(b1=0.5)`` (``free.py:174-260``); -> ``(d_step, g_step,
    init_opts)``. Both steps update ``params`` in place."""
    txD = Adam(cfg.lr, b1=cfg.beta1)
    txFR = Adam(cfg.dec_lr, b1=cfg.beta1)
    txC = Adam(cfg.lr, b1=cfg.beta1)
    txEG = Adam(cfg.lr, b1=cfg.beta1)

    def d_step(params, optD, optFR, optC, feat, att, labels, others, lambda1, draws):
        """-> (params, optD, optFR, optC, d_cost, wass, gp). D, FR and the
        centers all take gradients at the same parameters; the fake
        features carry no gradient to G."""
        with torch.no_grad():
            fake = generator(params["G"], draws["z"], att)
        mu, _, _, _, recon = fr_forward(params["FR"], feat, draws["eps"], cfg.att_size)
        frl = (trip_center_loss(params["centers"], mu, labels, others, cfg.center_margin,
                                cfg.incenter_weight) * cfg.center_weight
               + cfg.recons_weight * weighted_l1(recon, att))
        fr_leaves = tree_leaves(params["FR"])
        g_frc = grads(frl, fr_leaves + [params["centers"]])

        pD = params["D"]
        real_score = discriminator(pD, feat, att).mean()
        fake_score = discriminator(pD, fake, att).mean()
        gp = gradient_penalty(lambda z: discriminator(pD, z, att), draws["alpha"], feat, fake)
        d_cost = cfg.gammaD * (fake_score - real_score + lambda1 * gp)
        gD = grads(d_cost, tree_leaves(pD))

        txD.apply(pD, optD, gD)
        txFR.apply(params["FR"], optFR, g_frc[:-1])
        txC.apply(params["centers"], optC, g_frc[-1:])
        return (params, optD, optFR, optC, d_cost.detach(),
                (real_score - fake_score).detach(), gp.detach())

    def g_step(params, optEG, feat, att, draws):
        """-> (params, optEG, loss): E and G take the gradient; D and FR
        pass it through unchanged."""
        mu, logvar = encoder(params["E"], feat, att)
        z = draws["z"] * torch.exp(0.5 * logvar) + mu
        recon = generator(params["G"], z, att)
        vae = vae_loss(recon, feat, mu, logvar)
        critic = discriminator(params["D"], recon, att).mean()
        _, _, _, _, fr_recon = fr_forward(params["FR"], recon, draws["eps"], cfg.att_size,
                                          train_G=True)
        loss = vae - cfg.gammaG * critic + cfg.recons_weight * weighted_l1(fr_recon, att)
        eg = [params["E"], params["G"]]
        txEG.apply(eg, optEG, grads(loss, tree_leaves(eg)))
        return params, optEG, loss.detach()

    def init_opts(params):
        return (txD.init(params["D"]), txFR.init(params["FR"]), txC.init(params["centers"]),
                txEG.init([params["E"], params["G"]]))

    return d_step, g_step, init_opts


@torch.no_grad()
def synthesize_features(params, cfg: FREEConfig, attrs: torch.Tensor, num_per_class: int,
                        z: torch.Tensor, chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_per_class`` generated features for each class of ``attrs`` from
    the draws ``z`` [C, num_per_class, latent] (``classifier.py`` usage).
    The generator runs over ``chunk`` rows at a time: rows are independent,
    and at 18,278 classes x 32 its hidden layer alone would be 19 GB."""
    C = attrs.shape[0]
    att = attrs[:, None, :].expand(C, num_per_class, cfg.att_size).reshape(C * num_per_class, -1)
    z = z.reshape(C * num_per_class, -1)
    feats = torch.cat([generator(params["G"], z[i: i + chunk], att[i: i + chunk])
                       for i in range(0, z.shape[0], chunk)])
    labels = torch.arange(C, device=attrs.device).repeat_interleave(num_per_class)
    return feats, labels


def train_softmax_classifier(
    feats: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    lr: float = 1e-3,
    epochs: int = 10,
    batch: int = 512,
    generator: Optional[torch.Generator] = None,
    init: Optional[Dict] = None,
    perms: Optional[List[torch.Tensor]] = None,
) -> Dict:
    """Softmax classifier over (synthesized) features, ``optax.adam(lr,
    b1=0.5)`` on the mean cross-entropy, the remainder of each epoch dropped
    (``free.py:279-314``). ``init`` (N(0, 0.02) weights) and the epochs'
    ``perms`` are drawn from ``generator`` unless given."""
    n, dim = feats.shape
    if init is None:
        init = _linear(generator, dim, num_classes)
    params = {k: v.detach().to(feats.device, copy=True).requires_grad_(True)
              for k, v in init.items()}
    tx = Adam(lr, b1=0.5)
    opt = tx.init(params)
    for e in range(epochs):
        perm = (perms[e] if perms is not None
                else torch.randperm(n, generator=generator, device=generator.device))
        perm = perm.to(feats.device)
        for s in range(0, n - batch + 1, batch):
            idx = perm[s: s + batch]
            loss = F.cross_entropy(_apply(params, feats[idx]), labels[idx].long())
            tx.apply(params, opt, grads(loss, tree_leaves(params)))
    return {k: v.detach() for k, v in params.items()}
