"""The baselines' standard ResNet-50 and the stage-A' refit step in the
PyTorch port against the JAX package, on the CPU in fp32.

Weights are drawn by the port (``resnet50_init``, then random BatchNorm
affines and statistics so that the eval-mode fold is not an identity) and
go to JAX through its ``convert_torch_resnet``; ``from_jax_resnet`` must
give them back bit for bit. Tolerances:

- eval mode (features, logits): 1e-5 of the largest value, summation order
  only;
- train-mode BatchNorm alone: 1e-5 against JAX's ``bn_train`` and against
  ``torch.nn.BatchNorm2d.train()``;
- the train-mode network at 64 px: features within 1e-3 and running
  statistics within 1e-3 of the largest value; one refit step's loss within
  2e-4 relative, and its weight updates within 10% (L2, per tensor) and a
  cosine of 0.999 over all of them. The train-mode net is chaotic at this
  size (batch statistics over 16 values in layer4): the port's own fp32
  gradients differ from its fp64 ones by about 3% (L2) in every tensor, so
  tighter bounds would test rounding, not the port.
"""

import numpy as np
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hgr_tpu.baselines import features as jfeatures  # noqa: E402
from hgr_tpu.baselines import refit as jrefit  # noqa: E402
from hgr_tpu.models import resnet_std as jrs  # noqa: E402
from hgr_tpu_torch.baselines import features, refit  # noqa: E402
from hgr_tpu_torch.baselines.materials import inject_fc  # noqa: E402
from hgr_tpu_torch.models import resnet_std as rs  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_resnet  # noqa: E402


def _model(seed=0, num_classes=5):
    """A port ResNet-50 with random BatchNorm affines and statistics, and
    the same weights as a JAX tree."""
    model = rs.resnet50_init(torch.Generator().manual_seed(seed), num_classes=num_classes)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, rs.BatchNorm):
                n = m.weight.shape[0]
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 1.5)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
    return model, jrs.convert_torch_resnet(model.state_dict())


def _close(got, want, rel, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, f"{msg}: {err:.3e} > {rel:g} x {scale:.3e}"


def _jax_name(path):
    """``layer2.0.downsample.1`` -> JAX's ``layer2/0/downsample/bn``."""
    return path.replace("downsample.1", "downsample/bn").replace(".", "/")


def test_resnet50_matches_jax():
    model, jp = _model()
    sd = model.state_dict()
    back = from_jax_resnet(jax.tree.map(np.asarray, jp))
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    loaded = rs.convert_torch_resnet({**sd, "bn1.num_batches_tracked": torch.tensor(3)})
    assert all(torch.equal(loaded.state_dict()[k], sd[k]) for k in sd)
    headless = rs.convert_torch_resnet({k: v for k, v in sd.items() if not k.startswith("fc.")})
    assert headless.fc is None

    rng = np.random.default_rng(1)
    # the eval transform's crop: 256 -> 224 and the half-to-even 227 -> 224
    for r in (256, 227):
        u8 = rng.integers(0, 256, (2, r, r, 3), dtype=np.uint8)
        np.testing.assert_allclose(features.preprocess_for_backbone(torch.from_numpy(u8), 224),
                                   jfeatures.preprocess_for_backbone(jnp.asarray(u8), 224),
                                   rtol=1e-6, atol=1e-6)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    want = jfeatures.make_featurizer(jp, crop=56, dtype=jnp.float32)(jnp.asarray(images))
    _close(features.make_featurizer(model, crop=56)(images), want, 1e-5, "features")
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    _close(rs.resnet50_logits(model, torch.from_numpy(x), torch.float32),
           jax.jit(lambda p, v: jrs.resnet50_logits(p, v, jnp.float32))(jp, jnp.asarray(x)),
           1e-5, "logits")

    # train-mode BatchNorm alone: JAX's bn_train and torch's BatchNorm2d
    bn = model.layer1[0].bn2
    y = rng.standard_normal((4, 64, 6, 6)).astype(np.float32)
    out, st = rs.bn_train(bn, torch.from_numpy(y))
    jbn = {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy(),
           "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    jout, jst = jrs.bn_train(jbn, jnp.asarray(y.transpose(0, 2, 3, 1)))
    _close(out, np.asarray(jout).transpose(0, 3, 1, 2), 1e-5, "bn_train")
    ref = torch.nn.BatchNorm2d(64, momentum=0.1).train()
    ref.load_state_dict({k: v for k, v in bn.state_dict().items()}, strict=False)
    with torch.no_grad():
        _close(out, ref(torch.from_numpy(y)), 1e-5, "BatchNorm2d.train()")
    for k, t in (("mean", ref.running_mean), ("var", ref.running_var)):
        _close(st[k], jst[k], 1e-5, k)
        _close(st[k], t, 1e-5, k)

    # the whole net in train mode: features and every running statistic
    feats, stats = rs.resnet50_features_train(model, torch.from_numpy(x), torch.float32)
    jfeats, jstats = jax.jit(lambda p, v: jrs.resnet50_features_train(p, v, jnp.float32))(
        jp, jnp.asarray(x))
    _close(feats, jfeats, 1e-3, "train-mode features")
    assert len(stats) == len(jstats) == 53
    for path, upd in stats.items():
        for k in ("mean", "var"):
            _close(upd[k], jstats[_jax_name(path)][k], 1e-3, f"{path} {k}")
    before = model.bn1.running_var.clone()
    rs.apply_bn_stats(model, stats)
    assert torch.equal(model.layer2[0].downsample[1].running_mean,
                       stats["layer2.0.downsample.1"]["mean"])
    assert not torch.equal(model.bn1.running_var, before)


def test_refit_step_matches_jax():
    """One stage-A' step (SGD with momentum, cross-entropy under the frozen
    head of predicted rows with a bias column, train-mode BatchNorm, a
    padded row, JAX's own flip draws) against ``make_refit_step``; and the
    fc helpers against JAX's."""
    model, jp = _model(seed=2)
    rng = np.random.default_rng(3)
    pred = rng.normal(0, 0.05, (5, 2049)).astype(np.float32)
    for rows in (pred, pred[:, :2048]):
        got, want = refit.fc_from_pred(rows), jrefit.fc_from_pred(rows)
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    labels = np.array([0, 3, 1, 4], np.int32)
    valid = np.array([True, True, True, False])
    key = jax.random.PRNGKey(0)
    flip = np.array(jax.random.bernoulli(key, shape=(4,)))  # the draw make_refit_step makes
    assert flip.any() and not flip.all()

    lr = 1e-2
    tx = optax.sgd(lr, momentum=0.9)
    base = {k: v for k, v in jp.items() if k != "fc"}
    fc = jrefit.fc_from_pred(pred)
    step = jrefit.make_refit_step(tx, 56, dtype=jnp.float32)
    jbase, _, jloss, jacc = step(base, tx.init(base), fc, jnp.asarray(images),
                                 jnp.asarray(labels), jnp.asarray(valid), key)
    want = from_jax_resnet(jax.tree.map(np.asarray, {**jbase, "fc": fc}))

    inject_fc(model, pred)
    old = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.base_parameters(), lr=lr, momentum=0.9)
    loss, acc = refit.make_refit_step(opt, 56)(model, torch.from_numpy(images),
                                               torch.from_numpy(labels).long(),
                                               torch.from_numpy(valid), torch.from_numpy(flip))
    assert abs(float(loss) - float(jloss)) <= 2e-4 * abs(float(jloss))
    assert float(acc) == float(jacc)
    got = model.state_dict()
    assert torch.equal(got["fc.weight"], old["fc.weight"]), "the head must stay frozen"
    np.testing.assert_array_equal(got["fc.bias"].numpy(), pred[:, -1])
    dp, dj = [], []
    for k in want:
        if "running" in k:
            _close(got[k], want[k], 1e-3, k)
        elif not k.startswith("fc."):
            a, b = (got[k] - old[k]).double(), (want[k] - old[k]).double()
            assert float((a - b).norm()) <= 0.1 * float(b.norm()), k
            dp.append(a.flatten())
            dj.append(b.flatten())
    cos = torch.nn.functional.cosine_similarity(torch.cat(dp), torch.cat(dj), dim=0)
    assert float(cos) >= 0.999, float(cos)
