"""Faults planted in the program's timed path, to see ``correct`` come out
false, by name; a cell's limits file lists the kinds it can have. A test
plants them at TEST sizes on the CPU; ``scripts/faults.py`` at a cell's
own size on the card."""


def plant(setattr_, fault: str) -> None:
    """Plant ``fault`` in the program's timed path; ``setattr_`` is
    ``monkeypatch.setattr`` in a test, ``setattr`` in a script."""
    import torch
    from hgr_tpu_torch import tree_model
    from hgr_tpu_torch.models import clip

    if fault == "half_batch":  # half the batch left out of the metrics
        orig = tree_model.TreeModel.metrics_sorted

        def half(self, bank, feats, target, valid=None):
            v = torch.ones(feats.shape[0], dtype=torch.bool, device=feats.device)
            v[feats.shape[0] // 2:] = False
            return orig(self, bank, feats, target, v)

        setattr_(tree_model.TreeModel, "metrics_sorted", half)
    elif fault == "features_altered":  # an answer altered where it is produced
        orig = clip.encode_image
        setattr_(clip, "encode_image", lambda m, x, **kw: orig(m, x, **kw).roll(1, dims=1))
    elif fault == "stale_bank":  # a refresh that returns its state unchanged
        orig = tree_model.TreeModel.update_classifier
        first = {}

        def stale(self, *a, **kw):
            if "bank" not in first:
                first["bank"] = orig(self, *a, **kw)
            return first["bank"]

        setattr_(tree_model.TreeModel, "update_classifier", stale)
    elif fault == "state_unchanged":  # a step that returns its state unchanged
        from hgr_tpu_torch.train import trainer

        def frozen(self, params, st):
            for t in self.groups(params)["clip"] + self.groups(params)["lw"]:
                t.grad = None

        setattr_(trainer.Optimizer, "update", frozen)
    elif fault == "half_batch_train":  # half the batch left out, the mean over the rest
        from hgr_tpu_torch.train import om

        orig = om.om_loss
        setattr_(om, "om_loss", lambda params, images, *a, **kw:
                 orig(params, images[: images.shape[0] // 2], *a, **kw))
    else:
        raise KeyError(f"no fault {fault!r}")
