"""CLIP encoders of the port: ``clip`` (container, init, encode functions),
``resnet``, ``vit``, ``transformer``, ``text_encoder``, ``layers`` and
``convert``.

Import the submodules directly; this package module imports nothing, so
that ``ops.attention`` can take its plain twin from ``models.layers``
without an import cycle.
"""
