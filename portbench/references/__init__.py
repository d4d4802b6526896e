"""The plain reference of each block kind of a language model, one file a
kind (`lm_reference.kind_module`): `leaves(cfg)` and `apply(ctx, p, h)`."""
