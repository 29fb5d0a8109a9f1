"""A port config's fields as the JAX package's config has them: the port's
own settings (a head width apart from d_model / n_heads, the RoPE base,
full layers among windowed ones, YaRN) must hold
their defaults, which are the JAX model, and are then left out."""

import dataclasses

PORT_ONLY = {"head_dim": None, "rope_theta": 10000.0, "full_every": None,
             "rope_scaling": None}


def jax_fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    for key, default in PORT_ONLY.items():
        if key in d:
            assert d.pop(key) == default, (key, cfg)
    return d
