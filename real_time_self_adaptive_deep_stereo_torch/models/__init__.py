"""Model factory (counterpart of the JAX package's ``models/__init__.py``)."""

from real_time_self_adaptive_deep_stereo_torch.models.madnet import MADNet

STEREO_FACTORY = {"MADNet": MADNet}


def get_stereo_net(name: str, **kwargs):
    """Instantiate a stereo model by name. Runs on ``cuda`` unless
    ``device='cpu'`` is passed."""
    if name == "Dispnet":
        raise NotImplementedError(
            "DispNet is not ported yet: ROADMAP.md, modules to port, item 10"
        )
    if name not in STEREO_FACTORY:
        raise KeyError(f"Unrecognized network name {name!r}; choose from {list(STEREO_FACTORY)}")
    return STEREO_FACTORY[name](**kwargs)


__all__ = ["STEREO_FACTORY", "get_stereo_net", "MADNet"]
