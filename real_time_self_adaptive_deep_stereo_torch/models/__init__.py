"""Model factory (counterpart of the JAX package's ``models/__init__.py``)."""

from real_time_self_adaptive_deep_stereo_torch.models.dispnet import DispNet
from real_time_self_adaptive_deep_stereo_torch.models.madnet import MADNet

STEREO_FACTORY = {"MADNet": MADNet, "Dispnet": DispNet}


def get_stereo_net(name: str, **kwargs):
    """Instantiate a stereo model by name ('MADNet' or 'Dispnet'). Runs on
    ``cuda`` unless ``device='cpu'`` is passed."""
    if name not in STEREO_FACTORY:
        raise KeyError(f"Unrecognized network name {name!r}; choose from {list(STEREO_FACTORY)}")
    return STEREO_FACTORY[name](**kwargs)


__all__ = ["STEREO_FACTORY", "get_stereo_net", "MADNet", "DispNet"]
