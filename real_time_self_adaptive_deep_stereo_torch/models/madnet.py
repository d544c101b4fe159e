"""MADNet as a PyTorch module.

Port of ``real_time_self_adaptive_deep_stereo_tpu/models/madnet.py``
with the same architecture, hyper-parameters and defaults:

* a 6-level siamese pyramid conv1..conv12 (stride 2 on odd convs,
  leaky-relu 0.2), run as one B=2 stack for the left and right images;
* per scale k = 6..2: warp of the right features by the upsampled
  coarser disparity (k < 6), a 1-D correlation over ±radius_d, and a
  6-conv estimator on [left feats, corr, upsampled disparity];
* an optional dilated context net on scale 2;
* outputs ``relu(-20*V)`` resized to the padded input and centre-cropped.

Parameter groups keep the JAX top-level keys, which are the MAD blocks:
``pyramid.convN``, ``estimator_K.dispJ``, ``context.contextJ``, each with
``weight`` (OIHW) and ``bias``. Inside it works in NCHW; at the boundary
it takes NHWC frames and returns NHWC ([B,H,W,1]) disparities, as the JAX
model does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from real_time_self_adaptive_deep_stereo_torch.ops import (
    conv2d,
    correlation,
    crop_or_pad,
    dilated_conv2d,
    init_conv,
    leaky_relu,
    pad_image,
    padded_shape,
    resize_bilinear,
    warp_features_by_mode,
)
from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

__all__ = ["MADNet"]

_act = leaky_relu(0.2)


def _linear(x):
    return x


# (stride, in_c, out_c) for pyramid conv1..conv12
_PYRAMID_SPEC = [
    (2, 3, 16), (1, 16, 16), (2, 16, 32), (1, 32, 32), (2, 32, 64), (1, 64, 64),
    (2, 64, 96), (1, 96, 96), (2, 96, 128), (1, 128, 128), (2, 128, 192), (1, 192, 192),
]

# scale k -> (pyramid level index [1..6], feature channels, downscale factor)
_SCALE_FEATS = {6: (6, 192, 64), 5: (5, 128, 32), 4: (4, 96, 16), 3: (3, 64, 8), 2: (2, 32, 4)}

_EST_WIDTHS = [128, 128, 96, 64, 32, 1]
_CTX_RATES = [1, 2, 4, 8, 16, 1, 1]
_CTX_WIDTHS = [128, 128, 128, 96, 64, 32, 1]


class _Conv(nn.Module):
    """3x3 conv with TF SAME padding, a bias and a fixed activation."""

    def __init__(
        self,
        generator: torch.Generator,
        cin: int,
        cout: int,
        stride: int = 1,
        rate: int = 1,
        activation: Callable = _act,
    ):
        super().__init__()
        w, b = init_conv(generator, (cout, cin, 3, 3))
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        self.stride, self.rate, self.activation = stride, rate, activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate != 1:
            return dilated_conv2d(x, self.weight, self.bias, self.rate, self.activation)
        return conv2d(x, self.weight, self.bias, self.stride, self.activation)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    # contiguous NCHW: a permuted view keeps channels-last strides, which
    # cuDNN would carry through every conv to the kernels, which take NCHW
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MADNet(nn.Module):
    """MADNet. Runs on ``cuda`` unless ``device='cpu'``; weights are
    Xavier-uniform from ``seed`` (load real ones with ``load_state_dict``
    and :func:`..utils.checkpoint.params_from_jax`)."""

    name = "MADNet"

    def __init__(
        self,
        warping: bool = True,
        context_net: bool = True,
        radius_d: int = 2,
        stride: int = 1,
        bulkhead: bool = False,
        corr_mode: str = "auto",
        warp_mode: str = "auto",
        warp_max_disp: int = 192,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.warping = warping
        self.context_net = context_net
        self.radius_d = radius_d
        self.stride = stride
        self.bulkhead = bulkhead
        self.corr_mode = corr_mode
        self.warp_mode = warp_mode
        self.warp_max_disp = warp_max_disp
        device = resolve_device(device)

        gen = torch.Generator().manual_seed(seed)
        n_corr = len(range(-radius_d, radius_d + 1, stride))
        self.pyramid = nn.ModuleDict(
            {
                f"conv{i}": _Conv(gen, cin, cout, stride=s)
                for i, (s, cin, cout) in enumerate(_PYRAMID_SPEC, start=1)
            }
        )
        for k in (6, 5, 4, 3, 2):
            prev = _SCALE_FEATS[k][1] + n_corr + (0 if k == 6 else 1)
            est = {}
            for j, width in enumerate(_EST_WIDTHS, start=1):
                est[f"disp{j}"] = _Conv(gen, prev, width, activation=_linear if j == 6 else _act)
                prev = width
            self.add_module(f"estimator_{k}", nn.ModuleDict(est))
        if context_net:
            ctx = {}
            prev = _SCALE_FEATS[2][1] + 1  # left feats at scale 2 + disparity
            for j, (width, rate) in enumerate(zip(_CTX_WIDTHS, _CTX_RATES), start=1):
                ctx[f"context{j}"] = _Conv(
                    gen, prev, width, rate=rate, activation=_linear if j == 7 else _act
                )
                prev = width
            self.context = nn.ModuleDict(ctx)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.pyramid["conv1"].weight.device

    # --------------------------------------------------------------- forward
    def _make_disp(self, v: torch.Tensor, hp: int, wp: int, h: int, w: int) -> torch.Tensor:
        """relu(-20*V) upsampled to padded res, cropped back."""
        d = resize_bilinear(torch.relu(v.float() * -20.0), hp, wp)
        return crop_or_pad(d, h, w)

    def extract_features(self, left: torch.Tensor, right: torch.Tensor) -> Dict:
        """Stage 1: siamese pyramid features of NHWC ``left``/``right``,
        as ONE B=2B conv stack (identical per sample)."""
        li = pad_image(_nchw(left.float()), 64)
        ri = pad_image(_nchw(right.float()), 64)
        b = li.shape[0]
        x = torch.cat([li, ri], dim=0)
        feats = []
        for i in range(1, 13):
            x = self.pyramid[f"conv{i}"](x)
            if i % 2 == 0:
                feats.append(x)
        return {
            "lfeats": [f[:b] for f in feats],
            "rfeats": [f[b:] for f in feats],
            "orig_hw": (left.shape[1], left.shape[2]),
        }

    def estimate_from_features(self, feats: Dict) -> Dict:
        """Stage 2: cost volumes, estimators and context net."""
        h, w = feats["orig_hw"]
        hp, wp = padded_shape(h, w, 64)
        lfeats, rfeats = feats["lfeats"], feats["rfeats"]

        disparities: List[torch.Tensor] = []
        u: Optional[torch.Tensor] = None
        v: Optional[torch.Tensor] = None
        last_left = None
        for k in (6, 5, 4, 3, 2):
            lvl, _, factor = _SCALE_FEATS[k]
            lf, rf = lfeats[lvl - 1], rfeats[lvl - 1]
            if k < 6:
                # upsample chain: u_k = resize(V_{k+1}) * 20 / scale_k
                u = resize_bilinear(v, hp // factor, wp // factor) * (20.0 / factor)
                if self.bulkhead:
                    u = u.detach()
                if self.warping:
                    bound = -(-self.warp_max_disp // factor)  # ceil
                    rf = warp_features_by_mode(rf, u, self.warp_mode, bound, 4)
            corr = correlation(lf, rf, self.radius_d, self.stride, mode=self.corr_mode)
            volume = torch.cat([lf, corr] if u is None else [lf, corr, u], dim=1)
            est = getattr(self, f"estimator_{k}")
            v = volume
            for j in range(1, 7):
                v = est[f"disp{j}"](v)
            if k > 2:
                disparities.append(self._make_disp(v, hp, wp, h, w))
            last_left = lf

        if self.context_net:
            x = torch.cat([last_left, v], dim=1)
            for j in range(1, 8):
                x = self.context[f"context{j}"](x)
            v = v + x
        disparities.append(self._make_disp(v, hp, wp, h, w))

        rescaled = torch.relu(resize_bilinear(v.float(), hp, wp) * -20.0)
        disparities.append(crop_or_pad(rescaled, h, w))
        disparities = [_nhwc(d) for d in disparities]
        return {"disparities": disparities, "full_res_disp": disparities[-1]}

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Dict[str, torch.Tensor]:
        """MADNet on NHWC images in the 0..255 range. Returns
        ``disparities`` (coarse to fine, each [B,H,W,1] at input
        resolution, positive) and ``full_res_disp``."""
        return self.estimate_from_features(self.extract_features(left, right))

    # --------------------------------------------------------------- mapping
    @staticmethod
    def layer_to_path(layer_name: str) -> Optional[Tuple[str, str]]:
        """Reference layer name (block_config JSONs) -> parameter group
        path: 'left/convN' / 'right/convN', 'fgc-volume-filtering-K/dispJ',
        'contextJ'. None for layers that own no parameters."""
        if layer_name.startswith(("left/conv", "right/conv")):
            return ("pyramid", layer_name.split("/")[1])
        if layer_name.startswith("fgc-volume-filtering-"):
            scope, disp = layer_name.split("/")
            k = scope.rsplit("-", 1)[1]
            return (f"estimator_{k}", disp)
        if layer_name.startswith("context"):
            return ("context", layer_name)
        return None

    def tf_name_map(self) -> Dict[str, Tuple]:
        """{TF1 checkpoint variable name: JAX parameter path} for MADNet as
        the reference builds it under scope 'model'. The path's leaf is
        'w' or 'b'; :func:`..utils.checkpoint.params_from_jax` maps it to
        this module's ``weight`` / ``bias``."""
        m: Dict[str, Tuple] = {}
        for i in range(1, 13):
            base = f"model/gc-read-pyramid/conv{i}"
            m[f"{base}/weights"] = ("pyramid", f"conv{i}", "w")
            m[f"{base}/biases"] = ("pyramid", f"conv{i}", "b")
        for k in (6, 5, 4, 3, 2):
            for j in range(1, 7):
                base = f"model/G{k}/fgc-volume-filtering-{k}/disp-{j}"
                m[f"{base}/weights"] = (f"estimator_{k}", f"disp{j}", "w")
                m[f"{base}/biases"] = (f"estimator_{k}", f"disp{j}", "b")
        if self.context_net:
            for j in range(1, 8):
                m[f"model/context-{j}/weights"] = ("context", f"context{j}", "w")
                m[f"model/context-{j}/biases"] = ("context", f"context{j}", "b")
        return m

    @property
    def num_adaptable_predictions(self) -> int:
        """Scale predictions usable as MAD blocks (= len(disparities) - 1)."""
        return 5
