"""DispNet-Corr1D as a PyTorch module.

Port of ``real_time_self_adaptive_deep_stereo_tpu/models/dispnet.py``
with the same architecture and defaults, in both variants:

* input normalisation ``x/255 - 100/255`` and a centred REFLECT pad to /64;
* ``correlation=True``: a siamese conv1 (7x7 s2, 64) / conv2 (5x5 s2, 128)
  run as one B=2 stack for the left and right images, ``conv_redir``
  (1x1, 64) on the left features, a 1-D correlation over +-40 px (81
  channels) and conv3 (5x5 s2, 256) on ``[corr, redir]``;
  ``correlation=False``: the two images concatenated through conv1..conv3;
* the encoder conv3_1 .. conv6_1 (up to 1024 channels);
* five upsampling blocks up5 .. up1, each a 4x4 s2 ``deconv``, a linear
  3x3 ``predict`` of the block's input, a linear 4x4 s2 ``up_predict`` of
  that prediction and a linear 3x3 ``concat`` of ``[skip, deconv,
  up_predict]``; then a linear 3x3 ``prediction``;
* seven outputs: ``relu(pred * W_padded / W_pred)`` of each of the five
  block predictions and of the final one, resized to the padded input and
  centre-cropped, and the final prediction resized and doubled.

Activations are leaky-relu(0.1) except the linear layers named above.
Under the ``bf16_act`` precision mode (``ops/conv.py``) every activation
after the first convolution is bf16, and so are the seven disparities:
the JAX model casts none of them back to fp32, unlike MADNet's heads, and
the port keeps that. Every concat joins tensors of the activation dtype.
Parameter groups keep the JAX keys (``conv1`` .. ``conv6_1``,
``conv_redir``, ``up5.deconv`` .. ``up1.concat``, ``prediction``), each
with ``weight`` and ``bias``; convolution weights are OIHW, transposed
ones ``[in, out, kh, kw]``. Inside it works in NCHW; at the boundary it
takes NHWC frames and returns NHWC ([B,H,W,1]) disparities, as the JAX
model does. Under a width-sharded layout (:mod:`..parallel.spatial`)
every op runs on the rank's columns and every width the forward reads is
the global one.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from real_time_self_adaptive_deep_stereo_torch.ops import (
    conv2d,
    conv2d_transpose,
    correlation,
    crop_or_pad,
    init_conv,
    leaky_relu,
    pad_image,
    padded_shape,
    resize_bilinear,
    shard_context,
)
from real_time_self_adaptive_deep_stereo_torch.utils.device import resolve_device

__all__ = ["DispNet", "MAX_DISP"]

MAX_DISP = 40

_act = leaky_relu(0.1)


def _linear(x):
    return x


# upsampling blocks: (name, in_c, out_c, skip_c)
_UP_BLOCKS = [
    ("up5", 1024, 512, 512),
    ("up4", 512, 256, 512),
    ("up3", 256, 128, 256),
    ("up2", 128, 64, 128),
    ("up1", 64, 32, 64),
]


class _Conv(nn.Module):
    """A k x k conv with TF SAME padding, a bias and a fixed activation;
    with ``transpose`` the transposed conv of TF SAME semantics (an output
    of ``stride`` times the input)."""

    def __init__(
        self,
        generator: torch.Generator,
        k: int,
        cin: int,
        cout: int,
        stride: int = 1,
        activation: Callable = _act,
        transpose: bool = False,
    ):
        super().__init__()
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        w, b = init_conv(generator, shape, transpose=transpose)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        self.stride, self.activation, self.transpose = stride, activation, transpose

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transpose:
            return conv2d_transpose(x, self.weight, self.bias, self.stride, self.activation)
        return conv2d(x, self.weight, self.bias, self.stride, self.activation)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    # contiguous NCHW: the correlation kernels take NCHW, and cuDNN would
    # carry a permuted view's channels-last strides through every conv
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class DispNet(nn.Module):
    """DispNet-Corr1D (``correlation=True``) or DispNet-S. Runs on
    ``cuda`` unless ``device='cpu'``; weights are Xavier-uniform from
    ``seed`` (load real ones with ``load_state_dict`` and
    :func:`..utils.checkpoint.params_from_jax`)."""

    name = "Dispnet"
    width_sharding = True  # every op of the forward runs on a rank's columns (parallel/spatial.py)

    def __init__(
        self,
        correlation: bool = True,
        corr_mode: str = "auto",
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        self.correlation = correlation
        self.corr_mode = corr_mode
        device = resolve_device(device)

        gen = torch.Generator().manual_seed(seed)
        if correlation:
            self.conv1 = _Conv(gen, 7, 3, 64, stride=2)
            self.conv2 = _Conv(gen, 5, 64, 128, stride=2)
            self.conv_redir = _Conv(gen, 1, 128, 64)
            self.conv3 = _Conv(gen, 5, 2 * MAX_DISP + 1 + 64, 256, stride=2)
        else:
            self.conv1 = _Conv(gen, 7, 6, 64, stride=2)
            self.conv2 = _Conv(gen, 5, 64, 128, stride=2)
            self.conv3 = _Conv(gen, 5, 128, 256, stride=2)
        self.conv3_1 = _Conv(gen, 3, 256, 256)
        self.conv4 = _Conv(gen, 3, 256, 512, stride=2)
        self.conv4_1 = _Conv(gen, 3, 512, 512)
        self.conv5 = _Conv(gen, 3, 512, 512, stride=2)
        self.conv5_1 = _Conv(gen, 3, 512, 512)
        self.conv6 = _Conv(gen, 3, 512, 1024, stride=2)
        self.conv6_1 = _Conv(gen, 3, 1024, 1024)
        for name, cin, cout, skip in _UP_BLOCKS:
            block = {
                "deconv": _Conv(gen, 4, cin, cout, stride=2, transpose=True),
                "predict": _Conv(gen, 3, cin, 1, activation=_linear),
                "up_predict": _Conv(gen, 4, 1, 1, stride=2, activation=_linear, transpose=True),
                "concat": _Conv(gen, 3, cout + skip + 1, cout, activation=_linear),
            }
            self.add_module(name, nn.ModuleDict(block))
        self.prediction = _Conv(gen, 3, 32, 1, activation=_linear)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    # --------------------------------------------------------------- forward
    def _make_disp(self, op: torch.Tensor, hp: int, wp: int, h: int, w: int) -> torch.Tensor:
        """relu(pred * width ratio) resized to the padded input, cropped
        back. The JAX model reads the width at NHWC ``shape[2]``; under
        width sharding it is the global width."""
        scale = wp / shard_context.width(op, 3)
        d = resize_bilinear(torch.relu(op * scale), hp, wp)
        return crop_or_pad(d, h, w)

    @staticmethod
    def _up_block(block: nn.ModuleDict, bottom: torch.Tensor, skip: torch.Tensor):
        deconv = block["deconv"](bottom)
        predict = block["predict"](bottom)
        up_predict = block["up_predict"](predict)
        out = block["concat"](torch.cat([skip, deconv, up_predict], dim=1))
        return out, predict

    def extract_features(self, left: torch.Tensor, right: torch.Tensor) -> Dict:
        """Stage 1: the features that feed the correlation, of NHWC
        ``left``/``right``; the siamese conv1/conv2 run as ONE B=2B stack
        (identical per sample)."""
        # global under width sharding: the resizes and the crop take it
        b, h, w = left.shape[0], left.shape[1], shard_context.width(left, 2)
        li = pad_image(_nchw(left.float() / 255.0 - 100.0 / 255.0), 64)
        ri = pad_image(_nchw(right.float() / 255.0 - 100.0 / 255.0), 64)
        feats: Dict = {"orig_hw": (h, w)}
        if self.correlation:
            c1 = self.conv1(torch.cat([li, ri], dim=0))
            c2 = self.conv2(c1)
            feats.update({"c1a": c1[:b], "c2a": c2[:b], "c2b": c2[b:]})
        else:
            c1 = self.conv1(torch.cat([li, ri], dim=1))
            feats.update({"c1": c1, "c2": self.conv2(c1)})
        return feats

    def estimate_from_features(self, feats: Dict) -> Dict:
        """Stage 2: correlation, the encoder's tail and the decoder."""
        h, w = feats["orig_hw"]
        hp, wp = padded_shape(h, w, 64)
        if self.correlation:
            c1a, c2a, c2b = feats["c1a"], feats["c2a"], feats["c2b"]
            redir = self.conv_redir(c2a)
            corr = correlation(c2a, c2b, MAX_DISP, mode=self.corr_mode)
            c3 = self.conv3(torch.cat([corr, redir], dim=1))
            skip2, skip1 = c2a, c1a
        else:
            c3 = self.conv3(feats["c2"])
            skip2, skip1 = feats["c2"], feats["c1"]

        c3_1 = self.conv3_1(c3)
        c4_1 = self.conv4_1(self.conv4(c3_1))
        c5_1 = self.conv5_1(self.conv5(c4_1))
        x = self.conv6_1(self.conv6(c5_1))

        disparities: List[torch.Tensor] = []
        for (name, *_), skip in zip(_UP_BLOCKS, [c5_1, c4_1, c3_1, skip2, skip1]):
            x, predict = self._up_block(getattr(self, name), x, skip)
            disparities.append(self._make_disp(predict, hp, wp, h, w))
        prediction = self.prediction(x)
        disparities.append(self._make_disp(prediction, hp, wp, h, w))
        disparities.append(crop_or_pad(resize_bilinear(prediction, hp, wp) * 2.0, h, w))
        disparities = [_nhwc(d) for d in disparities]
        return {"disparities": disparities, "full_res_disp": disparities[-1]}

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> Dict[str, torch.Tensor]:
        """DispNet on NHWC images in the 0..255 range. Returns the seven
        ``disparities`` (each [B,H,W,1] at input resolution) and
        ``full_res_disp``, the last of them."""
        return self.estimate_from_features(self.extract_features(left, right))

    # --------------------------------------------------------------- mapping
    @staticmethod
    def layer_to_path(layer_name: str) -> Optional[Tuple[str, ...]]:
        """Reference layer names (``block_config/dispnet_full*.json``) ->
        parameter paths: 'conv1a'/'conv1b' share 'conv1' (and conv2 alike),
        'convN/1' is 'convN_1', 'upK/<part>' is a part of block upK, and
        'corr' owns no parameters."""
        if layer_name in ("conv1a", "conv1b"):
            return ("conv1",)
        if layer_name in ("conv2a", "conv2b"):
            return ("conv2",)
        if "/" in layer_name:
            head, tail = layer_name.split("/", 1)
            if head.startswith("up"):
                return (head, tail)
            if tail == "1":
                return (f"{head}_1",)
        if layer_name == "corr":
            return None
        return (layer_name,)

    def tf_name_map(self) -> Dict[str, Tuple]:
        """{TF1 checkpoint variable name: JAX parameter path} for DispNet
        under scope 'model' (sharedLayers' bias name 'bias'). The path's
        leaf is 'w' or 'b'; :func:`..utils.checkpoint.params_from_jax` maps
        it to this module's ``weight`` / ``bias``."""
        m: Dict[str, Tuple] = {}

        def add(scope: str, *path: str):
            m[f"model/{scope}/weights"] = (*path, "w")
            m[f"model/{scope}/bias"] = (*path, "b")

        add("conv1", "conv1")
        add("conv2", "conv2")
        if self.correlation:
            add("conv_redir", "conv_redir")
        add("conv3", "conv3")
        for n in ("3", "4", "5", "6"):
            add(f"conv{n}/1", f"conv{n}_1")
            if n != "3":
                add(f"conv{n}", f"conv{n}")
        for name, *_ in _UP_BLOCKS:
            for part in ("deconv", "predict", "up_predict", "concat"):
                add(f"{name}/{part}", name, part)
        add("prediction", "prediction")
        return m

    @property
    def num_adaptable_predictions(self) -> int:
        """Predictions usable as MAD blocks: the five blocks' and the final one."""
        return 6
