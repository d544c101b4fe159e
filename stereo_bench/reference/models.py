"""MADNet and DispNet-Corr1D as plain functions of a parameter dict.

Parameters are keyed as ``<layer>.weight`` / ``<layer>.bias``
(convolutions OIHW, transposed ones ``[in, out, kh, kw]``). Both take NHWC
images in 0..255 and return the list of NHWC disparities at the input's
size, coarse to fine, the last the served one.

MADNet (Tonioni et al., CVPR 2019, arXiv:1810.05424; the reference's
``Nets/MadNet.py``): a six-level siamese pyramid of 3x3 convolutions
(stride 2 then 1, leaky ReLU 0.2); at scales 6..2 the right features
warped by the coarser disparity upsampled (scales 5..2), a correlation
over +-2 px, and six 3x3 convolutions on [left features, correlation,
upsampled disparity]; a dilated context network (rates 1 2 4 8 16 1 1) on
scale 2; disparities ``relu(-20 V)`` resized to the padded input and
cropped. With the bulkhead the upsampled disparity takes no gradient.

DispNet-Corr1D (Mayer et al., CVPR 2016, arXiv:1512.02134; the
reference's ``Nets/DispNet.py``): inputs ``x/255 - 100/255``; siamese
conv1 (7x7/2, 64) and conv2 (5x5/2, 128); a 1x1 redirection of the left
conv2; a correlation over +-40 px; the encoder conv3 .. conv6_1; five
upsampling blocks (4x4/2 transposed conv, a linear 3x3 prediction, its
4x4/2 transposed upsampling, a linear 3x3 conv of [skip, deconv,
upsampled prediction]); a final linear 3x3 prediction. Leaky ReLU 0.1.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from stereo_bench.reference import ops

Params = Dict[str, torch.Tensor]


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ MADNet
MADNET_PYRAMID = [2, 1] * 6  # strides of conv1..conv12
MADNET_SCALES = {6: (6, 64), 5: (5, 32), 4: (4, 16), 3: (3, 8), 2: (2, 4)}  # level, factor
MADNET_CONTEXT_RATES = [1, 2, 4, 8, 16, 1, 1]
MADNET_RADIUS = 2
MAX_DISP = 192  # the warps' window
MAX_POS = 4


def madnet(p: Params, left, right, bulkhead: bool = True) -> List[torch.Tensor]:
    act = ops.leaky(0.2)
    h, w = left.shape[1], left.shape[2]
    hp, wp = ops.padded_shape(h, w)
    x = torch.cat([ops.pad_image(_nchw(left)), ops.pad_image(_nchw(right))], 0)
    lf, rf = [], []
    for i, s in enumerate(MADNET_PYRAMID, start=1):
        x = ops.conv(x, p[f"pyramid.conv{i}.weight"], p[f"pyramid.conv{i}.bias"], stride=s, act=act)
        if i % 2 == 0:
            lf.append(x[: left.shape[0]])
            rf.append(x[left.shape[0]:])

    def head(v):
        return ops.crop(ops.resize(torch.relu(v * -20.0), hp, wp), h, w)

    disps, v = [], None
    for k in (6, 5, 4, 3, 2):
        lvl, factor = MADNET_SCALES[k]
        l_k, r_k = lf[lvl - 1], rf[lvl - 1]
        parts = [l_k]
        if k < 6:
            u = ops.resize(v, hp // factor, wp // factor) * (20.0 / factor)
            if bulkhead:
                u = u.detach()
            r_k = ops.warp_features(r_k, u, -(-MAX_DISP // factor), MAX_POS)
        parts.append(ops.correlation(l_k, r_k, MADNET_RADIUS))
        if k < 6:
            parts.append(u)
        v = torch.cat(parts, 1)
        for j in range(1, 7):
            name = f"estimator_{k}.disp{j}"
            v = ops.conv(v, p[f"{name}.weight"], p[f"{name}.bias"], act=ops.linear if j == 6 else act)
        if k > 2:
            disps.append(head(v))
        last_left = l_k
    x = torch.cat([last_left, v], 1)
    for j, rate in enumerate(MADNET_CONTEXT_RATES, start=1):
        name = f"context.context{j}"
        x = ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], rate=rate, act=ops.linear if j == 7 else act)
    v = v + x
    disps.append(head(v))
    disps.append(ops.crop(torch.relu(ops.resize(v, hp, wp) * -20.0), h, w))
    return [_nhwc(d) for d in disps]


def madnet_layer(name: str):
    """The parameter prefix of a layer name of the reference's block
    configs, None for a layer that owns no parameters."""
    if name.startswith(("left/conv", "right/conv")):
        return "pyramid." + name.split("/")[1]
    if name.startswith("fgc-volume-filtering-"):
        scope, disp = name.split("/")
        return f"estimator_{scope.rsplit('-', 1)[1]}.{disp}"
    if name.startswith("context"):
        return "context." + name
    return None


# ------------------------------------------------------------------ DispNet
DISPNET_RADIUS = 40
DISPNET_UP = ["up5", "up4", "up3", "up2", "up1"]


def dispnet(p: Params, left, right, bulkhead: bool = False) -> List[torch.Tensor]:
    del bulkhead  # DispNet has no bulkhead
    act = ops.leaky(0.1)

    def c(x, name, stride=1, a=act):
        return ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride=stride, act=a)

    def t(x, name, a=act):
        return ops.conv_transpose(x, p[f"{name}.weight"], p[f"{name}.bias"], 2, act=a)

    b, h, w = left.shape[0], left.shape[1], left.shape[2]
    hp, wp = ops.padded_shape(h, w)
    li = ops.pad_image(_nchw(left / 255.0 - 100.0 / 255.0))
    ri = ops.pad_image(_nchw(right / 255.0 - 100.0 / 255.0))
    c1 = c(torch.cat([li, ri], 0), "conv1", 2)
    c2 = c(c1, "conv2", 2)
    c1a, c2a, c2b = c1[:b], c2[:b], c2[b:]
    corr = ops.correlation(c2a, c2b, DISPNET_RADIUS)
    c3 = c(torch.cat([corr, c(c2a, "conv_redir")], 1), "conv3", 2)
    c3_1 = c(c3, "conv3_1")
    c4_1 = c(c(c3_1, "conv4", 2), "conv4_1")
    c5_1 = c(c(c4_1, "conv5", 2), "conv5_1")
    x = c(c(c5_1, "conv6", 2), "conv6_1")

    def head(pred):
        return ops.crop(ops.resize(torch.relu(pred * (wp / pred.shape[3])), hp, wp), h, w)

    disps = []
    for name, skip in zip(DISPNET_UP, [c5_1, c4_1, c3_1, c2a, c1a]):
        deconv = t(x, f"{name}.deconv")
        pred = c(x, f"{name}.predict", a=ops.linear)
        up = t(pred, f"{name}.up_predict", a=ops.linear)
        x = c(torch.cat([skip, deconv, up], 1), f"{name}.concat", a=ops.linear)
        disps.append(head(pred))
    pred = c(x, "prediction", a=ops.linear)
    disps.append(head(pred))
    disps.append(ops.crop(ops.resize(pred, hp, wp) * 2.0, h, w))
    return [_nhwc(d) for d in disps]


def dispnet_layer(name: str):
    if name in ("conv1a", "conv1b"):
        return "conv1"
    if name in ("conv2a", "conv2b"):
        return "conv2"
    if name == "corr":
        return None
    if "/" in name:
        head, tail = name.split("/", 1)
        if head.startswith("up"):
            return f"{head}.{tail}"
        if tail == "1":
            return f"{head}_1"
    return name


def _conv_shapes(name, cout, cin, k, transpose=False):
    return [(f"{name}.weight", (cin, cout, k, k) if transpose else (cout, cin, k, k)), (f"{name}.bias", (cout,))]


def madnet_shapes():
    out, cin = [], 3
    for i, cout in enumerate([16, 16, 32, 32, 64, 64, 96, 96, 128, 128, 192, 192], start=1):
        out += _conv_shapes(f"pyramid.conv{i}", cout, cin, 3)
        cin = cout
    feats = {6: 192, 5: 128, 4: 96, 3: 64, 2: 32}
    for k in (6, 5, 4, 3, 2):
        cin = feats[k] + 2 * MADNET_RADIUS + 1 + (0 if k == 6 else 1)
        for j, cout in enumerate([128, 128, 96, 64, 32, 1], start=1):
            out += _conv_shapes(f"estimator_{k}.disp{j}", cout, cin, 3)
            cin = cout
    cin = feats[2] + 1
    for j, cout in enumerate([128, 128, 128, 96, 64, 32, 1], start=1):
        out += _conv_shapes(f"context.context{j}", cout, cin, 3)
        cin = cout
    return out


def dispnet_shapes():
    out = _conv_shapes("conv1", 64, 3, 7) + _conv_shapes("conv2", 128, 64, 5) + _conv_shapes("conv_redir", 64, 128, 1)
    out += _conv_shapes("conv3", 256, 2 * DISPNET_RADIUS + 1 + 64, 5) + _conv_shapes("conv3_1", 256, 256, 3)
    for name, cout, cin in (("conv4", 512, 256), ("conv4_1", 512, 512), ("conv5", 512, 512), ("conv5_1", 512, 512),
                            ("conv6", 1024, 512), ("conv6_1", 1024, 1024)):
        out += _conv_shapes(name, cout, cin, 3)
    for name, cin, cout, skip in zip(DISPNET_UP, [1024, 512, 256, 128, 64], [512, 256, 128, 64, 32],
                                     [512, 512, 256, 128, 64]):
        out += _conv_shapes(f"{name}.deconv", cout, cin, 4, transpose=True)
        out += _conv_shapes(f"{name}.predict", 1, cin, 3)
        out += _conv_shapes(f"{name}.up_predict", 1, 1, 4, transpose=True)
        out += _conv_shapes(f"{name}.concat", cout, cout + skip + 1, 3)
    return out + _conv_shapes("prediction", 1, 32, 3)


# name: (forward, the block configs' layer names to parameter prefixes, parameter shapes)
MODELS = {"MADNet": (madnet, madnet_layer, madnet_shapes), "Dispnet": (dispnet, dispnet_layer, dispnet_shapes)}


def block_names(model: str, groups, names) -> List[List[str]]:
    """The parameter names of each block of ``groups`` (lists of layer
    names), in ``names``' order."""
    layer = MODELS[model][1]
    out = []
    for group in groups:
        prefixes = {layer(n) for n in group} - {None}
        out.append([n for n in names if n.rsplit(".", 1)[0] in prefixes])
    return out
