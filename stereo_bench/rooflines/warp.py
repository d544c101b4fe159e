"""The horizontal bilinear warps (the image warp of the loss, the feature
warp of MADNet): ``out[c, h, x] = (1 - t) src[c, h, x0] + t src[c, h, x0 + 1]``
at an offset per pixel.

Forward: reads the source and the offset, writes the output; three
operations per output element. Backward: reads the output's gradient and
the offset, and the source where the offset's gradient is asked; writes
the gradients asked; four operations per element and gradient.
"""


def count(kind: str, a: dict, itemsize: int = 4):
    n = a["b"] * a["h"] * a["w"]
    c = a["c"]
    if kind == "warp_fwd":
        return 3.0 * c * n, itemsize * n * (2.0 * c + 1)
    src, off = "src" in a["grads"], "off" in a["grads"]
    return 4.0 * c * n * (src + off), itemsize * n * ((off + 1) * c + src * c + 1 + off)
