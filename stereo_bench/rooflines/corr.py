"""The 1-D correlation ``corr[k, h, w] = mean_c x[c, h, w] y[c, h, w + d_k]``
over ``k = 2r + 1`` shifts.

Forward: reads x and y, writes the k planes; a multiply and an add per
(element, shift). Backward: reads the k planes of the gradient and, for
each gradient asked, the other input (``dx`` needs y, ``dy`` needs x),
writes that gradient; a multiply and an add per (element, shift) and
gradient.
"""


def count(kind: str, a: dict, itemsize: int = 4):
    n = a["b"] * a["h"] * a["w"]
    c, k = a["c"], 2 * a["radius"] + 1
    if kind == "corr_fwd":
        return 2.0 * n * c * k, itemsize * (2.0 * n * c + n * k)
    g = len(a["grads"])
    return 2.0 * n * c * k * g, itemsize * (n * k + 2.0 * n * c * g)
