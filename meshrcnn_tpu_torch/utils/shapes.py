"""Conv and deconv output-shape arithmetic (counterpart of meshrcnn_tpu/utils/shapes.py)."""
from __future__ import annotations


def _tuple(n):
    if isinstance(n, tuple):
        assert len(n) == 2
        return n
    return n, n


def _dim(h: int, k: int, p: int, s: int, d: int) -> int:
    return int((h + 2 * p - d * (k - 1) - 1) / s) + 1


def conv_output(h: int, w: int, kernel=3, padding=0, dilation=1, stride=1):
    """Feature-map (h, w) after a convolution (reference: utils.py:9-17)."""
    kh, kw = _tuple(kernel)
    ph, pw = _tuple(padding)
    dh, dw = _tuple(dilation)
    sh, sw = _tuple(stride)
    return _dim(h, kh, ph, sh, dh), _dim(w, kw, pw, sw, dw)


def _dim_t(h: int, k: int, p: int, s: int, d: int, pout: int) -> int:
    return (h - 1) * s - 2 * p + d * (k - 1) + pout + 1


def convT_output(h: int, w: int, kernel=3, padding=0, dilation=1, stride=1,
                 output_padding=0):
    """Feature-map (h, w) after a transposed convolution (reference: utils.py:24-38)."""
    kh, kw = _tuple(kernel)
    ph, pw = _tuple(padding)
    dh, dw = _tuple(dilation)
    sh, sw = _tuple(stride)
    poh, pow_ = _tuple(output_padding)
    return _dim_t(h, kh, ph, sh, dh, poh), _dim_t(w, kw, pw, sw, dw, pow_)
