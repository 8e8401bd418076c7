"""Gradient clipping of the program builder (counterpart of
``paddle_tpu/fluid/clip.py``; reference: python/paddle/fluid/clip.py):
``GradientClipByValue``, ``GradientClipByNorm``,
``GradientClipByGlobalNorm``, ``ErrorClipByValue``, ``set_gradient_clip``
and ``append_gradient_clip_ops``, as ops of the training program."""

from __future__ import annotations

_global_clip = None


class BaseGradientClipAttr:
    def _append_clip_op(self, block, grad):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _append_clip_op(self, block, grad):
        out = block.create_var(shape=grad.shape, dtype=grad.dtype,
                               stop_gradient=True)
        block.append_op("clip", inputs={"X": [grad]}, outputs={"Out": [out]},
                        attrs={"min": self.min, "max": self.max})
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_clip_op(self, block, grad):
        out = block.create_var(shape=grad.shape, dtype=grad.dtype,
                               stop_gradient=True)
        block.append_op("clip_by_norm", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"max_norm": self.clip_norm})
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """reference: clip.py GradientClipByGlobalNorm — every gradient
    scaled by clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_global_clip_ops(self, params_grads):
        if not params_grads:
            return params_grads
        block = params_grads[0][0].block
        sq_norms = []
        for _, g in params_grads:
            sq = block.create_var(shape=[], dtype=g.dtype,
                                  stop_gradient=True)
            block.append_op("squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [sq]})
            sq_norms.append(sq)
        total = block.create_var(shape=[], dtype="float32",
                                 stop_gradient=True)
        block.append_op("sum", inputs={"X": sq_norms},
                        outputs={"Out": [total]})
        gnorm = block.create_var(shape=[], dtype="float32",
                                 stop_gradient=True)
        block.append_op("sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]})
        clipped = []
        for p, g in params_grads:
            out = block.create_var(shape=g.shape, dtype=g.dtype,
                                   stop_gradient=True)
            block.append_op("global_norm_clip_apply",
                            inputs={"X": [g], "GlobalNorm": [gnorm]},
                            outputs={"Out": [out]},
                            attrs={"clip_norm": self.clip_norm})
            clipped.append((p, out))
        return clipped


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip


def append_gradient_clip_ops(params_grads):
    """reference: clip.py append_gradient_clip_ops."""
    if isinstance(_global_clip, GradientClipByGlobalNorm):
        return _global_clip._append_global_clip_ops(params_grads)
    out = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip_attr", None) or _global_clip
        if clip is None:
            out.append((p, g))
        else:
            out.append((p, clip._append_clip_op(p.block, g)))
    return out


class ErrorClipByValue:
    """reference: clip.py ErrorClipByValue, kept for its callers."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)
