"""Weight-decay regularizers of the program builder (counterpart of
``paddle_tpu/fluid/regularizer.py``; reference:
python/paddle/fluid/regularizer.py): ops appended onto each gradient
before its optimizer op. The nn.Module trainers' decay is
``paddle_tpu_torch/regularizer.py``."""

from __future__ import annotations


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(shape=param.shape, dtype=param.dtype,
                                 stop_gradient=True)
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff})
        out = block.create_var(shape=param.shape, dtype=param.dtype,
                               stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [out]})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        # the subgradient of |p|: sign(p) * coeff
        sign = block.create_var(shape=param.shape, dtype=param.dtype,
                                stop_gradient=True)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        scaled = block.create_var(shape=param.shape, dtype=param.dtype,
                                  stop_gradient=True)
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [scaled]},
                        attrs={"scale": self.coeff})
        out = block.create_var(shape=param.shape, dtype=param.dtype,
                               stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, scaled]},
                        outputs={"Out": [out]})
        return out


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None:
            out.append((p, g))
        else:
            out.append((p, reg.append_regularization_op(p, g, p.block)))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
