"""Inference IR rewrites of the port (its own copy of
``paddle_tpu/inference/transpiler.py``; reference:
transpiler/inference_transpiler.py): batch_norm folded into the conv
before it, the capability behind ``conv_bn_fuse_pass``.

    y = scale * (conv(x) + b - mean) / sqrt(var + eps) + shift
      = conv'(x) + shift'    with conv' = alpha W, b' = alpha b,
        shift' = shift - alpha mean,  alpha = scale / sqrt(var + eps)

The batch_norm op becomes, in place, an elementwise_add (axis 1) of the
folded shift. The fold runs in numpy float32 on the host, as the
reference's does, and the folded arrays go back into the scope as
tensors on the device of the values they replace (where the reference
calls ``jax.device_put``), so they are bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.fluid.ir_pass import host_array, put_like

CONV_TYPES = {"conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose"}


class InferenceTranspiler:
    """reference: inference_transpiler.py InferenceTranspiler.transpile
    (program, place, scope)."""

    def transpile(self, program, place=None, scope=None) -> int:
        """Fold every conv + batch_norm of ``program``'s global block
        over ``scope`` (default: the global scope); returns the count
        folded. ``place`` is taken for the reference's signature: the
        folded values stay on their own device."""
        folded = self.fold_block(program.desc.global_block, scope)
        if folded:
            program.desc.bump_version()
        return folded

    def fold_block(self, block, scope=None) -> int:
        scope = scope or global_scope()
        producers = {}
        for op in block.ops:
            for n in op.output_names():
                producers[n] = op

        def host(name):
            return host_array(scope.find_var(name))

        folded = 0
        for op in list(block.ops):
            if op.type != "batch_norm":
                continue
            x = op.inputs["X"][0]
            prod = producers.get(x)
            bias_op = None
            conv_op = None
            if prod is not None and prod.type == "elementwise_add" and \
                    prod.attrs.get("axis", -1) == 1:
                bias_op = prod
                up = producers.get(prod.inputs["X"][0])
                if up is not None and up.type in CONV_TYPES:
                    conv_op = up
            elif prod is not None and prod.type in CONV_TYPES:
                conv_op = prod
            if conv_op is None:
                continue

            w_name = conv_op.inputs["Filter"][0]
            scale = host(op.inputs["Scale"][0])
            shift = host(op.inputs["Bias"][0])
            mean = host(op.inputs["Mean"][0])
            var = host(op.inputs["Variance"][0])
            eps = float(op.attrs.get("epsilon", 1e-5))
            alpha = scale / np.sqrt(var + eps)

            w_old = scope.find_var(w_name)
            w = host_array(w_old)
            if conv_op.type == "conv2d_transpose":
                # filter layout [I, O, kh, kw]
                w = w * alpha.reshape(1, -1, 1, 1)
            else:
                w = w * alpha.reshape(-1, *([1] * (w.ndim - 1)))
            scope.set_var(w_name, put_like(w_old, w.astype(np.float32)))

            if bias_op is not None:
                b_name = bias_op.inputs["Y"][0]
                b_old = scope.find_var(b_name)
                scope.set_var(b_name, put_like(
                    b_old, (alpha * host_array(b_old)).astype(np.float32)))
            shift_new = (shift - alpha * mean).astype(np.float32)

            # the bn Bias var carries the folded shift (persistable and
            # of the right shape already)
            shift_name = op.inputs["Bias"][0]
            scope.set_var(shift_name, put_like(scope.find_var(shift_name),
                                               shift_new))

            y = op.outputs["Y"][0]
            op.type = "elementwise_add"
            op.inputs = {"X": [x], "Y": [shift_name]}
            op.outputs = {"Out": [y]}
            op.attrs = {"axis": 1}
            folded += 1
        return folded
