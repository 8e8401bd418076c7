"""Dense operators of the decoder-LM path, as plain functions with the
numerics of their JAX emitters:

- :func:`layer_norm` -- ``paddle_tpu/ops/nn_ops.py:392``: population
  variance, eps 1e-5, normalized over the trailing dims (statistics in
  fp32 for a bf16 or fp16 input).
- :func:`lookup_table` -- ``nn_ops.py:504`` (and ``gather``,
  ``paddle_tpu/ops/math_ops.py:245``): rows of a table by index, a
  trailing id dim of 1 dropped, ``padding_idx`` rows zeroed; with
  ``sparse=True`` the table's gradient is row-sparse (a sparse COO tensor
  over the looked-up rows), as the JAX ``__vjp__`` emits a
  ``RowSparseGrad`` for it (``paddle_tpu/ops/grad_ops.py:38``,
  ``:137-150``).
- :func:`fc` -- ``paddle_tpu/ops/misc_ops.py:485`` (and the ``mul`` +
  ``sum`` + bias + act chain ``layers.fc`` emits): weights in [in, out]
  layout, one per input.
- :func:`scale` -- ``paddle_tpu/ops/math_ops.py:74``.

and those the training path adds (differentiable through autograd, like
the ops above):

- :func:`dropout` -- ``nn_ops.py:462`` in training, ``upscale_in_train``:
  the counter-hash keep mask over the flat element index
  (``hash_keep_mask(seed, 0, index, 0, p)``), keep / (1 - p) rounded to
  x's dtype before the product, as the JAX op multiplies.
- :func:`softmax` -- ``nn_ops.py:528``, over the last axis.
- :func:`softmax_with_cross_entropy` -- ``nn_ops.py:563``, hard labels:
  ``lse - picked`` with closed-form label smoothing ``+ eps * (picked -
  mean(logits))`` and ``ignore_index`` rows at 0.
- :func:`matmul` -- ``paddle_tpu/ops/math_ops.py:51`` (batched, optional
  ``transpose_y``).
- :func:`mean` -- ``math_ops.py:122``.
- :func:`fused_linear_ce` -- ``nn_ops.py:610``: the vocabulary projection
  and the label-smoothed CE as one op, whose fused kernels run on the
  card (``ops/kernels/fused_ce.py``).

and those of the LSTM classifier's head:

- :func:`cross_entropy` -- ``nn_ops.py:544``, on probabilities:
  ``-log(p[label] + 1e-9)`` with ``ignore_index`` rows at 0, or
  ``-sum(label * log(p + 1e-9))`` for soft labels.
- :func:`accuracy` -- ``paddle_tpu/ops/metric_ops.py:13``, fed the top-k
  indices as ``layers.accuracy`` feeds it (``fluid/layers/nn.py:531``).

and those of deepfm:

- :func:`sigmoid_cross_entropy_with_logits` -- ``nn_ops.py:650-664``:
  ``max(x, 0) - x * label + log1p(exp(-|x|))``, 0 where the label is
  ``ignore_index``, divided by the count of the others with
  ``normalize``.
- :func:`square_error_cost` (``nn_ops.py:666``), :func:`sigmoid`,
  :func:`square` (the activations of
  ``paddle_tpu/ops/basic.py:197-203``), :func:`reduce_sum`
  (``math_ops.py:100-115``), :func:`slice` (``math_ops.py:218``, the
  bounds clipped as there) and :func:`reshape` (``math_ops.py:147``, a 0
  copying the input's dim).

and those of the image classifiers (``paddle_tpu/models/mnist.py``,
``smallnet.py``, ``alexnet.py``, ``vgg.py``, ``resnet.py``,
``se_resnext.py``, ``googlenet.py``), which the JAX package leaves to XLA
and the port to cuDNN and PyTorch's own kernels (no Pallas kernel lies on
this path):

- :func:`conv2d` -- ``nn_ops.py:69-114``: NCHW input, OIHW filter,
  strides, paddings, dilations and groups. An fp32 conv is full fp32 on
  the card whatever ``torch.backends.cudnn.allow_tf32`` says
  (:class:`_IeeeConv`).
- :func:`pool2d` -- ``nn_ops.py:187-227``: max (padded with -inf, the
  gradient to the first maximum of a window) or average (exclusive of
  the padding by default), ``global_pooling``; the output size always
  floors, as the JAX op ignores ``ceil_mode``.
- :func:`batch_norm` -- ``nn_ops.py:252-388``: batch statistics (the
  biased variance) and the running update ``running * momentum + batch *
  (1 - momentum)`` in training, the running statistics in test mode; a
  bf16 or fp16 input takes the low-precision path (:class:`_BatchNormLowp`).
- :func:`dropout` with ``implementation="downgrade_in_infer"`` (the
  layer's default, ``nn_ops.py:462-501``), the ``axis`` broadcast of
  :func:`elementwise_add` and :func:`elementwise_mul`
  (``paddle_tpu/ops/basic.py:126-133``), :func:`concat`
  (``math_ops.py:193``), :func:`sums` (``math_ops.py:84``), :func:`relu`,
  and ``fc``'s ``num_flatten_dims`` (the ``mul`` op's
  ``x_num_col_dims``, ``math_ops.py:25-47``).

and those the program executor adds (``core/lowering.py``):
:func:`elementwise_sub`, :func:`mul` (``math_ops.py:25-47``), :func:`top_k`
(``math_ops.py:137``; ties in index order, as ``lax.top_k`` gives them),
:func:`transpose` (``math_ops.py:181``), ``matmul``'s ``transpose_x`` and
``alpha``, ``scale``'s ``bias_after_scale``. The emitters at the end of the
file register the executor's op types of this module
(``core/registry.py``), each a thin adapter onto the functions here.

Mixed precision: the ops of the AMP rewrite take ``amp``, a dict of AMP
tags by op type (``contrib/mixed_precision.py``; None: fp32), and read
their own type's tags: ``fc`` (its products as ``mul``, its bias add as
``elementwise_add``), :func:`mul`, ``matmul``, ``lookup_table``,
``fused_linear_ce``, :func:`conv2d` and :func:`elementwise_add` /
:func:`elementwise_mul` (the ``match_dtype`` rule,
:func:`match_low_precision`). A trainer hands its model's dict; an
emitter the dict of its op's attributes (``policy_of``).

The NHWC layout (``contrib/layout.py``): :func:`conv2d` with
``channels_last`` takes channels-last operands and gives a channels-last
result of NCHW shape, and the emitters of ``conv2d``, ``pool2d`` and
``batch_norm`` enter and leave a region by their tags (:func:`nhwc_in`,
:func:`nhwc_out`); the emitters' section says which tags each reads.
"""

from __future__ import annotations

import contextlib
import math
from builtins import slice as builtins_slice
from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.contrib.mixed_precision import policy, policy_of
from paddle_tpu_torch.core.registry import first, register_op, single
from paddle_tpu_torch.ops import metric_ops as _metric_ops
from paddle_tpu_torch.ops.kernels import fused_ce as _fused_ce
from paddle_tpu_torch.ops.kernels.flash_attention import hash_keep_mask

LOW_PRECISION = (torch.bfloat16, torch.float16)

# one [rows, V] fp32 block of softmax_with_cross_entropy at a time
CE_BLOCK_ELEMS = 1 << 24


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 from bf16 operands: ``b`` 2-D
    (``a``'s leading dims flattened) or of ``a``'s batch dims. On CUDA
    one cuBLAS product of the bf16 operands with an fp32 result: its sums
    are fp32 whatever ``allow_bf16_reduced_precision_reduction`` says,
    which governs only products with a bf16 result. On the CPU the fp32
    product of the widened operands, each term exact."""
    if not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    f32 = torch.float32
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
        return out.view(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                    b.reshape(-1, *b.shape[-2:]), out_dtype=f32)
    return out.view(*a.shape[:-1], b.shape[-1])


def _split_bf16(g: torch.Tensor):
    """fp32 ``g`` as three bf16 tensors whose sum is ``g`` exactly (8
    significant bits each; bf16 has fp32's exponent range)."""
    hi = g.to(torch.bfloat16)
    rest = g - hi                        # fp32: bf16 widens exactly
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid).to(torch.bfloat16)


def _cotangent_terms(g: torch.Tensor):
    """The cotangent of a product as the bf16-valued terms it meets the
    other operand in. JAX's transposed ``dot_general`` multiplies the
    cotangent (fp32, or bf16 under ``keep``) by the bf16 operand in fp32
    (``_dot_general_transpose_lhs``); on the card an fp32 cotangent is
    taken as its exact split into three bf16 terms, so that the product
    runs on bf16 operands with fp32 sums and means the same."""
    if not g.is_cuda or g.dtype == torch.bfloat16:
        return (g,)
    return _split_bf16(g.float())


def _sum_products(terms, b: torch.Tensor, left: bool) -> torch.Tensor:
    """``sum(t @ b)`` (``left``) or ``sum(b @ t)`` over the terms, in
    fp32."""
    out = None
    for t in terms:
        p = _product_f32(t, b) if left else _product_f32(b, t)
        out = p if out is None else out + p
    return out


class _AmpProduct(torch.autograd.Function):
    """bf16 ``x @ y`` with fp32 sums: the forward and its hand-written
    backward of ``jnp.matmul(x, y, preferred_element_type=float32)``
    (``paddle_tpu/ops/math_ops.py:36-47``, ``:59-65``), the fp32 result
    rounded to bf16 with ``keep``. The cotangent meets the other operand
    as JAX's transpose rule has it (:func:`_cotangent_terms`): an fp32
    product of the cotangent and the bf16 operand, rounded to the
    operand's dtype, bf16."""

    @staticmethod
    def forward(ctx, xb, yb, keep):
        ctx.save_for_backward(xb, yb)
        out = _product_f32(xb, yb)
        return out.to(torch.bfloat16) if keep else out

    @staticmethod
    def backward(ctx, g):
        xb, yb = ctx.saved_tensors
        terms = _cotangent_terms(g)
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _sum_products(terms, yb.transpose(-1, -2), True)
            dx = dx.to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            if yb.dim() == 2:                # x's leading dims folded
                x2 = xb.reshape(-1, xb.shape[-1]).t()
                dy = _sum_products([t.reshape(-1, t.shape[-1])
                                    for t in terms], x2, False)
            else:
                dy = _sum_products(terms, xb.transpose(-1, -2), False)
            dy = dy.to(torch.bfloat16)
        return dx, dy, None


def amp_product(x: torch.Tensor, y: torch.Tensor, keep: bool
                ) -> torch.Tensor:
    """``x @ y`` as a tagged ``mul`` / ``matmul`` computes it
    (``paddle_tpu/ops/math_ops.py:36-47``): bf16 operands, fp32 sums, the
    result bf16 with ``keep`` (pure mode), else fp32 (conservative
    mode), through :class:`_AmpProduct` on both devices. ``y`` is 2-D
    (``fc``'s weight) or has ``x``'s batch dims (``matmul``). On the CPU
    the products are fp32 products of the bf16-rounded operands, exact
    per term, as the JAX dot on the CPU; on CUDA they are cuBLAS products
    of bf16 operands with fp32 results."""
    if y.dim() > 2 and x.shape[:-2] != y.shape[:-2]:
        raise ValueError(f"amp_product takes a 2-D y or one of x's batch "
                         f"dims, got x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)}")
    return _AmpProduct.apply(x.to(torch.bfloat16), y.to(torch.bfloat16),
                             bool(keep))


def match_low_precision(x: torch.Tensor, y: torch.Tensor):
    """``_match_low_precision`` (``paddle_tpu/ops/basic.py:138-155``): of a
    bf16 (or fp16) and an fp32 operand, the fp32 one cast down to the
    other's dtype instead of the result promoted to fp32."""
    if x.dtype in LOW_PRECISION and y.dtype == torch.float32:
        y = y.to(x.dtype)
    elif y.dtype in LOW_PRECISION and x.dtype == torch.float32:
        x = x.to(y.dtype)
    return x, y


def _broadcast_y(x: torch.Tensor, y: torch.Tensor, axis: int
                 ) -> torch.Tensor:
    """``y`` shaped to broadcast into ``x`` with its dims aligned at
    ``axis`` of x (-1: at the trailing dims), fluid's convention
    (``paddle_tpu/ops/basic.py:126-133``): a [C] bias at axis 1 of an
    [N, C, H, W] map, an [N, C] gate at axis 0."""
    if y.dim() == 0 or x.shape == y.shape:
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    return y.reshape((1,) * axis + tuple(y.shape)
                     + (1,) * (x.dim() - axis - y.dim()))


def _elementwise(fn, op_type, x, y, amp, axis):
    y = _broadcast_y(x, y, axis)
    if policy(amp, op_type).match_dtype \
            and x.is_floating_point() and y.is_floating_point():
        x, y = match_low_precision(x, y)
    return fn(x, y)


def elementwise_add(x: torch.Tensor, y: torch.Tensor, amp=None,
                    axis: int = -1) -> torch.Tensor:
    """``x + y``, ``y`` broadcast from ``axis`` (:func:`_broadcast_y`;
    -1: from the right), the float operands matched by
    :func:`match_low_precision` where ``amp`` tags ``elementwise_add``
    with ``match_dtype``: the models' residual, bias and position-encoding
    adds."""
    return _elementwise(torch.add, "elementwise_add", x, y, amp, axis)


def elementwise_mul(x: torch.Tensor, y: torch.Tensor, amp=None,
                    axis: int = -1) -> torch.Tensor:
    """``x * y`` as :func:`elementwise_add` adds: the SE gate [N, C] over
    an [N, C, H, W] map at ``axis=0``."""
    return _elementwise(torch.mul, "elementwise_mul", x, y, amp, axis)


def elementwise_sub(x: torch.Tensor, y: torch.Tensor, amp=None,
                    axis: int = -1) -> torch.Tensor:
    """``x - y`` as :func:`elementwise_add` adds (deepfm's
    ``sum_sq - sq_sum``)."""
    return _elementwise(torch.sub, "elementwise_sub", x, y, amp, axis)


def concat(xs, axis: int = 0) -> torch.Tensor:
    return torch.cat(list(xs), dim=axis)


def sums(xs) -> torch.Tensor:
    """The ``sum`` op: the inputs added left to right."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], begin_norm_axis: int = -1,
               eps: float = 1e-5, with_stats: bool = False):
    """Normalized over the dims from ``begin_norm_axis`` on. A bf16 or
    fp16 ``x`` takes its statistics in fp32 and is normalized in its own
    dtype, the scale and bias cast down to it (``nn_ops.py:399-414``).
    ``with_stats`` also returns the mean and the variance, shaped
    ``x.shape[:begin_norm_axis]`` and detached (``:415-419``)."""
    axes = tuple(range(begin_norm_axis % x.dim(), x.dim()))
    lowp = x.dtype in LOW_PRECISION
    xs = x.float() if lowp else x
    mean = xs.mean(dim=axes, keepdim=True)
    var = (xs - mean).square().mean(dim=axes, keepdim=True)
    inv = torch.rsqrt(var + eps)
    if lowp:
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    else:
        y = (x - mean) * inv
    norm_shape = x.shape[axes[0]:]
    if weight is not None:
        y = y * weight.reshape(norm_shape).to(y.dtype)
    if bias is not None:
        y = y + bias.reshape(norm_shape).to(y.dtype)
    if with_stats:
        lead = x.shape[:axes[0]]
        return y, mean.detach().reshape(lead), var.detach().reshape(lead)
    return y


def lookup_table(w: torch.Tensor, ids: torch.Tensor, sparse: bool = False,
                 padding_idx: Optional[int] = None, amp=None
                 ) -> torch.Tensor:
    """ids [..., 1] or [...] int -> [..., D] rows of ``w`` [V, D]: a
    trailing id dim of 1 is dropped (``nn_ops.py:513``), so ids [B, T]
    give [B, T, D] and so do ids [B, T, 1]. ``padding_idx`` >= 0: the rows
    whose id equals it are zeros, and their gradient is too
    (``:508-512``, ``grad_ops.py:68-71``). ``sparse``: the gradient of
    ``w`` is a sparse tensor with one row per looked-up id (duplicates not
    yet summed). Where ``amp`` tags ``lookup_table`` with ``keep_bf16``
    (pure mode) an fp32 result is cast to bf16; autograd casts its
    gradient back to fp32 before it reaches the table (``:515-521``)."""
    ids = ids.long()
    keep = ids.shape[:-1] if ids.dim() and ids.shape[-1] == 1 else ids.shape
    flat = ids.reshape(-1)
    if sparse:
        out = torch.nn.functional.embedding(flat, w, sparse=True)
    else:
        out = w[flat]
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((flat == padding_idx)[:, None], 0.0)
    if policy(amp, "lookup_table").keep_bf16 and out.dtype == torch.float32:
        out = out.to(torch.bfloat16)
    return out.reshape(*keep, w.shape[-1])


def fc(x, w, b: Optional[torch.Tensor] = None,
       act: Optional[str] = None, amp=None,
       num_flatten_dims: Optional[int] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b) (+ act: relu, tanh, sigmoid or
    softmax over the last axis): the ``mul`` (+ ``sum``) +
    ``elementwise_add`` + act ops of ``layers.fc``
    (``fluid/layers/nn.py:20-45``). With ``num_flatten_dims`` k, x's
    dims from k on are flattened first, as the ``mul`` op's
    ``x_num_col_dims`` does (``math_ops.py:25-47``: an [N, C, H, W] map
    at k 1 is [N, C*H*W]), and the result is x.shape[:k] + [out]; None
    multiplies the last axis. With a list of inputs and a list of as
    many weights, the products are summed before the one bias. Each
    product is a ``mul`` under ``amp`` (:func:`amp_product` where it tags
    ``mul`` with ``bf16``), the bias add an ``elementwise_add``
    (:func:`elementwise_add`)."""
    tags = policy(amp, "mul")

    def product(xi, wi):
        if num_flatten_dims is not None:
            xi = xi.reshape(*xi.shape[:num_flatten_dims], -1)
        return amp_product(xi, wi, tags.keep_bf16) if tags.bf16 \
            else xi @ wi
    if isinstance(x, (list, tuple)):
        if not isinstance(w, (list, tuple)) or len(w) != len(x):
            raise ValueError("a multi-input fc takes one weight per input")
        out = product(x[0], w[0])
        for xi, wi in zip(x[1:], w[1:]):
            out = out + product(xi, wi)
    else:
        out = product(x, w)
    if b is not None:
        out = elementwise_add(out, b, amp)
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    elif act == "sigmoid":
        out = torch.sigmoid(out)
    elif act == "softmax":
        out = torch.softmax(out, dim=-1)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out


def scale(x: torch.Tensor, factor: float, bias: float = 0.0,
          bias_after_scale: bool = True) -> torch.Tensor:
    """``x * factor + bias``, or ``(x + bias) * factor`` without
    ``bias_after_scale``."""
    if bias_after_scale:
        return x * factor + bias
    return (x + bias) * factor


def mul(x: torch.Tensor, y: torch.Tensor, x_num_col_dims: int = 1,
        y_num_col_dims: int = 1, amp=None) -> torch.Tensor:
    """The ``mul`` op (``math_ops.py:25-47``): x flattened to 2-D at
    ``x_num_col_dims`` (its dims before it the rows), y at
    ``y_num_col_dims``, one product, reshaped to ``x.shape[:xn] +
    y.shape[yn:]``: an [N, C, H, W] map at 1 is [N, C*H*W]. Where ``amp``
    tags ``mul`` with ``bf16`` the product is :func:`amp_product`."""
    lead, rows = x.shape[:x_num_col_dims], y.shape[:y_num_col_dims]
    x2, y2 = x.reshape(math.prod(lead), -1), y.reshape(math.prod(rows), -1)
    tags = policy(amp, "mul")
    out = amp_product(x2, y2, tags.keep_bf16) if tags.bf16 else x2 @ y2
    return out.reshape(tuple(lead) + tuple(y.shape[y_num_col_dims:]))


DROPOUT_IMPLEMENTATIONS = ("upscale_in_train", "downgrade_in_infer")


def dropout(x: torch.Tensor, p: float, seed: int, is_test: bool = False,
            implementation: str = "upscale_in_train",
            with_mask: bool = False):
    """Dropout with the JAX op's keep mask (``nn_ops.py:462-501``):
    element ``i`` of the flattened ``x`` is kept iff ``hash_keep_mask(seed,
    0, i, 0, p)`` is non-zero, so the same seed drops the same elements as
    the JAX op. ``seed`` is an int32 value (the JAX op draws it from its
    step key). In training, ``upscale_in_train`` scales the kept elements
    by 1 / (1 - p) (rounded to x's dtype before the product) and
    ``downgrade_in_infer`` keeps them as they are; in test mode
    (``is_test``) the first is the identity and the second scales x by
    (1 - p). ``with_mask`` also returns the op's ``Mask`` output, the
    keep mask as 0 / 1 in x's dtype (ones in test mode), detached; a
    constant mask is a broadcast view of one element, which takes no
    memory."""
    if implementation not in DROPOUT_IMPLEMENTATIONS:
        raise ValueError(f"unknown dropout implementation "
                         f"{implementation!r}")
    upscale = implementation == "upscale_in_train"

    def const_mask(value):
        return torch.full((), value, dtype=x.dtype,
                          device=x.device).expand(x.shape)
    if is_test or p == 0.0:
        # p 0: the mask keeps every element (threshold 0), x * 1
        out = x if (upscale or not is_test) else x * (1.0 - p)
        return (out, const_mask(1.0)) if with_mask else out
    if p >= 1.0:
        out = torch.zeros_like(x)       # everything dropped, no 0 * inf
        return (out, const_mask(0.0)) if with_mask else out
    idx = torch.arange(x.numel(), device=x.device).view(x.shape)
    keep = hash_keep_mask(seed, 0, idx, 0, p)
    out = x * (keep if upscale else (keep > 0)).to(x.dtype)
    if with_mask:
        return out, (keep > 0).to(x.dtype).detach()
    return out


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


class _SoftmaxCE(torch.autograd.Function):
    """Hard-label softmax CE over [N, V] logits of any float dtype, in
    blocks of rows: each block widened to fp32 for its reductions (the
    streaming form of ``nn_ops.py:575-600``), so no fp32 copy of the
    whole logits is made and the backward keeps only the logits and the
    [N] log-sum-exp. The gradient, ``softmax - (1 - eps) * onehot - eps /
    V`` times the loss's cotangent (0 on ignored rows), is returned in
    the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, lab, eps, ignore_index):
        n, v = logits.shape
        rows = max(1, CE_BLOCK_ELEMS // max(v, 1))
        loss = torch.empty((n, 1), dtype=torch.float32,
                           device=logits.device)
        lse = torch.empty_like(loss)
        safe = lab.clamp(0, v - 1)
        for i in range(0, n, rows):
            z = logits[i:i + rows].float()
            m = z.amax(dim=-1, keepdim=True)
            blk = m + torch.log(torch.exp(z - m).sum(dim=-1, keepdim=True))
            picked = z.gather(-1, safe[i:i + rows])
            out = blk - picked
            if eps:
                out = out + eps * (picked - z.mean(dim=-1, keepdim=True))
            loss[i:i + rows] = out
            lse[i:i + rows] = blk
        loss = torch.where(lab == ignore_index, torch.zeros_like(loss), loss)
        ctx.save_for_backward(logits, lab, lse)
        ctx.args = (eps, ignore_index)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, lab, lse = ctx.saved_tensors
        eps, ignore_index = ctx.args
        n, v = logits.shape
        rows = max(1, CE_BLOCK_ELEMS // max(v, 1))
        g = torch.where(lab == ignore_index, torch.zeros_like(g),
                        g.float())
        safe = lab.clamp(0, v - 1)
        dz = torch.empty_like(logits)
        for i in range(0, n, rows):
            z = logits[i:i + rows].float()
            d = torch.exp(z - lse[i:i + rows])
            if eps:
                d = d - eps / v
            d = d.scatter_add(-1, safe[i:i + rows], torch.full_like(
                lse[i:i + rows], -(1.0 - eps)))
            dz[i:i + rows] = d * g[i:i + rows]
        return dz, None, None, None


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               label_smoothing: float = 0.0,
                               ignore_index: int = -100) -> torch.Tensor:
    """logits [..., V], integer label [..., 1] (or [...]) -> loss [..., 1]
    (fp32): ``lse - picked`` with closed-form label smoothing ``+ eps *
    (picked - mean(logits))`` and ``ignore_index`` rows at 0, reduced in
    fp32 from logits of any float dtype (:class:`_SoftmaxCE`). The result
    and its gradient are those of ``-sum(q * log_softmax(logits))`` with
    ``q = (1 - eps) * onehot + eps / V``."""
    v = logits.shape[-1]
    lab = label.reshape(-1, 1).long()
    loss = _SoftmaxCE.apply(logits.reshape(-1, v), lab,
                            float(label_smoothing), int(ignore_index))
    return loss.reshape(logits.shape[:-1] + (1,))


def matmul(x: torch.Tensor, y: torch.Tensor, transpose_y: bool = False,
           amp=None, transpose_x: bool = False, alpha: float = 1.0
           ) -> torch.Tensor:
    """``x @ y`` (``x`` or ``y`` transposed on its last two axes with
    ``transpose_x`` / ``transpose_y``; a 1-D operand is not), a tagged
    ``matmul`` through :func:`amp_product` (``math_ops.py:50-71``), times
    ``alpha`` when it is not 1."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    tags = policy(amp, "matmul")
    if tags.bf16:
        out = amp_product(x, y, tags.keep_bf16)
    else:
        out = torch.matmul(x, y)
    return out * alpha if alpha != 1.0 else out


def mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def cross_entropy(prob: torch.Tensor, label: torch.Tensor,
                  soft_label: bool = False,
                  ignore_index: int = -100) -> torch.Tensor:
    """prob [N, D] probabilities, label [N, 1] (or [N]) integers, or
    [N, D] weights with ``soft_label`` -> loss [N, 1] in fp32."""
    if prob.dtype in (torch.bfloat16, torch.float16):
        prob = prob.to(torch.float32)
    eps = 1e-9
    if soft_label:
        return -(label * torch.log(prob + eps)).sum(dim=-1, keepdim=True)
    lab = label.reshape(-1, 1).long()
    picked = prob.gather(-1, lab.clamp(0, prob.shape[-1] - 1))
    loss = -torch.log(picked + eps)
    return torch.where(lab == ignore_index, torch.zeros_like(loss), loss)


def accuracy(prob: torch.Tensor, label: torch.Tensor, k: int = 1):
    """-> (accuracy [1] fp32, correct [1] int32, total [1] int32): the
    share of rows whose label is among the k largest of ``prob`` [N, D]
    (:func:`top_k`, then ``ops/metric_ops.py`` ``accuracy``, as
    ``layers.accuracy`` chains the two ops). Carries no gradient."""
    with torch.no_grad():
        return _metric_ops.accuracy(top_k(prob, k)[1], label)


def top_k(x: torch.Tensor, k: int = 1):
    """-> (values, int64 indices) of the ``k`` largest along the last axis
    (``math_ops.py:137``), in descending order with ties in index order,
    as ``lax.top_k`` returns them: a stable descending sort, where
    ``torch.topk`` promises no order among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fused_linear_ce(x: torch.Tensor, w: torch.Tensor, label: torch.Tensor,
                    label_smoothing: float = 0.0,
                    ignore_index: int = -100, amp=None) -> torch.Tensor:
    """X [N, D] @ W [D, V] and the label-smoothed softmax CE of Label
    [N, 1] int -> Loss [N, 1], the logits never materialized on the card.
    Every shape goes to the fused function: the JAX op's ``supported``
    gate is a TPU tiling rule, and its composed branch computes the same
    function. Where ``amp`` tags ``fused_linear_ce`` with ``bf16``, x and
    W are cast to bf16 first (``nn_ops.py:625-640``), so on the card the
    bf16 kernels run; the loss stays fp32 and W's gradient comes back in
    fp32 through the cast."""
    if policy(amp, "fused_linear_ce").bf16:
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    return _fused_ce.fused_linear_ce(x, w, label.reshape(-1),
                                     label_smoothing, ignore_index)


def sigmoid_cross_entropy_with_logits(x: torch.Tensor, label: torch.Tensor,
                                      ignore_index: int = -100,
                                      normalize: bool = False
                                      ) -> torch.Tensor:
    """Elementwise loss of logits ``x`` against labels of x's shape (fp32
    for fp16 and bf16 logits)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    loss = torch.clamp_min(x, 0.0) - x * label \
        + torch.log1p(torch.exp(-x.abs()))
    ignored = label == ignore_index
    loss = torch.where(ignored, torch.zeros_like(loss), loss)
    if normalize:
        loss = loss / torch.clamp_min((~ignored).to(x.dtype).sum(), 1.0)
    return loss


def square_error_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(x - y) ** 2`` elementwise (``nn_ops.py:666``)."""
    return torch.square(x - y)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def square(x: torch.Tensor) -> torch.Tensor:
    return torch.square(x)


def reduce_sum(x: torch.Tensor, dim=None, keep_dim: bool = False
               ) -> torch.Tensor:
    """The sum over ``dim`` (an int or a list; None: every axis)."""
    if dim is None:
        dims = tuple(range(x.dim()))
    else:
        dims = tuple(d % x.dim() for d in ([dim] if isinstance(dim, int)
                                           else dim))
    return x.sum(dim=dims, keepdim=keep_dim)


def slice(x: torch.Tensor, axes, starts, ends) -> torch.Tensor:  # noqa: A001
    """``x[..., s:e, ...]`` on each of ``axes``, negative bounds counted
    from the end and every bound clipped into the axis."""
    idx = [builtins_slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = builtins_slice(s, e)
    return x[tuple(idx)]


def transpose(x: torch.Tensor, perm) -> torch.Tensor:
    """``x`` with its axes in the order ``perm`` (``math_ops.py:181``)."""
    return x.permute(*perm)


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` in ``shape``, where a 0 copies x's dim at that position and
    one -1 takes the rest."""
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


# -- the image classifiers' ops (paddle_tpu/ops/nn_ops.py:69-388) ------------

def _pair(v):
    return tuple(int(i) for i in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


@contextlib.contextmanager
def _ieee_conv(x: torch.Tensor):
    """For a conv on the card: cuDNN's fp32 conv precision set to
    ``"ieee"`` and restored on exit, so that an fp32 conv runs in fp32
    whatever the caller set (``torch.backends.cudnn.allow_tf32``, True by
    default, or ``torch.backends.cudnn.conv.fp32_precision``, which the
    conv reads). On the CPU there is no TF32 and nothing to set."""
    if not x.is_cuda:
        yield
        return
    conv = torch.backends.cudnn.conv
    saved = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = saved


class _IeeeConv(torch.autograd.Function):
    """``F.conv2d`` whose forward and backward both run under
    :func:`_ieee_conv`: the reference's fp32 conv is full fp32
    (``nn_ops.py:101-108``), and PyTorch would otherwise compute an fp32
    conv on the card in TF32 by default. The backward is
    ``convolution_backward``, the library's own."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, dilation, groups)
        with _ieee_conv(x):
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.args
        with _ieee_conv(x):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return dx, dw, None, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
           dilation=1, groups: int = 1, amp=None,
           channels_last: bool = False) -> torch.Tensor:
    """x [N, C, H, W] conv w [O, C / groups, kh, kw] -> [N, O, H', W'],
    no bias (``layers.conv2d`` adds it as an ``elementwise_add`` at axis
    1). A grouped conv is one ``F.conv2d(groups=...)``: the JAX op's dense
    block-diagonal rewrite of narrow groups (``nn_ops.py:84-100``) is a
    TPU layout choice with the same result. Where ``amp`` tags ``conv2d``
    with ``bf16`` both operands are cast to bf16 and the conv runs in
    bf16 (fp32 sums inside cuDNN); its bf16 result is kept in pure mode
    and widened to fp32 in conservative mode, one bf16 rounding as in the
    JAX op (``:109-113``). Otherwise the conv runs in the operands' dtype,
    an fp32 one in full fp32 on the card (:class:`_IeeeConv`).

    ``channels_last`` (an NHWC region, ``contrib/layout.py``): x and w
    are made channels-last, w in the same copy as its bf16 cast, so
    cuDNN takes both without a transpose and returns a channels-last
    result; the shapes stay NCHW."""
    args = (_pair(stride), _pair(padding), _pair(dilation), int(groups))
    tags = policy(amp, "conv2d")
    fmt = torch.channels_last if channels_last else torch.preserve_format
    x = x.contiguous(memory_format=fmt) if channels_last else x
    if tags.bf16:
        out = F.conv2d(x.to(torch.bfloat16),
                       w.to(torch.bfloat16, memory_format=fmt), None, *args)
        return out if tags.keep_bf16 else out.float()
    return _IeeeConv.apply(x, w.contiguous(memory_format=fmt) if
                           channels_last else w, *args)


def pool2d(x: torch.Tensor, pool_size, pool_type: str = "max",
           pool_stride=1, pool_padding=0, global_pooling: bool = False,
           exclusive: bool = True) -> torch.Tensor:
    """Max or average pooling of x [N, C, H, W] (``nn_ops.py:187-227``).
    Max pooling pads with -inf and gives a window's gradient to its first
    maximum, as XLA's ``select_and_scatter`` does; average pooling divides
    by the count of cells inside the input where ``exclusive`` and
    padding are both set, else by kh * kw. ``global_pooling`` takes the
    whole map as the window, with no padding and stride 1. The output size
    floors, ``(H + 2 p - k) // s + 1``: the JAX op ignores the layer's
    ``ceil_mode``, and so does the port. A padding above half the window
    raises (PyTorch's pools take at most half; no model pads more)."""
    ksize, strides, pads = (_pair(pool_size), _pair(pool_stride),
                            _pair(pool_padding))
    if global_pooling:
        ksize, strides, pads = tuple(x.shape[2:]), (1, 1), (0, 0)
    if any(p > k // 2 for p, k in zip(pads, ksize)):
        raise ValueError(f"pool2d padding {pads} exceeds half the window "
                         f"{ksize}")
    if pool_type == "max":
        return F.max_pool2d(x, ksize, strides, pads)
    if pool_type == "avg":
        return F.avg_pool2d(x, ksize, strides, pads,
                            count_include_pad=not exclusive)
    raise ValueError(f"unknown pooling type {pool_type!r}")


def _bn_shape(x: torch.Tensor):
    """(the reduction axes: all but the channel axis 1, the broadcast
    shape of a [C] vector)."""
    return ((0,) + tuple(range(2, x.dim())),
            (1, -1) + (1,) * (x.dim() - 2))


def _bn_fold(x, mean, var, scale, bias, eps):
    """``x * k + b`` in x's dtype, with k and b per channel computed in
    fp32 and rounded to it (``nn_ops.py:260-266``); and ``inv``."""
    _, bshape = _bn_shape(x)
    inv = torch.rsqrt(var + eps)
    k = (inv * scale).to(x.dtype)
    b = (bias - mean * inv * scale).to(x.dtype)
    return x * k.view(bshape) + b.view(bshape), inv


class _BatchNormLowp(torch.autograd.Function):
    """Train-mode batch norm of a bf16 or fp16 x, the JAX op's
    ``_bn_train_lowp`` (``nn_ops.py:269-325``): fp32 statistics from
    one-pass moments ``E[x^2] - E[x]^2`` clamped at 0, the folded
    normalize :func:`_bn_fold`, and the hand-written backward ``dx = k *
    (dy - mean(dy) - xhat * mean(dy * xhat))``, elementwise in x's dtype
    with fp32 channel sums. Returns (y, batch mean, batch variance); the
    statistics carry no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        axes, _ = _bn_shape(x)
        xf = x.float()
        mean = xf.mean(dim=axes)
        var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
        y, inv = _bn_fold(x, mean, var, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        axes, bshape = _bn_shape(x)
        xdt = x.dtype
        n = x.numel() // x.shape[1]
        dyl = dy.to(xdt)
        xhat = (x - mean.to(xdt).view(bshape)) * inv.to(xdt).view(bshape)
        sum_dy = dyl.sum(dim=axes, dtype=torch.float32)
        sum_dy_xhat = (dyl * xhat).sum(dim=axes, dtype=torch.float32)
        k = (scale * inv).to(xdt).view(bshape)
        m1 = (sum_dy / n).to(xdt).view(bshape)
        m2 = (sum_dy_xhat / n).to(xdt).view(bshape)
        dx = k * (dyl - m1 - xhat * m2)
        return (dx, sum_dy_xhat.to(scale.dtype), sum_dy.to(scale.dtype),
                None)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, variance: torch.Tensor,
               is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, with_stats: bool = False):
    """Batch norm of x [N, C, ...] over every axis but the channel axis 1
    (``nn_ops.py:328-388``; a 2-D [N, C] x too). ``mean`` and
    ``variance`` [C] are the running statistics.

    Training (``is_test`` False): the batch mean and the biased variance
    normalize x, and the running statistics are updated in place, outside
    the gradient, to ``running * momentum + batch * (1 - momentum)``.
    (``F.batch_norm``'s own update would store the unbiased variance and
    weigh the batch by ``momentum``: it gets no running buffers here.)
    Test mode: the running statistics normalize x and stay as they are.

    A bf16 or fp16 x takes the JAX op's low-precision path: fp32
    statistics and a folded normalize in x's dtype (:class:`_BatchNormLowp`
    in training, :func:`_bn_fold` in test mode). Otherwise PyTorch's
    batch norm computes y and its gradient. ``with_stats`` (training)
    also returns the batch mean and variance, detached: the op's
    ``SavedMean`` / ``SavedVariance``."""
    lowp = x.dtype in LOW_PRECISION
    if is_test:
        if lowp:
            return _bn_fold(x, mean, variance, scale, bias, epsilon)[0]
        return F.batch_norm(x, mean, variance, scale, bias, False, 0.0,
                            epsilon)
    if lowp:
        y, bmean, bvar = _BatchNormLowp.apply(x, scale, bias, epsilon)
    else:
        # the op itself: F.batch_norm refuses one value a channel, which
        # the JAX op normalizes to its bias
        y = torch.batch_norm(x, scale, bias, None, None, True, 0.0,
                             epsilon, torch.backends.cudnn.enabled)
        with torch.no_grad():
            bvar, bmean = torch.var_mean(x, dim=_bn_shape(x)[0],
                                         correction=0)
    with torch.no_grad():
        mean.copy_(mean * momentum + bmean * (1.0 - momentum))
        variance.copy_(variance * momentum + bvar * (1.0 - momentum))
    if with_stats:
        return y, bmean.detach(), bvar.detach()
    return y


# -- emitters of the program executor (paddle_tpu/ops/nn_ops.py) -------------
# Thin adapters: each maps the op's slots and attrs onto the function above
# that computes it. The tags of the program rewrites (contrib/) that each
# emitter of the port reads:
# - AMP (contrib/mixed_precision.py, policy_of): conv2d and conv2d_fusion,
#   mul, matmul, fc, fused_linear_ce, fused_attention_block __amp_bf16__ /
#   __amp_keep_bf16__; lookup_table __amp_keep_bf16__; the elementwise
#   binaries __amp_match_dtype__. batch_norm reads none: a bf16 input
#   (a pure conv's output) takes its low-precision path by dtype.
# - NHWC (contrib/layout.py): conv2d, conv2d_fusion, pool2d and batch_norm
#   __nhwc__ / __nhwc_in_ready__ / __nhwc_out_keep__ (nhwc_in, nhwc_out;
#   conv2d_fusion also __nhwc_resid_ready__); the elementwise binaries
#   __nhwc_bcast__ / __nhwc_bcast_bc__ and concat __nhwc_concat__, whose
#   JAX re-aims at the physical channel axis are identities here (a
#   channels-last tensor keeps its NCHW shape).

def nhwc_in(x: torch.Tensor, attrs) -> torch.Tensor:
    """An NHWC region's entry (``nn_ops.py:53-58`` ``_nhwc_in``): x made
    channels-last unless its producer kept it so
    (``__nhwc_in_ready__``). Its shape stays NCHW."""
    if attrs.get("__nhwc__") and not attrs.get("__nhwc_in_ready__"):
        return x.contiguous(memory_format=torch.channels_last)
    return x


def nhwc_out(out: torch.Tensor, attrs) -> torch.Tensor:
    """An NHWC region's exit (``nn_ops.py:61-66`` ``_nhwc_out``): a tagged
    op's output stays channels-last where every consumer takes it
    (``__nhwc_out_keep__``), else goes back to the default contiguous
    format."""
    if not attrs.get("__nhwc__"):
        return out
    if attrs.get("__nhwc_out_keep__"):
        return out.contiguous(memory_format=torch.channels_last)
    return out.contiguous()


@register_op("conv2d", ref="operators/conv_op.cc:44 Conv2DOp")
def _conv2d_op(ctx, ins, attrs):
    x = nhwc_in(first(ins, "Input"), attrs)
    out = conv2d(x, first(ins, "Filter"), attrs.get("strides", [1, 1]),
                 attrs.get("paddings", [0, 0]), attrs.get("dilations", [1, 1]),
                 attrs.get("groups", 1), policy_of("conv2d", attrs),
                 channels_last=bool(attrs.get("__nhwc__")))
    return {"Output": [nhwc_out(out, attrs)]}


@register_op("pool2d", ref="operators/pool_op.cc")
def _pool2d_op(ctx, ins, attrs):
    # ceil_mode is ignored, as the JAX op ignores it (the output floors)
    out = pool2d(nhwc_in(first(ins, "X"), attrs), attrs.get("ksize", [2, 2]),
                 attrs.get("pooling_type", "max"),
                 attrs.get("strides", [1, 1]), attrs.get("paddings", [0, 0]),
                 attrs.get("global_pooling", False),
                 attrs.get("exclusive", True))
    return single(nhwc_out(out, attrs))


@register_op("batch_norm", ref="operators/batch_norm_op.cc:40")
def _batch_norm_op(ctx, ins, attrs):
    """Test mode (the ``is_test`` attr, the program's, or
    ``use_global_stats``): the running statistics normalize x and come
    out as they went in. Training: :func:`batch_norm` updates copies of
    them, returned as ``MeanOut`` / ``VarianceOut`` (the executor writes
    them back), and the batch statistics as ``SavedMean`` /
    ``SavedVariance``."""
    x = nhwc_in(first(ins, "X"), attrs)
    scale_, bias = first(ins, "Scale"), first(ins, "Bias")
    mean_, var = first(ins, "Mean"), first(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    if attrs.get("is_test", False) or ctx.is_test \
            or attrs.get("use_global_stats", False):
        y = batch_norm(x, scale_, bias, mean_, var, True, epsilon=eps)
        return {"Y": [nhwc_out(y, attrs)], "MeanOut": [mean_],
                "VarianceOut": [var], "SavedMean": [mean_],
                "SavedVariance": [var]}
    mean_out, var_out = mean_.clone(), var.clone()
    y, bmean, bvar = batch_norm(x, scale_, bias, mean_out, var_out, False,
                                attrs.get("momentum", 0.9), eps,
                                with_stats=True)
    return {"Y": [nhwc_out(y, attrs)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [bmean],
            "SavedVariance": [bvar]}


@register_op("layer_norm", ref="operators/layer_norm_op.cc")
def _layer_norm_op(ctx, ins, attrs):
    """``Y``, and the statistics ``Mean`` / ``Variance`` (no gradient
    flows through them)."""
    y, mean, var = layer_norm(first(ins, "X"), first(ins, "Scale"),
                              first(ins, "Bias"),
                              attrs.get("begin_norm_axis", 1),
                              attrs.get("epsilon", 1e-5), with_stats=True)
    return {"Y": [y], "Mean": [mean], "Variance": [var]}


@register_op("dropout", ref="operators/dropout_op.cc")
def _dropout_op(ctx, ins, attrs):
    """Test mode: ``Out`` (x, or x * (1 - p) for ``downgrade_in_infer``,
    the attr's default) and a ``Mask`` of ones. Training: ``Out`` under
    the hash keep mask seeded by the step key, and that ``Mask``."""
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    is_test = attrs.get("is_test", False) or ctx.is_test
    out, mask = dropout(x, p, 0 if is_test else ctx.step_key(), is_test,
                        impl, with_mask=True)
    return {"Out": [out], "Mask": [mask]}


@register_op("lookup_table", ref="operators/lookup_table_op.cc")
def _lookup_table_op(ctx, ins, attrs):
    return single(lookup_table(first(ins, "W"), first(ins, "Ids"),
                               padding_idx=attrs.get("padding_idx", -1),
                               amp=policy_of("lookup_table", attrs)))


@register_op("softmax", ref="operators/softmax_op.cc")
def _softmax_op(ctx, ins, attrs):
    return single(softmax(first(ins, "X")))


@register_op("cross_entropy", ref="operators/cross_entropy_op.cc")
def _cross_entropy_op(ctx, ins, attrs):
    return {"Y": [cross_entropy(first(ins, "X"), first(ins, "Label"),
                                attrs.get("soft_label", False),
                                attrs.get("ignore_index", -100))]}


@register_op("softmax_with_cross_entropy",
             ref="operators/softmax_with_cross_entropy_op.cc")
def _softmax_with_cross_entropy_op(ctx, ins, attrs):
    """Hard labels: ``Loss`` and ``Softmax`` (in the logits' dtype). A
    soft-label op raises: it is not ported."""
    if attrs.get("soft_label", False):
        raise NotImplementedError(
            "softmax_with_cross_entropy with soft_label is not ported "
            "(ROADMAP A6.6)")
    logits = first(ins, "Logits")
    loss = softmax_with_cross_entropy(logits, first(ins, "Label"),
                                      attrs.get("label_smoothing", 0.0),
                                      attrs.get("ignore_index", -100))
    return {"Loss": [loss], "Softmax": [softmax(logits)]}


@register_op("fused_linear_ce",
             ref="composed: mul_op.cc + softmax_with_cross_entropy_op.cc")
def _fused_linear_ce_op(ctx, ins, attrs):
    return {"Loss": [fused_linear_ce(first(ins, "X"), first(ins, "W"),
                                     first(ins, "Label"),
                                     float(attrs.get("label_smoothing", 0.0)),
                                     attrs.get("ignore_index", -100),
                                     policy_of("fused_linear_ce", attrs))]}


@register_op("sigmoid_cross_entropy_with_logits",
             ref="operators/sigmoid_cross_entropy_with_logits_op.cc")
def _sigmoid_ce_op(ctx, ins, attrs):
    return single(sigmoid_cross_entropy_with_logits(
        first(ins, "X"), first(ins, "Label"),
        attrs.get("ignore_index", -100), attrs.get("normalize", False)))


@register_op("fused_attention_block",
             ref="composed: mul+transpose+matmul+softmax ops")
def _fused_attention_block_op(ctx, ins, attrs):
    """The flash path of ``ops/attention_block.py``; attention dropout
    keyed by the step key, off in test mode."""
    from paddle_tpu_torch.ops.attention_block import fused_attention_block
    p = float(attrs.get("dropout_prob") or 0.0)
    if ctx.is_test or attrs.get("is_test"):
        p = 0.0
    return single(fused_attention_block(
        first(ins, "Xq"), first(ins, "Xkv"),
        *(first(ins, n) for n in ("Wq", "Wk", "Wv", "Wo")),
        int(attrs["n_head"]), bool(attrs.get("causal", False)), p,
        ctx.step_key() if p > 0 else 0,
        policy_of("fused_attention_block", attrs)))
