"""The port's mixed precision (paddle_tpu_torch/contrib/mixed_precision.py
and the AMP branches of its ops) against the JAX package's
(paddle_tpu/contrib/mixed_precision.py and the emitters that read its
tags), on the CPU at small sizes.

- Op level: each op of the port under a pure or a conservative AMP dict
  against the JAX emitter called through ``get_op(...).emit`` with the
  same tags as attributes, outputs (and their dtypes) and gradients
  (``jax.vjp`` of the emitter against autograd). The flash branch of
  ``fused_attention_block`` is held against that branch composed by hand
  (``nn_ops.py:826-841``: the projections, the Pallas flash kernel in
  interpret mode, the ``Wo`` product), since on the CPU the JAX emitter
  never takes it (``pk.kernel_enabled`` is False off the TPU).
- The rule: each trainer's op sites are the JAX program's forward ops of
  the types the rewrite reads, in order, and the port's rewrite tags each
  op type as the JAX rewrite tags that program (pure for the
  Transformer, conservative for the stacked LSTM).
- Training: the port's Transformer (2 + 2 layers) and text-conv
  classifier under pure AMP, the stacked LSTM and the translator under
  conservative AMP, 10 steps each against the JAX executor running the
  same program through ``rewrite_program_amp``; ``decorate``'s loss
  scaling against the JAX decorator.

Tolerances, each with its reason:
- fp32 results of bf16 operands (conservative products, losses): rtol
  1e-5 / atol 1e-6, the products exact in fp32 on both sides and only the
  order of their sums different;
- bf16 results (pure products): within one bf16 step of the JAX value,
  the same fp32 value on both sides up to its last bits, which may round
  to neighbours; gradients that cross a bf16 edge and bf16 results of
  several roundings (a softmax in bf16): within one bf16 step of the
  largest magnitude. The JAX side sums its bf16 cotangents in bf16
  (a bias's gradient over rows; the CE's three cast-back terms, summed
  after each is rounded) where the port sums in fp32 and rounds once;
  two steps for the gradient through a bf16 softmax, which the JAX side
  differentiates op by op in bf16 and torch in fp32 inside the op;
- the flash branch: each element within a bf16 step of the largest
  magnitude (the kernel's online softmax rounds p against a running max,
  as tests/test_torch_flash_attention.py states);
- elementwise adds, layer norm and dropout on bf16: bit-equal (one
  rounding of the same fp32 value);
- the pure Transformer's curve: step 1 rtol 2e-4, the curve rtol 1e-3.
  The bf16 activations round at other points on each side (torch's
  softmax, layer norm and products round once inside the op, the JAX side
  op by op, and XLA may keep excess precision), ~2**-8 on single
  elements, ~1e-4 on the mean loss of 64 tokens (at most 9.3e-5 seen at
  step 1, 3.9e-4 over the curve); ten Adam steps carry them into the
  weights. At this width the bf16 noise is as large as the gap to fp32:
  the fp32 port lies as close to the JAX AMP curve (6.7e-5 at step 1), so
  this test holds the assembly and the dtypes of the whole model, and the
  op tests above hold the bf16 numerics;
- the conservative LSTM's and translator's curves: rtol 1e-4 / atol
  1e-5, the JAX package's curve bound: everything past the bf16 products
  is fp32 on both sides;
- the pure text-conv classifier's curve: atol 4e-3, the bf16 softmax of
  its head (the test says why);
- the decorated curve: rtol 1e-5, and the loss scale bit-equal at every
  step.
"""

import contextlib
import importlib
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.ops import attention_block as tab
from paddle_tpu_torch.ops import nn_ops as tnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("pure", "conservative")
FORCE_PALLAS = "PADDLE_TPU_FORCE_PALLAS"


class _AllSites:
    """A stand-in trainer with one site of every type the rewrite reads."""

    def op_sites(self):
        return (list(tmp.AMP_OP_TYPES) + list(tmp.ELEMENTWISE_OPS)
                + ["lookup_table"])


def _amp(mode):
    """(the port's AMP dict, the JAX attributes of an op type) of a mode."""
    model = _AllSites()
    tmp.rewrite_program_amp(model, pure=mode == "pure")

    def attrs(op_type):
        tags = tmp.policy(model.amp, op_type)
        return {name: True for name, on in (
            ("__amp_bf16__", tags.bf16),
            ("__amp_keep_bf16__", tags.keep_bf16),
            ("__amp_match_dtype__", tags.match_dtype)) if on}
    return model.amp, attrs


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jax.numpy, the emitters and an emit context."""
    jax = pytest.importorskip("jax")
    importlib.import_module("paddle_tpu.ops")       # registers the emitters
    registry = importlib.import_module("paddle_tpu.core.registry")
    jnp = jax.numpy

    def ctx():
        return registry.EmitContext(base_key=jax.random.PRNGKey(0))

    def emit(op_type, ins, attrs, slot="Out"):
        return registry.get_op(op_type).emit(ctx(), ins, attrs)[slot][0]
    return SimpleNamespace(jax=jax, jnp=jnp, ctx=ctx, emit=emit,
                           get_op=registry.get_op)


def _r(*shape, seed=0, scale=1.0):
    """Seeded values exactly representable in bf16, as float32."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x).bfloat16().float().numpy()


def _np(t):
    """A JAX or torch array as float32 numpy, and its dtype's name."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy(), str(t.dtype).split(".")[-1]
    return np.asarray(t.astype("float32")), str(t.dtype)


def _ulp(a):
    """bf16's step at the magnitude of ``a``: 2**(exponent - 7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -100)))
                   - 7)


def _close(got, want, how, label="", steps=1):
    """``how``: "f32" (F32_TOL), "bf16" (``steps`` bf16 steps of each
    element), "bf16_max" (of the largest magnitude) or "equal"."""
    (g, gdt), (w, wdt) = _np(got), _np(want)
    assert gdt == wdt, (label, gdt, wdt)
    if how == "equal":
        np.testing.assert_array_equal(g, w, err_msg=label)
    elif how == "f32":
        np.testing.assert_allclose(g, w, err_msg=label, **F32_TOL)
    else:
        step = steps * (_ulp(w) if how == "bf16"
                        else _ulp(np.abs(w).max()))
        bad = np.abs(g - w) > step
        assert not bad.any(), (label, np.abs(g - w).max(), int(bad.sum()),
                               float(np.abs(w).max()), g.size)


def _leaf(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype).requires_grad_(True)


def _vjp(jx, fn, args, cot):
    """(fn(*args), the gradients of sum(out * cot)) on the JAX side."""
    out, pull = jx.jax.vjp(fn, *args)
    return out, pull(cot.astype(out.dtype))


def _grads(out, leaves, cot):
    out.backward(torch.from_numpy(cot).to(out.dtype))
    return [t.grad for t in leaves]


# -- op level ----------------------------------------------------------------

def _jax_fc(jx, mode, xs, ws, b=None, act=None, ncol=2):
    """``layers.fc``'s ops: a ``mul`` a weight (+ ``sum``) + the bias's
    ``elementwise_add`` + the activation, through the emitters."""
    _, attrs = _amp(mode)
    outs = [jx.emit("mul", {"X": [x], "Y": [w]},
                    {"x_num_col_dims": ncol, "y_num_col_dims": 1,
                     **attrs("mul")}) for x, w in zip(xs, ws)]
    out = outs[0] if len(outs) == 1 else jx.emit("sum", {"X": outs}, {})
    if b is not None:
        out = jx.emit("elementwise_add", {"X": [out], "Y": [b]},
                      {"axis": ncol, **attrs("elementwise_add")})
    if act is not None:
        out = jx.emit(act, {"X": [out]}, {})
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["mul", "fc_relu", "fc_two_softmax"])
def test_fc_matches_the_jax_mul_chain(jx, mode, case):
    """``fc`` (its products as ``mul``, the bias as ``elementwise_add``):
    pure keeps bf16 (the bias cast down), conservative gives fp32."""
    amp, _ = _amp(mode)
    jnp = jx.jnp
    xs = [_r(2, 5, 24, seed=1), _r(2, 5, 16, seed=2)]
    ws = [_r(24, 12, seed=3, scale=0.3), _r(16, 12, seed=4, scale=0.3)]
    b = _r(12, seed=5)
    n_in, act, bias = {"mul": (1, None, False),
                       "fc_relu": (1, "relu", True),
                       "fc_two_softmax": (2, "softmax", True)}[case]
    xs, ws = xs[:n_in], ws[:n_in]
    cot = _r(2, 5, 12, seed=6)

    def jfn(*args):
        return _jax_fc(jx, mode, args[:n_in], args[n_in:2 * n_in],
                       args[-1] if bias else None, act)
    jargs = [jnp.asarray(a) for a in xs + ws + ([b] if bias else [])]
    want, wgrads = _vjp(jx, jfn, jargs, cot)
    leaves = [_leaf(a) for a in xs + ws + ([b] if bias else [])]
    x_in = leaves[:n_in] if n_in > 1 else leaves[0]
    w_in = leaves[n_in:2 * n_in] if n_in > 1 else leaves[n_in]
    got = tnn.fc(x_in, w_in, leaves[-1] if bias else None, act, amp=amp)
    assert got.dtype == (torch.bfloat16 if mode == "pure"
                         else torch.float32)
    how = "f32" if mode != "pure" else \
        "bf16_max" if act == "softmax" else "bf16"
    _close(got, want, how, "out")
    for i, (g, w) in enumerate(zip(_grads(got, leaves, cot), wgrads)):
        _close(g, w, "bf16_max" if mode == "pure" else "f32", f"grad {i}",
               steps=2 if act == "softmax" else 1)


@pytest.mark.parametrize("mode", MODES)
def test_matmul_matches_the_jax_emitter(jx, mode):
    amp, attrs = _amp(mode)
    x, y = _r(2, 3, 5, 8, seed=1), _r(2, 3, 7, 8, seed=2)
    cot = _r(2, 3, 5, 7, seed=3)
    want, wgrads = _vjp(jx, lambda a, c: jx.emit(
        "matmul", {"X": [a], "Y": [c]}, {"transpose_Y": True,
                                         **attrs("matmul")}),
        [jx.jnp.asarray(x), jx.jnp.asarray(y)], cot)
    leaves = [_leaf(x), _leaf(y)]
    got = tnn.matmul(*leaves, transpose_y=True, amp=amp)
    how = "bf16" if mode == "pure" else "f32"
    _close(got, want, how, "out")
    for g, w in zip(_grads(got, leaves, cot), wgrads):
        _close(g, w, "bf16_max" if mode == "pure" else "f32", "grad")


@pytest.mark.parametrize("mode", MODES)
def test_lookup_table_matches_the_jax_emitter(jx, mode):
    """Pure mode keeps the rows bf16 and casts their gradient back to the
    fp32 table; conservative leaves the op fp32."""
    amp, attrs = _amp(mode)
    w = _r(11, 6, seed=1)
    ids = np.array([[3], [0], [3], [10], [7]], np.int64)
    cot = _r(5, 6, seed=2)
    want, (wgrad,) = _vjp(jx, lambda t: jx.emit(
        "lookup_table", {"W": [t], "Ids": [jx.jnp.asarray(ids)]},
        {"padding_idx": 7, **attrs("lookup_table")}),
        [jx.jnp.asarray(w)], cot)
    leaf = _leaf(w)
    got = tnn.lookup_table(leaf, torch.from_numpy(ids), padding_idx=7,
                           amp=amp)
    _close(got, want, "equal", "rows")
    (g,) = _grads(got, [leaf], cot)
    _close(g, wgrad, "equal", "table gradient")


def test_sparse_bf16_lookup_gradient_takes_the_lazy_adam_rows():
    """A pure-AMP ``lookup_table(sparse=True)``: the table's gradient is
    row-sparse fp32 (the bf16 rows' gradient cast back up), and lazy Adam
    moves exactly those rows, as the dense gradient's rows say
    (tests/test_sparse_grad.py:128-137 on the JAX side)."""
    from paddle_tpu_torch.optimizer import Adam
    amp, _ = _amp("pure")
    table = torch.nn.Parameter(torch.from_numpy(_r(9, 4, seed=1)))
    ids = torch.tensor([[2], [5], [2]])
    cot = torch.from_numpy(_r(3, 4, seed=2)).bfloat16()
    rows = tnn.lookup_table(table, ids, sparse=True, amp=amp)
    assert rows.dtype == torch.bfloat16
    rows.backward(cot)
    assert table.grad.is_sparse and table.grad.dtype == torch.float32
    dense = torch.zeros(9, 4).index_add_(0, ids[:, 0], cot.float())
    np.testing.assert_array_equal(table.grad.to_dense().numpy(),
                                  dense.numpy())
    before = table.detach().clone()
    Adam([table], learning_rate=0.1, lazy_mode=True).step()
    moved = (table.detach() != before).any(dim=1)
    assert moved.tolist() == [i in (2, 5) for i in range(9)]


@pytest.mark.parametrize("tagged", [True, False])
@pytest.mark.parametrize("y_shape", [(12,), (3, 4, 12)])
def test_elementwise_add_matches_the_jax_dtype_rule(jx, tagged, y_shape):
    """Tagged (pure mode), an fp32 operand is cast down to the bf16 one's
    dtype; untagged, the sum is promoted to fp32."""
    amp = {"elementwise_add": tmp.AmpPolicy(match_dtype=True)} \
        if tagged else {}
    x, y = _r(3, 4, 12, seed=1), _r(*y_shape, seed=2)
    want = jx.emit("elementwise_add",
                   {"X": [jx.jnp.asarray(x).astype(jx.jnp.bfloat16)],
                    "Y": [jx.jnp.asarray(y)]},
                   {"__amp_match_dtype__": True} if tagged else {})
    got = tnn.elementwise_add(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(y), amp)
    _close(got, want, "equal")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_matches_the_jax_emitter(jx, dtype):
    """A bf16 input takes fp32 statistics and is normalized in bf16 (the
    scale and bias cast down): bit-equal to the JAX op, output bf16. The
    port's layer norm before mixed precision took bf16 statistics and
    promoted the result to fp32 through the fp32 scale."""
    x = _r(6, 40, seed=1, scale=3.0) + 1.0
    scale, bias = _r(40, seed=2) + 1.5, _r(40, seed=3)
    cot = _r(6, 40, seed=4)
    jdt = getattr(jx.jnp, dtype)

    def jfn(a, s, b):
        return jx.emit("layer_norm", {"X": [a.astype(jdt)], "Scale": [s],
                                      "Bias": [b]},
                       {"begin_norm_axis": 1}, slot="Y")
    want, wgrads = _vjp(jx, jfn, [jx.jnp.asarray(a)
                                  for a in (x, scale, bias)], cot)
    leaves = [_leaf(a) for a in (x, scale, bias)]
    got = tnn.layer_norm(leaves[0].to(getattr(torch, dtype)), leaves[1],
                         leaves[2], begin_norm_axis=1)
    if dtype == "bfloat16":
        _close(got, want, "equal", "y")
    else:
        _close(got, want, "f32", "y")
    for i, (g, w) in enumerate(zip(_grads(got, leaves, cot), wgrads)):
        _close(g, w, "bf16_max" if dtype == "bfloat16" else "f32",
               f"grad {i}")


def test_dropout_on_bf16_matches_the_jax_emitter(jx):
    """keep / (1 - p) rounded to bf16 before the product, as the JAX op
    multiplies: bit-equal for the seed the JAX op draws."""
    p = 0.3
    x = _r(7, 33, seed=1)
    ctx = jx.ctx()
    want = jx.get_op("dropout").emit(
        ctx, {"X": [jx.jnp.asarray(x).astype(jx.jnp.bfloat16)]},
        {"dropout_prob": p,
         "dropout_implementation": "upscale_in_train"})["Out"][0]
    seed = int(jx.jax.random.randint(ctx.step_key(), (), 0, 2 ** 31 - 1,
                                     dtype=jx.jnp.int32))
    got = tnn.dropout(torch.from_numpy(x).bfloat16(), p, seed)
    _close(got, want, "equal")


@pytest.mark.parametrize("block", [None, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_softmax_with_cross_entropy_matches_the_jax_emitter(
        jx, monkeypatch, dtype, block):
    """Label-smoothed CE with an ignored row: the loss in fp32 from the
    logits' dtype, the gradient in that dtype; ``block`` shrinks the
    port's row blocks to 2 rows of V 32 so that they take several."""
    if block is not None:
        monkeypatch.setattr(tnn, "CE_BLOCK_ELEMS", block)
    logits = _r(9, 32, seed=1, scale=2.0)
    label = np.random.RandomState(2).randint(0, 32, (9, 1)).astype(
        np.int64)
    label[4, 0] = -100
    cot = _r(9, 1, seed=3)
    jdt = getattr(jx.jnp, dtype)

    def jfn(z):
        return jx.emit("softmax_with_cross_entropy",
                       {"Logits": [z.astype(jdt)],
                        "Label": [jx.jnp.asarray(label)]},
                       {"label_smoothing": 0.1}, slot="Loss")
    want, (wgrad,) = _vjp(jx, jfn, [jx.jnp.asarray(logits)], cot)
    leaf = _leaf(logits)
    got = tnn.softmax_with_cross_entropy(
        leaf.to(getattr(torch, dtype)), torch.from_numpy(label),
        label_smoothing=0.1)
    _close(got, want, "f32", "loss")
    (g,) = _grads(got, [leaf], cot)
    _close(g, wgrad, "bf16_max" if dtype == "bfloat16" else "f32", "grad")


@pytest.mark.parametrize("mode", MODES)
def test_fused_linear_ce_matches_the_jax_kernel(jx, monkeypatch, mode):
    """Tagged, x and W run in bf16 (the bf16 kernels on the card); the
    JAX op runs its Pallas kernel in interpret mode
    (``PADDLE_TPU_FORCE_PALLAS=1``), which keeps the logits fp32 as the
    port's function does. The mode does not matter: the loss is fp32."""
    amp, attrs = _amp(mode)
    monkeypatch.setenv(FORCE_PALLAS, "1")
    x, w = _r(64, 32, seed=1), _r(32, 64, seed=2, scale=0.3)
    label = np.random.RandomState(3).randint(0, 64, (64, 1)).astype(
        np.int64)
    cot = _r(64, 1, seed=4)
    want, wgrads = _vjp(jx, lambda a, b: jx.emit(
        "fused_linear_ce", {"X": [a], "W": [b],
                            "Label": [jx.jnp.asarray(label)]},
        {"label_smoothing": 0.1, **attrs("fused_linear_ce")}, slot="Loss"),
        [jx.jnp.asarray(x), jx.jnp.asarray(w)], cot)
    leaves = [_leaf(x), _leaf(w)]
    got = tnn.fused_linear_ce(*leaves, torch.from_numpy(label), 0.1,
                              amp=amp)
    _close(got, want, "f32", "loss")
    for g, wg in zip(_grads(got, leaves, cot), wgrads):
        _close(g, wg, "bf16_max", "grad")


def _jax_flash_branch(jx, mode, n_head, causal):
    """The flash branch of ``_fused_attention_block`` (``nn_ops.py:
    826-841``) composed by hand, the Pallas kernel in interpret mode."""
    jax, jnp = jx.jax, jx.jnp
    pfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
    keep = mode == "pure"

    def fn(x_q, x_kv, wq, wk, wv, wo):
        x_q, x_kv, wq, wk, wv, wo = (a.astype(jnp.bfloat16) for a in
                                     (x_q, x_kv, wq, wk, wv, wo))
        b, t, m = x_q.shape
        h, d = n_head, m // n_head

        def proj_bhtd(x, w):
            y = jax.lax.dot_general(x, w.reshape(m, h, d),
                                    (((2,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32
                                    ).astype(x.dtype)
            return y.transpose(0, 2, 1, 3)
        o = pfa.flash_attention(proj_bhtd(x_q, wq), proj_bhtd(x_kv, wk),
                                proj_bhtd(x_kv, wv), causal,
                                float(d) ** -0.5, 8, 8, True, 0.0, None)
        o = o.transpose(0, 2, 1, 3).reshape(b, t, m)
        out = jnp.matmul(o, wo.astype(o.dtype),
                         preferred_element_type=jnp.float32).astype(o.dtype)
        return out if keep else out.astype(jnp.float32)
    return fn


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_block_matches_the_jax_flash_branch(
        jx, monkeypatch, mode, causal):
    """bf16 projections rounded from fp32 sums, flash in bf16, the ``Wo``
    product rounded to bf16; pure keeps it, conservative widens it, and
    either way the flash backward takes a bf16 dO (the kernels want dO in
    q's dtype)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    amp, _ = _amp(mode)
    bwd, seen = tfa.flash_bwd, []

    def recorded(q, k, v, dout, *args, **kwargs):
        seen.append({t.dtype for t in (q, k, v, dout)})
        return bwd(q, k, v, dout, *args, **kwargs)
    monkeypatch.setattr(tfa, "flash_bwd", recorded)
    b, t, m, h = 2, 16, 32, 2
    args = [_r(b, t, m, seed=1), _r(b, t, m, seed=2)] + [
        _r(m, m, seed=3 + i, scale=m ** -0.5) for i in range(4)]
    cot = _r(b, t, m, seed=9)
    want, wgrads = _vjp(jx, _jax_flash_branch(jx, mode, h, causal),
                        [jx.jnp.asarray(a) for a in args], cot)
    leaves = [_leaf(a) for a in args]
    got = tab.fused_attention_block(*leaves, h, causal, amp=amp)
    assert got.dtype == (torch.bfloat16 if mode == "pure"
                         else torch.float32)
    _close(got, want, "bf16_max", "out")
    for i, (g, w) in enumerate(zip(_grads(got, leaves, cot), wgrads)):
        _close(g, w, "bf16_max", f"grad {i}")
    assert seen == [{torch.bfloat16}], seen


# -- the rule ----------------------------------------------------------------

TCFG = dict(src_vocab=64, tgt_vocab=64, max_len=16, d_model=32, d_inner=64,
            n_head=4, n_layer=2)
LCFG = dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16, stacked_num=2)
TRUNS = {"fused": dict(fused_attention=True),
         "fused_head": dict(fused_attention=True, fused_head=True),
         "composed": dict(fused_attention=False)}
STEPS = 10
T_CURVE_RTOL, T_FIRST_RTOL = 1e-3, 2e-4
L_CURVE_TOL = dict(rtol=1e-4, atol=1e-5)
DECORATED_RTOL = 1e-5
TAGS = ("__amp_bf16__", "__amp_keep_bf16__", "__amp_match_dtype__")


def _jax_program(build):
    """(main, startup, what ``build`` returned) of a fresh JAX program."""
    import paddle_tpu.fluid as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = build()
    return main, startup, out


def _forward_ops(main):
    """The program's ops before its backward."""
    ops = list(main.desc.global_block.ops)
    types = [op.type for op in ops]
    return ops[:types.index("__vjp__")] if "__vjp__" in types else ops


MCFG = dict(src_vocab=24, tgt_vocab=24, max_len=6, emb_dim=24, hid_dim=24)
MT_LR, MT_BATCH = 5e-3, 16
TC_V, TC_T, TC_B, TC_E, TC_F, TC_LR = 40, 12, 12, 16, 128, 0.002
TC_CURVE_ATOL = 4e-3


class TextConv(torch.nn.Module):
    """The text-conv classifier of tests/test_torch_textconv_train.py (the
    book's ``convolution_net``) from the port's entry points, with its op
    sites and an AMP dict."""

    def __init__(self):
        super().__init__()
        from paddle_tpu_torch import nets
        self.amp = {}
        self.emb = torch.nn.Parameter(torch.zeros(TC_V, TC_E))
        self.conv3, self.conv4 = (nets.SequenceConvPool(
            TC_E, TC_F, k, act="tanh", pool_type="sqrt", device="cpu")
            for k in (3, 4))
        self.fc_w0 = torch.nn.Parameter(torch.zeros(TC_F, 2))
        self.fc_w1 = torch.nn.Parameter(torch.zeros(TC_F, 2))
        self.fc_b = torch.nn.Parameter(torch.zeros(2))

    def op_sites(self):
        return (["lookup_table"] + self.conv3.op_sites()
                + self.conv4.op_sites() + ["mul", "mul", "elementwise_add"])

    def forward(self, words, lens, label):
        x = tnn.lookup_table(self.emb, words, sparse=True, amp=self.amp)
        pools = [self.conv3(x, lens, self.amp), self.conv4(x, lens, self.amp)]
        pred = tnn.fc(pools, [self.fc_w0, self.fc_w1], self.fc_b,
                      act="softmax", amp=self.amp)
        return tnn.mean(tnn.cross_entropy(pred, label))


def _jax_textconv():
    import paddle_tpu.fluid as fluid
    from paddle_tpu.fluid import layers
    words = layers.data(name="words", shape=[TC_T], dtype="int64")
    sl = layers.data(name="sl", shape=[], dtype="int32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    emb = layers.embedding(words, size=[TC_V, TC_E], is_sparse=True)
    pools = [fluid.nets.sequence_conv_pool(
        emb, num_filters=TC_F, filter_size=k, seq_lens=sl, act="tanh",
        pool_type="sqrt") for k in (3, 4)]
    pred = layers.fc(pools, size=2, act="softmax")
    loss = layers.mean(layers.cross_entropy(pred, label))
    fluid.optimizer.Adagrad(learning_rate=TC_LR).minimize(loss)
    return loss


def _trainer(kind, kw):
    """(the JAX build, the port's model) of one trainer configuration."""
    if kind == "mt":
        from paddle_tpu.models import machine_translation as jM
        from paddle_tpu_torch.models import machine_translation as tM
        return (lambda: jM.build(is_train=True, lr=MT_LR, **MCFG),
                tM.MachineTranslation(**MCFG, device="cpu"))
    if kind == "textconv":
        return _jax_textconv, TextConv()
    if kind == "transformer":
        from paddle_tpu.models import transformer as jT
        from paddle_tpu_torch.models import transformer as tT
        return (lambda: jT.build(**TCFG, dropout=0.0, **kw),
                tT.Transformer(**TCFG, dropout=0.0, device="cpu", **kw))
    from paddle_tpu.models import stacked_dynamic_lstm as jL
    from paddle_tpu_torch.models import stacked_dynamic_lstm as tL
    cfg = {k: v for k, v in LCFG.items() if k != "max_len"}
    return (lambda: jL.build(**LCFG),
            tL.StackedDynamicLSTM(**cfg, device="cpu"))


@pytest.mark.parametrize("kind, run", [("transformer", r) for r in TRUNS]
                         + [(k, "default") for k in ("lstm", "mt",
                                                     "textconv")])
def test_rewrite_tags_as_the_jax_rewrite(jx, kind, run):
    """The trainer's op sites are the JAX forward ops the rewrite reads,
    in order; ``pure=None`` picks the JAX program's mode (pure for the
    Transformer, conservative for the LSTM) and every op type gets the
    tags the JAX rewrite gave its ops; the count is the JAX count over
    the forward ops."""
    from paddle_tpu.contrib import mixed_precision as jmp
    build, model = _trainer(kind, TRUNS.get(run, {}))
    main, _, _ = _jax_program(build)
    read = set(tmp.AMP_OP_TYPES) | set(tmp.ELEMENTWISE_OPS) | set(
        tmp.RECURRENT_OPS) | {"lookup_table"}
    assert set(tmp.AMP_OP_TYPES) == set(jmp.AMP_OP_TYPES)
    assert set(tmp.RECURRENT_OPS) == set(jmp.RECURRENT_OPS)
    jmp.rewrite_program_amp(main)
    fwd = [op for op in _forward_ops(main) if op.type in read]
    assert model.op_sites() == [op.type for op in fwd]
    n = tmp.rewrite_program_amp(model)
    assert n == sum(1 for op in fwd if op.attrs.get("__amp_bf16__")
                    or op.attrs.get("__amp_keep_bf16__"))
    for op in fwd:
        tags = tmp.policy(model.amp, op.type)
        got = (tags.bf16, tags.keep_bf16, tags.match_dtype)
        assert got == tuple(bool(op.attrs.get(t)) for t in TAGS), op.type
    pure = any(t.keep_bf16 for t in model.amp.values())
    assert pure == (kind in ("transformer", "textconv"))


# -- training ----------------------------------------------------------------

def _jax_train(main, startup, loss, feeds, fetch=(), finite=True):
    """(initial parameters, loss curve, the ``fetch`` vars after each
    step) of the JAX executor over ``feeds``; the curve must be finite
    unless ``finite`` is False."""
    import paddle_tpu.fluid as fluid
    names = [p.name for p in main.global_block().all_parameters()]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.find_var(n)) for n in names}
    curve, fetched = [], []
    for feed in feeds:
        out = exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        curve.append(float(np.asarray(out[0]).reshape(())))
        fetched.append([np.array(scope.find_var(n)) for n in fetch])
    assert not finite or all(np.isfinite(curve)), curve
    return init, curve, fetched


@contextlib.contextmanager
def _jax_flash_routed():
    """The JAX fused block's flash branch (``nn_ops.py:819-841``) for the
    duration, with the Pallas kernel in interpret mode at 8 x 8 blocks;
    yields a list that counts the kernel's calls. On the CPU the op
    otherwise runs ``ops/attention_block.py``, whose bf16 x bf16 -> fp32
    batched dots XLA's CPU runtime does not execute ("Unsupported element
    type for DotThunk::Execute"), and which the port's block does not
    mirror (it rounds the scores to bf16)."""
    pk = importlib.import_module("paddle_tpu.ops.pallas")
    saved = pk.kernel_enabled, pk.flash_engage, pk.flash_attention
    calls = []

    def interpreted(q, k, v, causal, scale, bq, bk, interpret, *rest):
        calls.append(1)
        return saved[2](q, k, v, causal, scale, bq, bk, True, *rest)
    pk.kernel_enabled = lambda align=128, *dims: True
    pk.flash_engage = lambda tq, tk, d, causal: (8, 8)
    pk.flash_attention = interpreted
    try:
        yield calls
    finally:
        pk.kernel_enabled, pk.flash_engage, pk.flash_attention = saved


def _transformer_feeds():
    rng = np.random.RandomState(2)
    shape = (4, TCFG["max_len"], 1)
    return [tuple(rng.randint(0, TCFG["src_vocab"], shape).astype(np.int64)
                  for _ in range(3)) for _ in range(STEPS)]


@pytest.mark.parametrize("run", sorted(TRUNS))
def test_pure_transformer_follows_the_jax_amp_curve(jx, monkeypatch, run):
    """Transformer-base's ``build`` at 2 + 2 layers under pure AMP, 10 Adam
    steps; the fused head's JAX run takes its Pallas kernel in interpret
    mode, as the port's function computes it."""
    from paddle_tpu.contrib import mixed_precision as jmp
    from paddle_tpu.models import transformer as jT
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models import transformer as tT
    kw = TRUNS[run]
    if kw.get("fused_head"):
        monkeypatch.setenv(FORCE_PALLAS, "1")
    main, startup, (loss, _, _) = _jax_program(
        lambda: jT.build(**TCFG, dropout=0.0, **kw))
    jmp.rewrite_program_amp(main)
    feeds = _transformer_feeds()
    with (_jax_flash_routed() if kw["fused_attention"]
          else contextlib.nullcontext([1])) as calls:
        init, want, _ = _jax_train(main, startup, loss, [
            {"src_ids": s, "tgt_ids": t, "lbl_ids": lb}
            for s, t, lb in feeds])
    assert calls, "the JAX run did not take its flash branch"
    model, opt = tT.build(**TCFG, dropout=0.0, device="cpu", **kw)
    model.load_state_dict(convert.transformer_params_from_jax(init))
    tmp.rewrite_program_amp(model)
    curve = []
    for feed in feeds:
        opt.zero_grad(set_to_none=True)
        loss_t = model(*(torch.from_numpy(x) for x in feed))
        assert loss_t.dtype == torch.float32
        loss_t.backward()
        assert all(p.grad.dtype == torch.float32 for p in model.parameters())
        opt.step()
        curve.append(float(loss_t.detach()))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        dec = model._decoded(*(torch.from_numpy(x) for x in feeds[0][:2]))
    assert dec.dtype == torch.bfloat16
    np.testing.assert_allclose(curve[0], want[0], rtol=T_FIRST_RTOL)
    np.testing.assert_allclose(curve, want, rtol=T_CURVE_RTOL, atol=0.0)


def test_conservative_lstm_follows_the_jax_amp_curve(jx):
    """The stacked LSTM under ``pure=None`` (conservative: its products in
    bf16, its ``dynamic_lstm`` in fp32), 10 Adam steps."""
    from paddle_tpu.contrib import mixed_precision as jmp
    from paddle_tpu.models import stacked_dynamic_lstm as jL
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models import stacked_dynamic_lstm as tL
    main, startup, (loss, _, _) = _jax_program(lambda: jL.build(**LCFG))
    jmp.rewrite_program_amp(main)
    rng = np.random.RandomState(2)
    feeds = []
    for _ in range(STEPS):
        lens = rng.randint(1, LCFG["max_len"] + 1, 4).astype(np.int32)
        feeds.append((rng.randint(0, LCFG["dict_dim"], (4, LCFG["max_len"]))
                      .astype(np.int64), lens,
                      rng.randint(0, 2, (4, 1)).astype(np.int64)))
    init, want, _ = _jax_train(main, startup, loss, [
        {"words": w, "seq_lens": sl, "label": lb} for w, sl, lb in feeds])
    cfg = {k: v for k, v in LCFG.items() if k != "max_len"}
    model, opt, _ = tL.build(**cfg, device="cpu")
    model.load_state_dict(convert.lstm_params_from_jax(
        init, LCFG["stacked_num"]))
    assert tmp.rewrite_program_amp(model) == 5   # the 5 muls
    curve = []
    for feed in feeds:
        opt.zero_grad(set_to_none=True)
        loss_t, _ = model(*(torch.from_numpy(x) for x in feed))
        loss_t.backward()
        opt.step()
        curve.append(float(loss_t.detach()))
    np.testing.assert_allclose(curve, want, **L_CURVE_TOL)


def test_conservative_translation_follows_the_jax_amp_curve(jx):
    """``machine_translation`` under ``pure=None`` (conservative: its
    products in bf16, its two ``dynamic_gru`` in fp32), 10 lazy-Adam steps
    against the JAX executor; ``generate`` stays fp32 (the reference
    rewrites only the training program): bit-equal to an untagged model's
    on the trained weights."""
    from paddle_tpu.contrib import mixed_precision as jmp
    from paddle_tpu.models import machine_translation as jM
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models import machine_translation as tM
    main, startup, (loss, _, _) = _jax_program(
        lambda: jM.build(is_train=True, lr=MT_LR, **MCFG))
    jmp.rewrite_program_amp(main)
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(STEPS):
        src = rng.randint(2, MCFG["src_vocab"],
                          (MT_BATCH, MCFG["max_len"])).astype(np.int64)
        tgt = rng.randint(0, MCFG["tgt_vocab"],
                          (MT_BATCH, MCFG["max_len"] + 1)).astype(np.int64)
        feeds.append((src, tgt[:, :-1], tgt[:, 1:]))
    init, want, _ = _jax_train(main, startup, loss, [
        {"src": a, "tgt_in": b, "tgt_out": c} for a, b, c in feeds])
    model, opt, _ = tM.build(is_train=True, lr=MT_LR, device="cpu", **MCFG)
    model.load_state_dict(convert.mt_params_from_jax(init))
    assert tmp.rewrite_program_amp(model) == 7        # 5 muls, 2 matmuls
    curve = []
    for feed in feeds:
        opt.zero_grad(set_to_none=True)
        loss_t = model(*(torch.from_numpy(x) for x in feed))
        loss_t.backward()
        opt.step()
        curve.append(float(loss_t.detach()))
    np.testing.assert_allclose(curve, want, **L_CURVE_TOL)
    plain = tM.MachineTranslation(**MCFG, device="cpu")
    plain.load_state_dict(model.state_dict())
    src = torch.from_numpy(feeds[0][0])
    for a, b in zip(model.generate(src), plain.generate(src)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_pure_textconv_follows_the_jax_amp_curve(jx):
    """The text-conv classifier under ``pure=None`` (pure: no recurrent
    op): the embedding bf16 into ``sequence_conv``, which multiplies it
    with the fp32 filter in fp32 (the JAX ``einsum`` promotes them); the
    head's products bf16, its softmax bf16, the loss fp32. 10 Adagrad
    steps; the curve within atol 4e-3: the two sides round the softmax's
    p in [0.5, 1) to bf16 (steps of 2**-8) op by op on the JAX side, once
    on the port's, and -log(p) of a row moves by up to 2**-8 / p <= 7.8e-3
    where they land on neighbours (the mean of 12 rows: 1.35e-3 seen)."""
    from paddle_tpu.contrib import mixed_precision as jmp
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import convert
    main, startup, loss = _jax_program(_jax_textconv)
    jmp.rewrite_program_amp(main)
    rng = np.random.RandomState(7)
    feeds = []
    for _ in range(STEPS):
        words = rng.randint(0, TC_V, (TC_B, TC_T)).astype(np.int64)
        lens = rng.randint(1, TC_T + 1, TC_B).astype(np.int32)
        lens[0] = TC_T
        valid = np.arange(TC_T)[None, :] < lens[:, None]
        label = (2 * ((words >= TC_V // 2) & valid).sum(1) > lens).astype(
            np.int64)[:, None]
        feeds.append((words, lens, label))
    init, want, _ = _jax_train(main, startup, loss, [
        {"words": w, "sl": sl, "label": lb} for w, sl, lb in feeds])
    model = TextConv()
    model.load_state_dict(convert.textconv_params_from_jax(init))
    assert tmp.rewrite_program_amp(model) == 3     # the table, 2 muls
    opt = topt.Adagrad(model.parameters(), learning_rate=TC_LR)
    curve = []
    for feed in feeds:
        opt.zero_grad(set_to_none=True)
        loss_t = model(*(torch.from_numpy(a) for a in feed))
        assert loss_t.dtype == torch.float32
        loss_t.backward()
        opt.step()
        curve.append(float(loss_t.detach()))
    np.testing.assert_allclose(curve, want, rtol=0.0, atol=TC_CURVE_ATOL)


def _decorated_jax(jx, n_in, opt_kw, dec_kw, feeds, finite=True):
    """The JAX decorated program of tests/test_contrib.py:39-100: one fc,
    the mean squared error, SGD under ``decorate``."""
    import paddle_tpu.fluid as fluid
    from paddle_tpu.contrib import mixed_precision as jmp
    from paddle_tpu.fluid import layers

    def build():
        x = layers.data(name="x", shape=[n_in], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        loss = layers.mean(layers.square_error_cost(layers.fc(x, size=1), y))
        jmp.decorate(fluid.optimizer.SGD(**opt_kw), **dec_kw).minimize(loss)
        return loss
    main, startup, loss = _jax_program(build)
    main.random_seed = 9
    w_name, b_name = (p.name for p in main.global_block().all_parameters())
    init, curve, scales = _jax_train(
        main, startup, loss, [{"x": x, "y": y} for x, y in feeds],
        fetch=[tmp.LOSS_SCALING], finite=finite)
    return init[w_name], init[b_name], curve, [float(s[0][0])
                                               for s in scales]


def _decorated_port(w, b, opt_kw, dec_kw, feeds):
    from paddle_tpu_torch.optimizer import SGD
    w = torch.nn.Parameter(torch.from_numpy(w))
    b = torch.nn.Parameter(torch.from_numpy(b))
    opt = tmp.decorate(SGD([w, b], **opt_kw), **dec_kw)
    curve, scales = [], []
    for x, y in feeds:
        opt.zero_grad()
        loss = tnn.mean(tnn.square_error_cost(
            tnn.fc(torch.from_numpy(x), w, b), torch.from_numpy(y)))
        opt.minimize(loss)
        curve.append(float(loss.detach()))
        scales.append(float(opt.loss_scaling[0]))
    return curve, scales


def test_decorate_shrinks_the_scale_as_the_jax_decorator(jx):
    """One overflow holds the scale, two in a row halve it, the counter
    starts again after: 1024, 1024, 512, 512, 256 (tests/test_contrib.py:
    67-100), bit-equal to the JAX program's."""
    opt_kw = dict(learning_rate=0.0)
    dec_kw = dict(init_loss_scaling=1024.0, use_dynamic_loss_scaling=True,
                  incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                  decr_ratio=0.5)
    y = np.zeros((2, 1), np.float32)
    feeds = [(np.ones((2, 4), np.float32), y)] + [
        (np.full((2, 4), np.inf, np.float32), y)] * 4
    w, b, _, want = _decorated_jax(jx, 4, opt_kw, dec_kw, feeds,
                                   finite=False)
    _, scales = _decorated_port(w, b, opt_kw, dec_kw, feeds)
    assert scales == want == [1024.0, 1024.0, 512.0, 512.0, 256.0]


def test_decorated_sgd_follows_the_jax_curve(jx):
    """tests/test_contrib.py:39-64: SGD 0.05 under a dynamic scale from
    2**8 growing every 5 clean steps, 30 steps; the curve within rtol 1e-5
    (fp32 on both sides), the scale bit-equal at every step."""
    opt_kw = dict(learning_rate=0.05)
    dec_kw = dict(init_loss_scaling=2.0 ** 8, use_dynamic_loss_scaling=True,
                  incr_every_n_steps=5, decr_every_n_nan_or_inf=2)
    rng = np.random.RandomState(0)
    w_true = rng.rand(10, 1).astype(np.float32)
    feeds = []
    for _ in range(30):
        x = rng.rand(16, 10).astype(np.float32)
        feeds.append((x, x @ w_true))
    w, b, want, want_scales = _decorated_jax(jx, 10, opt_kw, dec_kw, feeds)
    curve, scales = _decorated_port(w, b, opt_kw, dec_kw, feeds)
    np.testing.assert_allclose(curve, want, rtol=DECORATED_RTOL)
    assert scales == want_scales
    assert curve[-1] < curve[0] * 0.5 and scales[-1] > 2.0 ** 8


def test_mixed_precision_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; import paddle_tpu_torch.contrib.mixed_precision; "
            "import paddle_tpu_torch.models.transformer; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- on the card -------------------------------------------------------------

CARD_CFG = dict(src_vocab=256, tgt_vocab=256, max_len=32, d_model=128,
                d_inner=256, n_head=2, n_layer=2)
CARD_LOSS_RTOL = 2e-3
CARD_GRAD_TOL = 0.1


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("head", [False, True], ids=["composed_head",
                                                     "fused_head"])
def test_cuda_pure_amp_step_runs_the_bf16_kernels(cuda_device, monkeypatch,
                                                  head):
    """One pure-AMP Transformer step (2 + 2 layers, d_model 128, 2 heads of
    64, T 32, batch 4) on the card: the flash forward and backward launch
    6 times each and every call hands them bf16 q, k, v and dO; with the
    fused head the fused-CE pair launches once each on bf16 x and W. The
    loss within rtol 2e-3 and each parameter's gradient within 10 % of
    its norm of the same step on the CPU. The products round as on the
    CPU (fp32 sums of bf16 operands, one rounding to bf16, whatever
    ``allow_bf16_reduced_precision_reduction`` says), but sum in another
    order, and the bf16 flash kernels, softmax and layer norm round at
    other points than the CPU's plain versions; the gradients of one
    step at this width are small sums of bf16 terms that cancel, so a
    few flipped bf16 steps move them by percents. On the CPU alone the
    fp32 and the AMP step's gradients differ by up to 6.9 % of a
    gradient's norm (median 3.1 %), the port's and the JAX executor's
    AMP gradients by 2-8 %; an H100 (700 W) gave 5.6 % at most (median
    2.3-2.4 %, the largest the last layer norm's bias), so the bound
    keeps 1.8x over it and is not lowered. The dtype checks, not this
    bound, tell bf16 from fp32."""
    from paddle_tpu_torch.models import transformer as tT
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels import fused_ce as tfc
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    calls = []

    def spy(module, name, n_args):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            if args[0].is_cuda:
                calls.append((name, {a.dtype for a in args[:n_args]}))
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    spy(tfa, "flash_fwd", 3)
    spy(tfa, "flash_bwd", 4)                        # q, k, v, dO
    spy(tfc, "fused_ce_fwd", 2)
    spy(tfc, "fused_ce_bwd", 2)
    torch.manual_seed(0)
    kw = dict(fused_attention=True, fused_head=head)
    state = tT.Transformer(**CARD_CFG, dropout=0.0, device="cpu",
                           **kw).state_dict()
    rng = np.random.RandomState(5)
    feed = [torch.from_numpy(rng.randint(
        0, CARD_CFG["src_vocab"], (4, CARD_CFG["max_len"], 1)))
        for _ in range(3)]
    out = {}
    for dev in ("cpu", cuda_device):
        model, _ = tT.build(**CARD_CFG, dropout=0.0, device=dev, **kw)
        model.load_state_dict(state)
        tmp.rewrite_program_amp(model)
        tfa.reset_launches()
        tfc.reset_launches()
        loss = model(*(f.to(dev) for f in feed))
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.float().cpu()
                 for n, p in model.named_parameters()}
        out[str(dev)[:4]] = (float(loss.detach()), grads)
    assert tfa.LAUNCHES["flash_fwd"] == 6 and tfa.LAUNCHES["flash_bwd"] == 6
    assert tfc.LAUNCHES == {"fused_ce_fwd": int(head),
                            "fused_ce_bwd": int(head)}
    assert sorted({name for name, _ in calls}) == sorted(
        ["flash_fwd", "flash_bwd"] + (["fused_ce_fwd", "fused_ce_bwd"]
                                      if head else []))
    assert all(dtypes == {torch.bfloat16} for _, dtypes in calls), calls
    (want, want_g), (got, got_g) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(got, want, rtol=CARD_LOSS_RTOL)
    errs = {name: float((got_g[name] - g).norm() / (g.norm() + 1e-12))
            for name, g in want_g.items()}
    worst = max(errs, key=errs.get)
    print(f"loss {got} (CPU {want}); largest gradient error "
          f"{errs[worst]:.4f} ({worst}), median "
          f"{float(np.median(list(errs.values()))):.4f}")
    for name, err in errs.items():
        assert err < CARD_GRAD_TOL, (name, err)
