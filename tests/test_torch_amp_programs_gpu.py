"""AMP and NHWC programs built by the port, run on the card (marked
``gpu``; skips without one). This file imports no JAX: the reference is
a ``CPUPlace()`` executor on the same program from the same scope.

- The tiny Transformer (fused attention, fused head) under pure AMP
  (``rewrite_program_amp``): every step launches 3 x n_layer flash
  forwards and backwards and one fused-CE forward and backward (rows 1-2,
  4-5), each on bf16 operands; the losses within 2e-2 of the CPU's (bf16
  activations rounded at other points by the kernels and the plain
  versions: AMP's bound against fp32 is 0.05).
- The stacked LSTM under auto AMP (conservative): each step launches one
  LSTM forward and one backward a layer (rows 6-7, fp32 kernels); its
  products on bf16 operands. The losses within rtol 1e-4 / atol 1e-5 of
  the CPU's (past the products everything is fp32).
- The shallow ResNet and the SE-ResNeXt block of
  ``tests/test_torch_amp_programs.py`` under NHWC (fp32): every conv on
  channels-last operands; losses and parameters within rtol 1e-4 / atol
  1e-5 of the CPU's (fp32, TF32 off). Under AMP + NHWC against AMP on the
  card: losses within 2e-2 (the same bf16 math through other cuDNN
  algorithms).

Run on the card: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_amp_programs_gpu.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.contrib.layout import rewrite_program_nhwc
from paddle_tpu_torch.contrib.mixed_precision import rewrite_program_amp
from paddle_tpu_torch.fluid.models import resnet, se_resnext
from paddle_tpu_torch.fluid.models import stacked_dynamic_lstm as lstm
from paddle_tpu_torch.fluid.models import transformer
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_ce as fce
from paddle_tpu_torch.ops.kernels import fused_rnn as fr

TOL = dict(rtol=1e-4, atol=1e-5)
AMP_TOL = 2e-2
STEPS = 3
B = 4
TCFG = dict(src_vocab=256, tgt_vocab=256, max_len=32, d_model=64,
            d_inner=128, n_head=2, n_layer=1)
LCFG = dict(dict_dim=50, max_len=8, emb_dim=16, hid_dim=16, stacked_num=2)
CL = torch.channels_last


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _launches():
    return {f"{m.__name__.split('.')[-1]}.{k}": n
            for m in (fa, fce, fr) for k, n in m.LAUNCHES.items()}


def _built(fn, rewrite):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = fn()
    rewrite(main)
    startup.random_seed = 27
    s0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=s0)
    names = sorted(n for n, v in main.desc.global_block.vars.items()
                   if v.persistable)
    scopes = {}
    for dev in ("cpu", "cuda"):
        scopes[dev] = fluid.Scope()
        for n in names:
            scopes[dev].set_var(n, s0.find_var(n).clone().to(dev))
    return main, loss, names, scopes


def _run(main, loss, scope, feeds, place, want=None):
    exe = fluid.Executor(place)
    losses = []
    for i, f in enumerate(feeds):
        before = _launches()
        out = exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
        launched = {k: n - before[k] for k, n in _launches().items()
                    if n != before[k]}
        if want is not None:
            assert launched == want, (i, launched)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
    return np.asarray(losses)


def _amp(main):
    rewrite_program_amp(main)


def _amp_nhwc(main):
    rewrite_program_amp(main)
    rewrite_program_nhwc(main)


def _feeds_t(r):
    shape = (B, TCFG["max_len"], 1)
    return {k: r.randint(3, TCFG["src_vocab"], shape).astype(np.int64)
            for k in ("src_ids", "tgt_ids", "lbl_ids")}


def _feeds_l(r):
    return {"words": r.randint(0, LCFG["dict_dim"],
                               (B, LCFG["max_len"])).astype(np.int64),
            "seq_lens": r.randint(1, LCFG["max_len"] + 1,
                                  (B,)).astype(np.int32),
            "label": r.randint(0, 2, (B, 1)).astype(np.int64)}


def _feeds_img(r):
    return {"data": r.randn(B, 3, 16, 16).astype(np.float32),
            "label": r.randint(0, 10, (B, 1)).astype(np.int64)}


@pytest.mark.gpu
def test_pure_amp_transformer_program_runs_the_bf16_kernels(cuda_device):
    main, loss, _, scopes = _built(lambda: transformer.build(
        **TCFG, dropout=0.0, fused_attention=True, fused_head=True)[0], _amp)
    n = 3 * TCFG["n_layer"]
    want = {"flash_attention.flash_fwd": n, "flash_attention.flash_bwd": n,
            "fused_ce.fused_ce_fwd": 1, "fused_ce.fused_ce_bwd": 1}
    dtypes = []
    real_f, real_c = fa.flash_fwd, fce.fused_ce_fwd

    def flash_fwd(q, *a, **kw):
        dtypes.append(("flash", q.dtype))
        return real_f(q, *a, **kw)

    def fused_ce_fwd(x, *a, **kw):
        dtypes.append(("ce", x.dtype))
        return real_c(x, *a, **kw)
    r = np.random.RandomState(3)
    feeds = [_feeds_t(r) for _ in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "flash_fwd", flash_fwd)
        mp.setattr(fce, "fused_ce_fwd", fused_ce_fwd)
        got = _run(main, loss, scopes["cuda"], feeds, fluid.CUDAPlace(0),
                   want)
    assert dtypes and all(d == torch.bfloat16 for _, d in dtypes)
    ref = _run(main, loss, scopes["cpu"], feeds, fluid.CPUPlace())
    np.testing.assert_allclose(got, ref, rtol=AMP_TOL)


@pytest.mark.gpu
def test_auto_amp_lstm_program_runs_the_fp32_kernels(cuda_device):
    main, loss, names, scopes = _built(lambda: lstm.build(**LCFG)[0], _amp)
    assert not any(op.attrs.get("__amp_keep_bf16__")
                   for op in main.desc.global_block.ops)
    k = LCFG["stacked_num"]
    calls = []
    real = nn_ops.amp_product

    def counted(x, y, keep):
        calls.append(keep)
        return real(x, y, keep)
    r = np.random.RandomState(4)
    feeds = [_feeds_l(r) for _ in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn_ops, "amp_product", counted)
        got = _run(main, loss, scopes["cuda"], feeds, fluid.CUDAPlace(0),
                   {"fused_rnn.lstm_train_fwd": k,
                    "fused_rnn.lstm_train_bwd": k})
    assert calls and not any(calls)
    ref = _run(main, loss, scopes["cpu"], feeds, fluid.CPUPlace())
    np.testing.assert_allclose(got, ref, **TOL)


def _shallow_resnet():
    L = fluid.layers
    img = L.data(name="data", shape=[3, 16, 16], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    c = resnet.conv_bn_layer(img, 8, 3, act="relu")
    c = L.pool2d(c, pool_size=3, pool_stride=2, pool_padding=1,
                 pool_type="max")
    c = resnet.bottleneck_block(c, 4, stride=1, is_train=True)
    p = L.pool2d(c, pool_type="avg", global_pooling=True)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(p, size=10), label))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


def _se_block():
    L = fluid.layers
    img = L.data(name="data", shape=[3, 16, 16], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    c = se_resnext.conv_bn_layer(img, 8, 3, act="relu")
    c = se_resnext.bottleneck_block(c, 8, stride=1, cardinality=4,
                                    reduction_ratio=4, is_train=True)
    p = L.pool2d(c, pool_type="avg", global_pooling=True)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(p, size=10), label))
    fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


@pytest.mark.gpu
@pytest.mark.parametrize("fn", [_shallow_resnet, _se_block],
                         ids=["shallow_resnet", "se_block"])
def test_nhwc_program_on_the_card_matches_the_cpu(cuda_device, fn):
    main, loss, names, scopes = _built(fn, rewrite_program_nhwc)
    formats = []
    real = nn_ops.F.conv2d

    def conv2d(x, w, *a, **kw):
        if x.is_cuda:
            formats.append(x.is_contiguous(memory_format=CL)
                           and w.is_contiguous(memory_format=CL))
        return real(x, w, *a, **kw)
    r = np.random.RandomState(5)
    feeds = [_feeds_img(r) for _ in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn_ops.F, "conv2d", conv2d)
        got = _run(main, loss, scopes["cuda"], feeds, fluid.CUDAPlace(0), {})
    assert formats and all(formats)
    ref = _run(main, loss, scopes["cpu"], feeds, fluid.CPUPlace())
    np.testing.assert_allclose(got, ref, **TOL)
    for n in names:
        np.testing.assert_allclose(scopes["cuda"].find_var(n).cpu().numpy(),
                                   scopes["cpu"].find_var(n).numpy(),
                                   err_msg=n, **TOL)


@pytest.mark.gpu
def test_amp_nhwc_program_on_the_card_follows_amp(cuda_device):
    r = np.random.RandomState(6)
    feeds = [_feeds_img(r) for _ in range(STEPS)]
    losses = {}
    for label, rewrite in (("amp", _amp), ("amp+nhwc", _amp_nhwc)):
        main, loss, _, scopes = _built(_shallow_resnet, rewrite)
        losses[label] = _run(main, loss, scopes["cuda"], feeds,
                             fluid.CUDAPlace(0), {})
    np.testing.assert_allclose(losses["amp+nhwc"], losses["amp"],
                               rtol=AMP_TOL)
