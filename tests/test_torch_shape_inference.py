"""The port's build-time shape inference (``paddle_tpu_torch/core/
shape_inference.py``: the port's emitters over meta tensors) against the
JAX package's (``paddle_tpu/core/shape_inference.py``: its emitters under
``jax.eval_shape``).

For every op, main and startup, of the tiny builds (mnist, the stacked
LSTM, the Transformer with the fused head, with the composed head, and
with the Noam schedule), the two give the same result: the same outputs
with the same shapes (the batch dim as -1) and dtypes (int64 and float64
results reported as int32 and float32, as the JAX package reports them
with 64-bit types off), or the same skip, or an error on both sides.
Beside them, each ``InferResult`` state on both sides, and the tier rule
that sends meta tensors to the plain versions only inside
``device.abstract_evaluation()``.
"""

import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core import ir as jir
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.shape_inference import abstract_eval_op as jeval
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import stacked_dynamic_lstm as jlstm
from paddle_tpu.models import transformer as jtransformer

from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lowering  # noqa: F401  (registers ops)
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.shape_inference import abstract_eval_op as teval
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

TINY_TRANSFORMER = dict(src_vocab=64, tgt_vocab=64, max_len=8, d_model=32,
                        d_inner=64, n_head=2, n_layer=1)
BUILDS = {
    "mnist": (jmnist, {}),
    "lstm_tiny": (jlstm, dict(dict_dim=50, max_len=8, emb_dim=16,
                              hid_dim=16, stacked_num=2)),
    "transformer_fused_head": (jtransformer, dict(
        TINY_TRANSFORMER, dropout=0.0, fused_attention=True,
        fused_head=True)),
    "transformer_composed_head": (jtransformer, dict(TINY_TRANSFORMER)),
    "transformer_noam": (jtransformer, dict(
        TINY_TRANSFORMER, fused_attention=True, fused_head=True,
        lr_scheduler="noam", lr=2.0)),
}


def _state(res):
    """An InferResult as a comparable value: the outputs, the skip, or
    just "error" (the two packages' exception types differ)."""
    if res.ok:
        return ("ok", {n: (tuple(s), d) for n, s_d in res.outputs.items()
                       for s, d in [s_d]})
    if res.skipped:
        return ("skipped", res.skipped)
    return ("error",)


@pytest.fixture(scope="module")
def programs():
    """The JAX builds' (main, startup) descs, serialized once."""
    out = {}
    for name, (mod, kw) in BUILDS.items():
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup), junique.guard():
            mod.build(**kw)
        out[name] = {"main": main.desc.serialize_to_string(),
                     "startup": startup.desc.serialize_to_string()}
    return out


@pytest.mark.parametrize("part", ["main", "startup"])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_every_op_infers_as_jax(programs, name, part):
    data = programs[name][part]
    jb = jir.ProgramDesc.parse_from_string(data).global_block
    tb = tir.ProgramDesc.parse_from_string(data).global_block
    states, bad = {}, []
    for i, (jop, top) in enumerate(zip(jb.ops, tb.ops)):
        want, got = _state(jeval(jb, jop)), _state(teval(tb, top))
        states[want[0]] = states.get(want[0], 0) + 1
        if got != want:
            bad.append((i, top.type, got, want))
    assert not bad, bad[:5]
    # inference ran: most ops are inferred, none is skipped where JAX
    # inferred (checked above op by op)
    assert states.get("ok", 0) >= len(jb.ops) - 2, states


def test_int64_results_are_reported_as_int32(programs):
    tb = tir.ProgramDesc.parse_from_string(
        programs["mnist"]["main"]).global_block
    top_k = next(op for op in tb.ops if op.type == "top_k")
    res = teval(tb, top_k)
    assert res.outputs[top_k.output("Indices")[0]] == ((-1, 1), "int32")
    assert res.outputs[top_k.output("Out")[0]] == ((-1, 1), "float32")
    acc = next(op for op in tb.ops if op.type == "accuracy")
    outs = teval(tb, acc).outputs
    assert outs[acc.output("Correct")[0]][1] == "int32"


def _one_op(op_type, inputs, attrs=None, shapes=None):
    """The same one-op block on both sides: ``shapes`` {name: (shape,
    dtype)} (shape None: undeclared)."""
    out = []
    for ir_mod in (jir, tir):
        b = ir_mod.BlockDesc()
        for n, (shape, dtype) in (shapes or {}).items():
            b.add_var(ir_mod.VarDesc(name=n, shape=shape, dtype=dtype))
        b.add_var(ir_mod.VarDesc(name="out"))
        op = ir_mod.OpDesc(type=op_type, inputs=inputs,
                           outputs={"Out": ["out"]}, attrs=attrs or {})
        out.append((b, op))
    return out


def _both(case):
    (jb, jop), (tb, top) = case
    return _state(jeval(jb, jop)), _state(teval(tb, top))


@pytest.fixture
def value_reading_op():
    """One op type, registered on both sides, whose emitter reads a
    value of its input (the JAX one under tracing, the port's on a meta
    tensor)."""
    name = "__test_reads_value__"
    jreg.register_op(name)(
        lambda ctx, ins, attrs: {"Out": [ins["X"][0][:int(ins["X"][0][0])]]})
    treg.register_op(name)(
        lambda ctx, ins, attrs: {"Out": [ins["X"][0][:int(ins["X"][0][0]
                                                         .item())]]})
    yield name
    for reg in (jreg, treg):
        reg.OPS.pop(name, None)


def test_every_infer_result_state_on_both_sides(value_reading_op):
    x = {"x": ([-1, 6], "float32")}
    # inferred, the batch dim mapped back to -1
    j, t = _both(_one_op("scale", {"X": ["x"]}, {"scale": 2.0}, x))
    assert j == t == ("ok", {"out": ((-1, 6), "float32")})
    # an op type no registry has
    assert _both(_one_op("frobnicate", {"X": ["x"]}, shapes=x)) == (
        ("skipped", "unregistered-op"),) * 2
    # an input without a declared shape
    assert _both(_one_op("scale", {"X": ["y"]},
                         shapes={"y": (None, "float32")})) == (
        ("skipped", "missing-input-shape"),) * 2
    # an emitter that reads values
    assert _both(_one_op(value_reading_op, {"X": ["x"]},
                         shapes={"x": ([6], "float32")})) == (
        ("skipped", "concrete-value-needed"),) * 2
    # a control-flow op without its program
    assert _both(_one_op("while", {"X": ["x"]}, shapes=x)) == (
        ("skipped", "needs-program"),) * 2
    # B * 6 does not split into rows of 4 at the sentinel, does at 4
    assert _both(_one_op("reshape", {"X": ["x"]}, {"shape": [-1, 3, 4]},
                         x)) == (("skipped", "dynamic-dim-ambiguous"),) * 2
    # a genuine emitter error, carried on the result
    res = teval(*_one_op("reshape", {"X": ["x"]}, {"shape": [5, 7]},
                         {"x": ([2, 6], "float32")})[1])
    assert not res.ok and res.skipped is None and res.error
    j, t = _both(_one_op("reshape", {"X": ["x"]}, {"shape": [5, 7]},
                         {"x": ([2, 6], "float32")}))
    assert j == t == ("error",)


# emitters that read values of a meta tensor, each way torch refuses it
_VALUE_READS = {
    "item": lambda x: x[:int(x[0].item())],
    "bool": lambda x: x * 2 if bool(x.sum() > 0) else x,
    "tolist": lambda x: x[:len([v for v in x.tolist() if v])],
    "numpy": lambda x: x[:int(x.numpy()[0])],
    "nonzero": lambda x: x.nonzero(),
    "boolean mask": lambda x: x[x > 0],
}


def _raises(exc):
    def emit(x):
        raise exc
    return emit


# genuine emitter errors whose messages name value reads
_GENUINE = {
    "numpy": _raises(TypeError("a numpy array is no valid attr here")),
    "item()": _raises(RuntimeError("item() of the attr list is out of "
                                   "range")),
    "tolist": _raises(ValueError("shape.tolist gave 3 dims, want 2")),
    "data-dependent": _raises(NotImplementedError(
        "data-dependent lengths are not ported")),
    "meta, not torch's": _raises(KeyError(
        "Cannot copy out of meta tensor")),
}


@pytest.fixture
def port_emitter():
    """A port-only op type that runs ``_VALUE_READS`` or ``_GENUINE``
    [attr ``kind``] on its input."""
    name = "__test_port_emitter__"
    kinds = dict(_VALUE_READS, **{"genuine " + k: f
                                  for k, f in _GENUINE.items()})
    treg.register_op(name)(lambda ctx, ins, attrs: {
        "Out": [kinds[attrs["kind"]](ins["X"][0])]})
    yield name
    treg.OPS.pop(name, None)


@pytest.mark.parametrize("kind", sorted(_VALUE_READS))
def test_value_reads_on_meta_tensors_need_concrete_values(port_emitter,
                                                          kind):
    (_, _), (tb, top) = _one_op(port_emitter, {"X": ["x"]}, {"kind": kind},
                                {"x": ([6], "float32")})
    assert _state(teval(tb, top)) == ("skipped", "concrete-value-needed")


@pytest.mark.parametrize("kind", sorted(_GENUINE))
def test_genuine_errors_naming_value_reads_stay_errors(port_emitter, kind):
    (_, _), (tb, top) = _one_op(port_emitter, {"X": ["x"]},
                                {"kind": "genuine " + kind},
                                {"x": ([6], "float32")})
    res = teval(tb, top)
    assert _state(res) == ("error",)
    assert res.error_type == type(_GENUINE[kind].__closure__[0]
                                  .cell_contents).__name__


def test_meta_tensors_take_the_plain_versions_only_in_abstract_eval():
    meta = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.uses_kernel(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(meta, meta, meta, False, 1.0)
    with tdevice.abstract_evaluation():
        assert tdevice.uses_kernel(meta) is False
        out, lse = tfa.flash_fwd(meta, meta, meta, False, 1.0)
        assert out.is_meta and tuple(out.shape) == (2, 4, 8)
        with pytest.raises(ValueError, match="several devices"):
            tdevice.uses_kernel(meta, torch.zeros(1))
    with pytest.raises(ValueError, match="unsupported device"):
        tdevice.uses_kernel(meta)
