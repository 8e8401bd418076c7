"""Carry weights from a JAX scope into the port's models. The layouts
already agree: matrices are [in, out] on both sides.

- :func:`params_from_jax` -> :class:`DecoderLM`.
  ``paddle_tpu.models.transformer.build_decoder_lm_programs`` names every
  parameter explicitly under the prefix ``lm``, and the attention
  weights follow ``fluid/layers/nn.py`` ``_attention_projection_params``
  (``lm_l{i}_attn.wq`` ... ``.wo``).
- :func:`transformer_params_from_jax` -> :class:`Transformer`. ``build``
  names only the two embeddings (``transformer_src_emb``,
  ``transformer_tgt_emb``); every other parameter takes a LayerHelper
  auto-name whose counter is global to the process
  (``layer_norm_<k>.w_0/b_0``, ``fc_<k>.w_0/b_0``,
  ``fused_multi_head_attention_<k>.w_0..w_3`` for wq, wk, wv, wo, and,
  with ``fused_head``, ``fused_linear_ce_<k>.w_0`` for the head in place
  of the last ``fc``; ``fluid/layers/nn.py:884-904``), so the
  same program built twice, or in another process, numbers them
  differently. The names are therefore matched by family and by their
  order within the family, which is the order ``transformer()`` creates
  them in; the port's :func:`transformer_layout` lists its parameters in
  that same order.
- :func:`lstm_params_from_jax` -> :class:`StackedDynamicLSTM`.
  ``paddle_tpu.models.stacked_dynamic_lstm.build`` names nothing: the
  table is ``embedding_<k>.w_0``, the ``fc`` layers ``fc_<k>.w_0`` (the
  previous ``fc``'s output, or the embedding), ``.w_1`` (the previous
  LSTM's output, from the second layer on) and ``.b_0``, the LSTMs
  ``dynamic_lstm_<k>.w_0`` [H, 4H] and ``.b_0`` [1, 7H]; the last ``fc``
  is the softmax head. Matched by family and order, like the above.
- :func:`textconv_params_from_jax` -> the text-conv classifier, which
  the caller assembles from ``nets.SequenceConvPool`` and ``fc``
  (``TEXTCONV_LAYOUT``), and :func:`table_from_jax` -> the table of the
  ``fused_embedding_seq_pool`` op program (``emb_w``).
- :func:`mt_params_from_jax` -> :class:`MachineTranslation`.
  ``paddle_tpu.models.machine_translation.build`` names all fourteen
  parameters itself (``_p("mt.<name>")``): ``mt.src_emb``,
  ``mt.enc_proj.w``/``.b``, ``mt.enc_gru.w``/``.b``, ``mt.h0.w``/``.b``,
  ``mt.tgt_emb``, ``mt.dec_proj.w``, ``mt.dec_gru.w``/``.b``,
  ``mt.attn.w``, ``mt.out.w``/``.b``; the state key is the name without
  ``mt.`` and with ``_`` for ``.``.
- :func:`deepfm_params_from_jax` -> :class:`DeepFM`.
  ``paddle_tpu.models.deepfm.build`` names the table ``deepfm_emb``; its
  four ``fc`` layers take auto-names ``fc_<k>.w_0/b_0``, matched by
  creation order.
- :func:`classifier_params_from_jax` -> any of the seven image
  classifiers (``models/mnist.py``, ``smallnet.py``, ``alexnet.py``,
  ``vgg.py``, ``resnet.py``, ``se_resnext.py``, ``googlenet.py``). Their
  JAX ``build`` functions name nothing: ``conv2d_<k>.w_0/b_0``,
  ``batch_norm_<k>.w_0/b_0`` (scale, bias) with the running statistics
  ``batch_norm_<k>.mean_0/var_0`` (persistable scope variables,
  ``fluid/layers/nn.py:175-177``, which become buffers) and
  ``fc_<k>.w_0/b_0``. The layout is read from the port's model itself:
  its layers (``paddle_tpu_torch.layers``) in registration order, which
  is the JAX creation order, each naming its family and suffixes.
- :func:`seeded_persistables` -> weights for a saved program that has
  none (``tests/torch_programs/``): every persistable of a block drawn
  from a seed by the role its first consumer gives it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from paddle_tpu_torch.models import deepfm as _deepfm
from paddle_tpu_torch.models import machine_translation as mt

_TOP = {"emb": "emb", "lnf_scale": "lnf_scale", "lnf_bias": "lnf_bias",
        "head_w": "head_w"}
_LAYER = re.compile(r"l(\d+)_(ln1_scale|ln1_bias|ln2_scale|ln2_bias|"
                    r"ffn1_w|ffn1_b|ffn2_w|ffn2_b|attn\.w[qkvo])$")


_PREFIX = "lm_"


def state_key(jax_name: str) -> str:
    """The :class:`DecoderLM` state-dict key of one JAX parameter name."""
    if not jax_name.startswith(_PREFIX):
        raise KeyError(f"{jax_name!r} is not a decoder-LM parameter")
    rest = jax_name[len(_PREFIX):]
    if rest in _TOP:
        return _TOP[rest]
    m = _LAYER.match(rest)
    if m is None:
        raise KeyError(f"{jax_name!r} is not a decoder-LM parameter")
    return f"layers.{int(m.group(1))}.{m.group(2).replace('attn.', '')}"


def params_from_jax(arrays: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX scope arrays by parameter name -> a state dict for
    ``DecoderLM.load_state_dict`` (fp32 CPU tensors; ``load_state_dict``
    copies them to the model's device). Every name must be a decoder-LM
    parameter; pass parameters only, not pools or the position table."""
    return {state_key(name):
            torch.from_numpy(np.array(value, dtype=np.float32))
            for name, value in arrays.items()}


# -- Transformer-base (models/transformer.py:135 transformer) ---------------

_EMB = {"transformer_src_emb": "src_emb", "transformer_tgt_emb": "tgt_emb"}
_AUTO = re.compile(r"(layer_norm|fc|fused_multi_head_attention|"
                   r"fused_linear_ce)_(\d+)\.([wb])_(\d+)$")


def transformer_layout(n_layer: int, fused_attention: bool,
                       fused_head: bool = False
                       ) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """The :class:`Transformer`'s auto-named parameters in the order the
    JAX ``transformer()`` creates them: one entry per layer creation,
    ``(family, [(name suffix, state key), ...])``."""
    out = []

    def ln(key):
        out.append(("layer_norm", [("w_0", f"{key}_scale"),
                                   ("b_0", f"{key}_bias")]))

    def attn(key):
        ws = [f"{key}.w{c}" for c in "qkvo"]
        if fused_attention:
            out.append(("fused_multi_head_attention",
                        [(f"w_{i}", w) for i, w in enumerate(ws)]))
        else:
            out.extend(("fc", [("w_0", w)]) for w in ws)

    def ffn(key):
        for n in (1, 2):
            out.append(("fc", [("w_0", f"{key}.ffn{n}_w"),
                               ("b_0", f"{key}.ffn{n}_b")]))

    for i in range(n_layer):
        e = f"encoder.{i}"
        ln(f"{e}.ln1")
        attn(f"{e}.attn")
        ln(f"{e}.ln2")
        ffn(e)
    ln("enc_ln")
    for i in range(n_layer):
        d = f"decoder.{i}"
        ln(f"{d}.ln1")
        attn(f"{d}.self_attn")
        ln(f"{d}.ln2")
        attn(f"{d}.cross_attn")
        ln(f"{d}.ln3")
        ffn(d)
    ln("dec_ln")
    out.append(("fused_linear_ce" if fused_head else "fc",
                [("w_0", "head_w")]))
    return out


def transformer_jax_names(n_layer: int, fused_attention: bool,
                          fused_head: bool = False) -> Dict[str, str]:
    """{state key: JAX name} as a fresh process names ``build``'s
    parameters (every counter from 0)."""
    names = dict((v, k) for k, v in _EMB.items())
    counters: Dict[str, int] = {}
    for fam, params in transformer_layout(n_layer, fused_attention,
                                          fused_head):
        n = counters.get(fam, 0)
        counters[fam] = n + 1
        for suffix, key in params:
            names[key] = f"{fam}_{n}.{suffix}"
    return names


def transformer_state_keys(names) -> Dict[str, str]:
    """{JAX name: :class:`Transformer` state key} for the parameter names
    of one ``build`` (any counter offsets). Infers ``n_layer``, the
    attention variant and the head from the names; raises on a name it
    cannot place or a count that fits no Transformer."""
    groups: Dict[str, Dict[int, set]] = {}
    out = {}
    for name in names:
        if name in _EMB:
            out[name] = _EMB[name]
            continue
        m = _AUTO.match(name)
        if m is None:
            raise KeyError(f"{name!r} is not a Transformer parameter")
        fam, k = m.group(1), int(m.group(2))
        groups.setdefault(fam, {}).setdefault(k, set()).add(
            f"{m.group(3)}_{m.group(4)}")
    if set(out.values()) != set(_EMB.values()):
        raise KeyError(f"missing embeddings: want {sorted(_EMB)}")
    n_ln = len(groups.get("layer_norm", {}))
    if n_ln < 2 or (n_ln - 2) % 5:          # 2n + 1 encoder, 3n + 1 decoder
        raise ValueError(f"{n_ln} layer norms fit no Transformer "
                         f"(want 5 * n_layer + 2)")
    n_layer = (n_ln - 2) // 5
    fused = "fused_multi_head_attention" in groups
    fused_head = "fused_linear_ce" in groups
    layout = transformer_layout(n_layer, fused, fused_head)
    for fam in set(groups) | {f for f, _ in layout}:
        want = [p for f, p in layout if f == fam]
        have = sorted(groups.get(fam, {}))
        if len(have) != len(want):
            raise ValueError(f"{fam}: {len(have)} layers in the scope, "
                             f"{len(want)} in a {n_layer}-layer "
                             f"Transformer (fused_attention={fused}, "
                             f"fused_head={fused_head})")
        for k, params in zip(have, want):
            if groups[fam][k] != {s for s, _ in params}:
                raise ValueError(f"{fam}_{k}: parameters "
                                 f"{sorted(groups[fam][k])}, want "
                                 f"{sorted(s for s, _ in params)}")
            for suffix, key in params:
                out[f"{fam}_{k}.{suffix}"] = key
    return out


def transformer_params_from_jax(arrays: Dict[str, np.ndarray]
                                ) -> Dict[str, torch.Tensor]:
    """JAX scope arrays of one ``build``'s parameters -> a state dict for
    ``Transformer.load_state_dict`` (fp32 CPU tensors). Raises on a name
    that is not a parameter of ``build``, a count that fits no
    Transformer, or a shape that disagrees with the embeddings'
    widths."""
    keys = transformer_state_keys(arrays)
    state = {keys[n]: torch.from_numpy(np.array(v, dtype=np.float32))
             for n, v in arrays.items()}
    vs, m = state["src_emb"].shape
    vt = state["tgt_emb"].shape[0]
    inner = state["encoder.0.ffn1_w"].shape[1] \
        if "encoder.0.ffn1_w" in state else None
    for key, t in state.items():
        if key.endswith(("_scale", "_bias", "ffn2_b")):
            want = (m,)
        elif key.endswith("ffn1_w"):
            want = (m, inner)
        elif key.endswith("ffn1_b"):
            want = (inner,)
        elif key.endswith("ffn2_w"):
            want = (inner, m)
        elif key == "head_w":
            want = (m, vt)
        elif key == "tgt_emb":
            want = (vt, m)
        elif key == "src_emb":
            want = (vs, m)
        else:                                 # attention projections
            want = (m, m)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want {want}")
    return state


# -- stacked dynamic LSTM (models/stacked_dynamic_lstm.py:17 lstm_net) -------

_LSTM_AUTO = re.compile(r"(embedding|fc|dynamic_lstm)_(\d+)\.([wb]_\d+)$")


def lstm_layout(stacked_num: int) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """The :class:`StackedDynamicLSTM`'s parameters in the order the JAX
    ``lstm_net`` creates them: ``(family, [(name suffix, state key), ...])``
    per layer creation."""
    out = [("embedding", [("w_0", "emb")])]
    for i in range(stacked_num):
        fc = [("w_0", f"layers.{i}.fc_w0")]
        if i:
            fc.append(("w_1", f"layers.{i}.fc_w1"))
        out.append(("fc", fc + [("b_0", f"layers.{i}.fc_b")]))
        out.append(("dynamic_lstm", [("w_0", f"layers.{i}.lstm_w"),
                                     ("b_0", f"layers.{i}.lstm_b")]))
    out.append(("fc", [("w_0", "head_w0"), ("w_1", "head_w1"),
                       ("b_0", "head_b")]))
    return out


def lstm_jax_names(stacked_num: int) -> Dict[str, str]:
    """{state key: JAX name} as a fresh process names ``build``'s
    parameters (every counter from 0)."""
    names: Dict[str, str] = {}
    counters: Dict[str, int] = {}
    for fam, params in lstm_layout(stacked_num):
        n = counters.get(fam, 0)
        counters[fam] = n + 1
        for suffix, key in params:
            names[key] = f"{fam}_{n}.{suffix}"
    return names


def _auto_state_keys(names, pattern, layout, what: str, model: str
                     ) -> Dict[str, str]:
    """{JAX name: state key} for auto-named parameters (``pattern``
    matches family, counter and suffix), matched to ``layout``'s
    ``(family, [(suffix, state key), ...])`` entries by family and by
    counter order. Raises on a name that is no ``what`` parameter and on a
    layer count or parameter set that differs from ``model``'s."""
    groups: Dict[str, Dict[int, set]] = {}
    for name in names:
        m = pattern.match(name)
        if m is None:
            raise KeyError(f"{name!r} is not a {what} parameter")
        groups.setdefault(m.group(1), {}).setdefault(
            int(m.group(2)), set()).add(m.group(3))
    out = {}
    for fam in sorted(set(groups) | {f for f, _ in layout}):
        want = [p for f, p in layout if f == fam]
        have = sorted(groups.get(fam, {}))
        if len(have) != len(want):
            raise KeyError(f"{fam}: {len(have)} layers in the scope, "
                           f"{len(want)} in {model}")
        for k, params in zip(have, want):
            if groups[fam][k] != {s for s, _ in params}:
                raise KeyError(f"{fam}_{k}: parameters "
                               f"{sorted(groups[fam][k])}, want "
                               f"{sorted(s for s, _ in params)}")
            for suffix, key in params:
                out[f"{fam}_{k}.{suffix}"] = key
    return out


def lstm_state_keys(names, stacked_num: int) -> Dict[str, str]:
    """{JAX name: :class:`StackedDynamicLSTM` state key} for the parameter
    names of one ``build`` (any counter offsets). Raises on a name that is
    no parameter of ``lstm_net`` (an unused one) and on a layer or a
    parameter that the names lack (a missing one)."""
    return _auto_state_keys(names, _LSTM_AUTO, lstm_layout(stacked_num),
                            "stacked-LSTM",
                            f"a {stacked_num}-layer stacked LSTM")


def lstm_params_from_jax(arrays: Dict[str, np.ndarray], stacked_num: int
                         ) -> Dict[str, torch.Tensor]:
    """JAX scope arrays of one ``build``'s parameters -> a state dict for
    ``StackedDynamicLSTM.load_state_dict`` (fp32 CPU tensors). Raises on a
    missing or an unused name, and on a shape that fits no stacked LSTM
    (a [1, 4H] LSTM bias has no peepholes; the model wants [1, 7H])."""
    keys = lstm_state_keys(arrays, stacked_num)
    state = {keys[n]: torch.from_numpy(np.array(v, dtype=np.float32))
             for n, v in arrays.items()}
    emb_dim = state["emb"].shape[1]
    hid = state["layers.0.lstm_w"].shape[0]
    classes = state["head_b"].shape[0]
    for key, t in state.items():
        if key == "emb":
            continue
        if key.endswith("lstm_w"):
            want = (hid, 4 * hid)
        elif key.endswith("lstm_b"):
            want = (1, 7 * hid)
        elif key.endswith("fc_b"):
            want = (4 * hid,)
        elif key.endswith("fc_w0"):
            want = (emb_dim if key.startswith("layers.0.") else 4 * hid,
                    4 * hid)
        elif key.endswith("fc_w1"):
            want = (hid, 4 * hid)
        elif key == "head_w0":
            want = (4 * hid, classes)
        elif key == "head_w1":
            want = (hid, classes)
        else:                                 # head_b
            want = (classes,)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want {want}")
    return state


# -- machine translation (models/machine_translation.py:49 build) ------------

MT_NAMES = ("mt.src_emb", "mt.enc_proj.w", "mt.enc_proj.b", "mt.enc_gru.w",
             "mt.enc_gru.b", "mt.h0.w", "mt.h0.b", "mt.tgt_emb",
             "mt.dec_proj.w", "mt.dec_gru.w", "mt.dec_gru.b", "mt.attn.w",
             "mt.out.w", "mt.out.b")


def mt_state_key(jax_name: str) -> str:
    """The :class:`MachineTranslation` state key of one ``mt.*`` name."""
    if jax_name not in MT_NAMES:
        raise KeyError(f"{jax_name!r} is not a machine-translation "
                       f"parameter")
    return jax_name[len("mt."):].replace(".", "_")


def mt_params_from_jax(arrays: Dict[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """JAX scope arrays of the fourteen ``mt.*`` parameters -> a state dict
    for ``MachineTranslation.load_state_dict`` (fp32 CPU tensors). Raises
    on a missing or an unused name, and on a shape that disagrees with the
    widths the tables and the recurrent weights give."""
    missing = sorted(set(MT_NAMES) - set(arrays))
    if missing:
        raise KeyError(f"missing machine-translation parameters: {missing}")
    state = {mt_state_key(n): torch.from_numpy(np.array(v, dtype=np.float32))
             for n, v in arrays.items()}
    (vs, e), vt = state["src_emb"].shape, state["tgt_emb"].shape[0]
    want = mt.param_shapes(vs, vt, e, state["enc_gru_w"].shape[0])
    for key, t in state.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want "
                             f"{want[key]}")
    return state


# -- the text-conv classifier (tests/test_book.py:173; the PaddlePaddle
#    book's understand_sentiment convolution_net) and the op program of
#    tests/test_sparse_grad.py:295 -------------------------------------------

_TEXTCONV_AUTO = re.compile(r"(embedding|sequence_conv|fc)_(\d+)\.([wb]_\d+)$")
TEXTCONV_LAYOUT = (
    ("embedding", [("w_0", "emb")]),
    ("sequence_conv", [("w_0", "conv3.filter"), ("b_0", "conv3.bias")]),
    ("sequence_conv", [("w_0", "conv4.filter"), ("b_0", "conv4.bias")]),
    ("fc", [("w_0", "fc_w0"), ("w_1", "fc_w1"), ("b_0", "fc_b")]))


def textconv_state_keys(names) -> Dict[str, str]:
    """{JAX name: text-conv key of ``TEXTCONV_LAYOUT``} for the parameter
    names of one classifier program (any counter offsets); raises on a
    missing or an unused name."""
    return _auto_state_keys(names, _TEXTCONV_AUTO, TEXTCONV_LAYOUT,
                            "text-conv", "the text-conv classifier")


def textconv_params_from_jax(arrays: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """JAX scope arrays of the text-conv classifier -> its port's
    parameters (fp32 CPU tensors) under the keys of ``TEXTCONV_LAYOUT``:
    ``emb`` [V, E], ``conv3.filter`` [3E, F] and ``conv3.bias`` [F] (the
    first ``sequence_conv_pool``, filter size 3), ``conv4.*`` (the second,
    size 4), ``fc_w0`` [F, C] and ``fc_w1`` [F, C] (the softmax ``fc``'s
    weight per input, c3 then c4) and ``fc_b`` [C]. The program names
    nothing: ``embedding_<k>.w_0``, ``sequence_conv_<k>.w_0/b_0`` and
    ``fc_<k>.w_0/w_1/b_0`` are matched by family and creation order.
    Raises on a missing or an unused name and on a shape that disagrees
    with the table's and the filters' widths."""
    keys = textconv_state_keys(arrays)
    state = {keys[n]: torch.from_numpy(np.array(v, dtype=np.float32))
             for n, v in arrays.items()}
    e = state["emb"].shape[1]
    f, c = state["conv3.filter"].shape[1], state["fc_b"].shape[0]
    want = {"emb": (state["emb"].shape[0], e), "conv3.filter": (3 * e, f),
            "conv3.bias": (f,), "conv4.filter": (4 * e, f),
            "conv4.bias": (f,), "fc_w0": (f, c), "fc_w1": (f, c),
            "fc_b": (c,)}
    for key, t in state.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want "
                             f"{want[key]}")
    return state


def table_from_jax(arrays: Dict[str, np.ndarray], name: str = "emb_w"
                   ) -> torch.Tensor:
    """The one table of the ``fused_embedding_seq_pool`` op program,
    ``emb_w`` [V, D] (named explicitly there), as an fp32 CPU tensor."""
    if set(arrays) != {name}:
        raise KeyError(f"want the one table {name!r}, got {sorted(arrays)}")
    t = torch.from_numpy(np.array(arrays[name], dtype=np.float32))
    if t.dim() != 2:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want [V, D]")
    return t


# -- deepfm (models/deepfm.py:19 deepfm) --------------------------------------

_DEEPFM_AUTO = re.compile(r"(fc)_(\d+)\.([wb]_\d+)$")
DEEPFM_LAYOUT = tuple(("fc", [("w_0", f"fc_w{i}"), ("b_0", f"fc_b{i}")])
                      for i in range(len(_deepfm.HIDDEN) + 1))


def deepfm_params_from_jax(arrays: Dict[str, np.ndarray], table: str =
                           "deepfm_emb") -> Dict[str, torch.Tensor]:
    """JAX scope arrays of one deepfm ``build``'s parameters -> a state dict
    for ``DeepFM.load_state_dict`` (fp32 CPU tensors): ``table`` [V, 1+K]
    as ``emb``, the ``fc`` layers in creation order as ``fc_w<i>`` /
    ``fc_b<i>``. Raises on a missing or an unused name and on a shape that
    disagrees with the table's and the first ``fc``'s widths."""
    if table not in arrays:
        raise KeyError(f"missing the deepfm table {table!r}")
    rest = {n: v for n, v in arrays.items() if n != table}
    keys = _auto_state_keys(rest, _DEEPFM_AUTO, DEEPFM_LAYOUT, "deepfm",
                            "deepfm")
    state = {keys[n]: torch.from_numpy(np.array(v, dtype=np.float32))
             for n, v in rest.items()}
    state["emb"] = torch.from_numpy(np.array(arrays[table],
                                             dtype=np.float32))
    v, k1 = state["emb"].shape
    fields = state["fc_w0"].shape[0] // (k1 - 1)
    want = _deepfm.param_shapes(fields, v, k1 - 1)
    for key, t in state.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want "
                             f"{want[key]}")
    return state


# -- the image classifiers (models/mnist.py ... models/googlenet.py) ---------

_IMAGE_AUTO = re.compile(r"(conv2d|batch_norm|fc)_(\d+)\."
                         r"((?:[wb]|mean|var)_\d+)$")


def classifier_layout(model) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """``(family, [(name suffix, state key), ...])`` for each layer of an
    image classifier in registration order (the JAX creation order): its
    modules that name a ``JAX_FAMILY``, with the ``JAX_PARAMS`` they
    hold (a conv without bias has no ``b_0``)."""
    out = []
    for name, m in model.named_modules():
        family = getattr(m, "JAX_FAMILY", None)
        if family is not None:
            out.append((family, [(suffix, f"{name}.{attr}")
                                 for suffix, attr in m.JAX_PARAMS
                                 if getattr(m, attr) is not None]))
    return out


def classifier_state_keys(names, model) -> Dict[str, str]:
    """{JAX name: ``model`` state key} for the parameter and running
    statistic names of one image-classifier ``build`` (any counter
    offsets); raises on a missing or an unused name."""
    return _auto_state_keys(names, _IMAGE_AUTO, classifier_layout(model),
                            "image-classifier", type(model).__name__)


def classifier_params_from_jax(arrays: Dict[str, np.ndarray], model
                               ) -> Dict[str, torch.Tensor]:
    """JAX scope arrays of one image-classifier ``build`` -> a state dict
    for ``model.load_state_dict`` (fp32 CPU tensors): its parameters and
    its batch norms' running statistics, matched by family and creation
    order (:func:`classifier_layout`). Raises on a missing or an unused
    name and on a shape that differs from the model's."""
    keys = classifier_state_keys(arrays, model)
    state = {keys[n]: torch.from_numpy(np.array(v, dtype=np.float32))
             for n, v in arrays.items()}
    want = model.state_dict()
    for key, t in state.items():
        if tuple(t.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)}, want "
                             f"{tuple(want[key].shape)}")
    return state


# -- seeded weights for a saved program (tests/torch_programs/) --------------

# op type -> {input slot: role} for the persistables that are not weights
_ROLES = {"batch_norm": {"Scale": "one", "Bias": "zero", "Mean": "zero",
                         "Variance": "variance"},
          "layer_norm": {"Scale": "one", "Bias": "zero"},
          "conv2d": {"Filter": "filter"}}
BIAS_STD = 0.1


def seeded_persistables(block, seed: int) -> Dict[str, np.ndarray]:
    """{name: array} for every persistable ``VarDesc`` of ``block`` (a
    ``core/ir.py`` ``BlockDesc`` of either package), in its declared shape
    and dtype, from ``np.random.default_rng(seed)`` in name order: batch
    and layer norm scales 1 and biases 0, batch-norm moving means 0 and
    variances uniform in [0.5, 1.5]; a conv filter [O, C, kh, kw] normal
    / sqrt(C kh kw); another matrix or table [n, ...] with n > 1 normal /
    sqrt(n) (the fan-in of an [in, out] weight); a bias ([n] or [1, n])
    normal * ``BIAS_STD``."""
    roles = {}
    for op in block.ops:
        for slot, role in _ROLES.get(op.type, {}).items():
            for n in op.inputs.get(slot, []):
                roles.setdefault(n, role)
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(n for n, v in block.vars.items() if v.persistable):
        vd = block.vars[name]
        shape = tuple(vd.shape)
        role = roles.get(name)
        if role == "one":
            a = np.ones(shape)
        elif role == "zero":
            a = np.zeros(shape)
        elif role == "variance":
            a = rng.uniform(0.5, 1.5, shape)
        elif role == "filter":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif len(shape) >= 2 and shape[0] > 1:
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        else:
            a = rng.standard_normal(shape) * BIAS_STD
        out[name] = a.astype(vd.dtype)
    return out
