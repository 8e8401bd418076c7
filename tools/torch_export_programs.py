"""Regenerate the saved inference programs the port's executor runs
without JAX: ``tests/torch_programs/<name>/__model__.json``.

Each program is a bench model's ``build(is_train=False)`` in the JAX
package at its defaults (or the tiny widths named below), or one of the
small layer programs whose patterns the predictor's passes fuse
(``fc_lstm_tiny``, ``fc_gru_tiny``, ``seqpool_concat_tiny``: the
``fusion_lstm``, ``fusion_gru`` and ``fusion_seqpool_concat`` ops on the
card), under a fresh ``Program`` pair and a fresh ``unique_name``
generator (so the names are those a fresh process gives, the names
``paddle_tpu_torch.models.convert`` maps), pruned to one fetch and
written by the JAX package's own ``save_inference_model`` from an empty
scope: the program in exactly the saved-model format, and no weights.
``chip_smoke.py`` (phases 22-23), ``tests/test_torch_executor_gpu.py``
and ``tests/test_torch_predictor_gpu.py`` write seeded weights beside a
copy.

Beside them, the training pairs ``tests/torch_programs/<name>/
__main__.json`` and ``__startup__.json`` (:data:`TRAIN_PROGRAMS`): a
bench model's ``build(is_train=True)`` (its backward's ``__vjp__`` ops
and its optimizer ops) and the startup program that initialises its
scope, each ``ProgramDesc.serialize_to_string()`` of the JAX build under
a fresh ``unique_name`` guard. The port loads a pair with
``fluid.Program(ir.ProgramDesc.parse_from_string(...))``. The full-width
pairs are ``chip_smoke.py``'s phase 24; the tiny twins are
``tests/test_torch_train_programs.py``'s and
``tests/test_torch_train_programs_gpu.py``'s.

    JAX_PLATFORMS=cpu python tools/torch_export_programs.py [NAME ...]

writes every program (or the named ones); ``--check`` writes nothing and
exits 1 when a committed file differs from what ``build`` gives now.
Files are compared as JSON values: ``prune_block`` collects the variables
in a set, so their order in the file (not their content) varies with the
process's string hashing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "tests", "torch_programs")
MODEL_FILE = "__model__.json"

# the pass programs' widths: batch rows of T steps of D features, and
# the recurrent cells' hidden width
PASS_T, PASS_D, PASS_H = 8, 16, 16


def _fc_lstm(layers):
    """x -> a bias-free fc (the gate projection) -> dynamic_lstm."""
    x = layers.data(name="x", shape=[PASS_T, PASS_D], dtype="float32")
    sl = layers.data(name="sl", shape=[], dtype="int32")
    proj = layers.fc(x, size=4 * PASS_H, num_flatten_dims=2,
                     bias_attr=False)
    hidden, _ = layers.dynamic_lstm(proj, size=4 * PASS_H, seq_lens=sl)
    return ["x", "sl"], hidden.name


def _fc_gru(layers):
    """x -> a bias-free fc (the gate projection) -> dynamic_gru."""
    x = layers.data(name="x", shape=[PASS_T, PASS_D], dtype="float32")
    sl = layers.data(name="sl", shape=[], dtype="int32")
    proj = layers.fc(x, size=3 * PASS_H, num_flatten_dims=2,
                     bias_attr=False)
    return ["x", "sl"], layers.dynamic_gru(proj, size=PASS_H,
                                           seq_lens=sl).name


def _seqpool_concat(layers):
    """Two SUM sequence pools over the same lengths -> concat on axis 1."""
    a = layers.data(name="a", shape=[PASS_T, PASS_D], dtype="float32")
    b = layers.data(name="b", shape=[PASS_T, PASS_D], dtype="float32")
    sl = layers.data(name="sl", shape=[], dtype="int32")
    pools = [layers.sequence_pool(v, "sum", seq_lens=sl) for v in (a, b)]
    return ["a", "b", "sl"], layers.concat(pools, axis=1).name


# name -> (model module, build kwargs, feed names, fetch: "loss" for the
# model's loss, else the op type whose last output in the program is it),
# or a builder: layers -> (feed names, the fetch's name)
PROGRAMS = {
    "resnet50": ("resnet", {}, ["data"], "softmax"),
    "transformer_base": ("transformer",
                         dict(fused_attention=True, fused_head=True),
                         ["src_ids", "tgt_ids", "lbl_ids"], "loss"),
    "stacked_dynamic_lstm": ("stacked_dynamic_lstm", {},
                             ["words", "seq_lens"], "softmax"),
    "deepfm": ("deepfm", {}, ["feat_ids"], "sigmoid"),
    "mnist": ("mnist", {}, ["pixel"], "softmax"),
    # tiny twins for the card's tests (tests/test_torch_executor_gpu.py)
    "transformer_tiny": ("transformer",
                         dict(src_vocab=64, tgt_vocab=64, max_len=8,
                              d_model=32, d_inner=64, n_head=2, n_layer=1,
                              fused_attention=True, fused_head=True),
                         ["src_ids", "tgt_ids", "lbl_ids"], "loss"),
    "stacked_dynamic_lstm_tiny": ("stacked_dynamic_lstm",
                                  dict(dict_dim=50, max_len=8, emb_dim=16,
                                       hid_dim=16, stacked_num=2),
                                  ["words", "seq_lens"], "softmax"),
    # the fused recurrent and pooling ops, for tests/test_torch_predictor_gpu.py
    "fc_lstm_tiny": _fc_lstm,
    "fc_gru_tiny": _fc_gru,
    "seqpool_concat_tiny": _seqpool_concat,
}


# name -> (model module, build kwargs) of the training pairs
TRAIN_PROGRAMS = {
    # full width, for the card (chip_smoke.py's TRAIN, LSTM, MT, DEEPFM)
    "transformer_base_train": ("transformer",
                               dict(fused_attention=True, fused_head=True)),
    "stacked_dynamic_lstm_train": ("stacked_dynamic_lstm",
                                   dict(dict_dim=5000, max_len=100,
                                        emb_dim=512, hid_dim=512,
                                        stacked_num=3)),
    "machine_translation_train": ("machine_translation",
                                  dict(src_vocab=10000, tgt_vocab=10000,
                                       max_len=32, emb_dim=512,
                                       hid_dim=512)),
    "deepfm_train": ("deepfm", dict(num_fields=26, vocab_size=100000,
                                    embed_dim=16, lr=1e-3)),
    "resnet50_train": ("resnet", {}),
    # tiny twins, for the CPU tests
    "transformer_tiny_train": ("transformer",
                               dict(src_vocab=64, tgt_vocab=64, max_len=8,
                                    d_model=32, d_inner=64, n_head=2,
                                    n_layer=1, dropout=0.0,
                                    fused_attention=True, fused_head=True)),
    "stacked_dynamic_lstm_tiny_train": ("stacked_dynamic_lstm",
                                        dict(dict_dim=50, max_len=8,
                                             emb_dim=16, hid_dim=16,
                                             stacked_num=2)),
    "mnist_train": ("mnist", {}),
    "deepfm_tiny_train": ("deepfm", dict(num_fields=4, vocab_size=64,
                                         embed_dim=8)),
    "machine_translation_tiny_train": ("machine_translation", {}),
}
MAIN_FILE, STARTUP_FILE = "__main__.json", "__startup__.json"


def _last_output(main, op_type: str) -> str:
    ops = [op for op in main.global_block().desc.ops if op.type == op_type]
    if not ops:
        raise ValueError(f"the program has no {op_type!r} op")
    return ops[-1].output("Out")[0]


def program_json(name: str) -> bytes:
    """The ``__model__.json`` bytes of program ``name``, built now."""
    import importlib
    import paddle_tpu.fluid as fluid
    from paddle_tpu.fluid import layers, unique_name
    entry = PROGRAMS[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        if callable(entry):
            feeds, target = entry(layers)
        else:
            module, kwargs, feeds, fetch = entry
            model = importlib.import_module(f"paddle_tpu.models.{module}")
            loss, _, _ = model.build(is_train=False, **kwargs)
            target = (loss.name if fetch == "loss"
                      else _last_output(main, fetch))
    with tempfile.TemporaryDirectory() as d:
        fluid.io.save_inference_model(d, feeds, [target], None,
                                      main_program=main,
                                      scope=fluid.Scope())
        with open(os.path.join(d, MODEL_FILE), "rb") as f:
            return f.read()


def train_json(name: str):
    """``{file name: bytes}`` of training pair ``name``, built now."""
    import importlib
    import paddle_tpu.fluid as fluid
    from paddle_tpu.fluid import unique_name
    module, kwargs = TRAIN_PROGRAMS[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        importlib.import_module(f"paddle_tpu.models.{module}").build(
            is_train=True, **kwargs)
    return {MAIN_FILE: main.desc.serialize_to_string(),
            STARTUP_FILE: startup.desc.serialize_to_string()}


def files_of(name: str):
    """``{file name: bytes}`` of program ``name`` (saved or training)."""
    if name in TRAIN_PROGRAMS:
        return train_json(name)
    return {MODEL_FILE: program_json(name)}


def committed_path(name: str, file: str = MODEL_FILE) -> str:
    return os.path.join(OUT_DIR, name, file)


def is_current(name: str) -> bool:
    """The committed files hold what ``build`` gives now."""
    for file, data in files_of(name).items():
        with open(committed_path(name, file), "rb") as f:
            if json.loads(f.read()) != json.loads(data):
                return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*",
                    help=f"of {sorted(PROGRAMS) + sorted(TRAIN_PROGRAMS)}")
    ap.add_argument("--check", action="store_true",
                    help="compare with the committed files, write nothing")
    args = ap.parse_args(argv)
    stale = []
    for name in args.names or [*PROGRAMS, *TRAIN_PROGRAMS]:
        if args.check:
            if not is_current(name):
                stale.append(name)
            continue
        for file, data in files_of(name).items():
            path = committed_path(name, file)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
            print(f"{path}: {len(data)} bytes")
    if stale:
        print(f"stale: {stale}")
    return 1 if stale else 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)        # the JAX package, from a checkout
    sys.exit(main())
