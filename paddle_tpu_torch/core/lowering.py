"""The block runner of the port (the eager half of
``paddle_tpu/core/lowering.py``): a ``BlockDesc`` run op by op over torch
tensors.

Where the JAX package traces a block once into one function that XLA
compiles (reference: framework/executor.cc:413-456 interprets it op by op
instead), the port interprets it: :func:`emit_op_seq` calls each live op's
emitter (``core/registry.py``) on the tensors of an environment, in
program order. Nothing is compiled; the per-op work is the port's torch
functions, whose CUDA tensors go to the hand-written kernels.

- :func:`analyze_block` and :class:`BlockSignature` are the reference's
  (``:32-112``): liveness from the fetches and the persistable writes (dead
  ops are skipped, so their feeds are not needed), and the state, const
  and created-persistable sets.
- :func:`emit_op_seq` (``:150-198``) keeps the reference's row-sparse
  hooks (``:180-190``, ``core/selected_rows.py``): a sparse-apply
  optimizer op takes a row-sparse gradient intact, ``sum`` and ``scale``
  keep it sparse, every other op gets it densified.
- :func:`build_block_fn` (``:218-262``) returns ``fn(state, consts, feeds,
  step_seed) -> (fetches, new_state)``; randomness is seeded by the
  program's ``random_seed`` when non-zero, else per step. Ops run under
  ``torch.no_grad()``, except the training forwards: a live forward op
  that a live ``__vjp__`` names (``fwd_op_index``) runs with grad
  recording on its own detached inputs (``ops/grad_ops.py``
  ``record_forward``), and the runner keeps its outputs for that
  ``__vjp__`` by op index, so each forward runs once a step, as in the
  compiled JAX step. A ``__remat__`` forward is not kept: its
  ``__vjp__`` replays it. An output that no live op reads and that is
  neither fetched nor state is not kept. Fetches and state are detached,
  and the kept forwards die with the step; a fetched row-sparse gradient
  comes back dense (``:244-248``).
- :class:`BlockRunner` mirrors ``CompiledBlock`` (``:825`` ``__call__``,
  ``obs_label``): one per (program version, feeds, fetches), built by the
  executor's cache.
- Programs rewritten by ``contrib/`` run as they are: each emitter reads
  its own AMP and NHWC tags (``ops/nn_ops.py`` lists which). An
  NHWC-resident var is a channels-last tensor of NCHW shape, and a fetch
  comes back in the default contiguous format (``:251-254`` transposes
  it back to NCHW).
- :func:`check_supported` refuses, before any op runs, what the port
  cannot run yet (unregistered op types, ``__sharded__`` tables,
  sub-blocks), each naming the ROADMAP item that takes it. None of these
  falls back to anything.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core import selected_rows as sr
from paddle_tpu_torch.core.registry import (EmitContext, draw_seed, get_op,
                                            has_op)

# every emitter registers itself on import
from paddle_tpu_torch.ops import (basic, beam_ops,  # noqa: F401
                                  grad_ops, kv_attention, lod_ops, math_ops,
                                  metric_ops, misc_ops, nn_ops,
                                  optimizer_ops, rnn_ops, sequence_ops)


@dataclass(frozen=True)
class BlockSignature:
    """Static analysis of a block: which names are feeds, which come from
    the scope (split into mutated state vs read-only consts), which are
    fetched, and which ops are live for this (feed, fetch) signature."""

    feed_names: Tuple[str, ...]
    fetch_names: Tuple[str, ...]
    state_names: Tuple[str, ...]       # scope vars read and/or (re)written
    const_names: Tuple[str, ...]       # scope vars only read
    created_persistable: Tuple[str, ...]  # persistables first created here
    live_ops: Tuple[int, ...]          # indices of ops that execute


def analyze_block(block: ir.BlockDesc, feed_names: Sequence[str],
                  fetch_names: Sequence[str]) -> BlockSignature:
    def is_persistable(n: str) -> bool:
        return block.has_var(n) and block.var(n).persistable

    # Liveness: an op executes if it contributes to a fetch or writes
    # persistable state; dead subgraphs (the loss ops of a test program
    # when only the prediction is fetched) are skipped, so their feeds are
    # not required.
    needed = set(fetch_names)
    live_rev: List[int] = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if op.type in ("feed", "fetch"):
            continue
        outs = op.output_names()
        if (set(outs) & needed) or any(is_persistable(n) for n in outs):
            live_rev.append(i)
            needed.update(op.input_names())
    live = tuple(reversed(live_rev))

    defined = set(feed_names)
    from_scope: List[str] = []
    written: set = set()
    for i in live:
        op = block.ops[i]
        for name in op.input_names():
            if name not in defined and name not in from_scope:
                from_scope.append(name)
        for name in op.output_names():
            defined.add(name)
            written.add(name)

    state, const, created = [], [], []
    for n in from_scope:
        if n in written and is_persistable(n):
            state.append(n)
        else:
            const.append(n)
    for n in written:
        if is_persistable(n) and n not in from_scope:
            created.append(n)

    # fetches not produced by the block must come from the scope
    for n in fetch_names:
        if n not in defined and n not in from_scope and n not in const:
            const.append(n)

    return BlockSignature(
        feed_names=tuple(feed_names),
        fetch_names=tuple(fetch_names),
        state_names=tuple(state),
        const_names=tuple(const),
        created_persistable=tuple(sorted(created)),
        live_ops=live,
    )


def check_supported(program: ir.ProgramDesc) -> None:
    """Raise ``NotImplementedError`` for a program the port cannot run
    yet, naming every cause and the ROADMAP item that takes it. Called
    when a runner is built, so nothing has run when it raises."""
    missing = sorted({op.type for b in program.blocks for op in b.ops
                      if op.type not in ("feed", "fetch")
                      and not has_op(op.type)})
    causes = []
    if missing:
        causes.append(f"op types not registered in the port: {missing} "
                      f"(the dense layers' ops: ROADMAP A6.4b.b; the rest "
                      f"of the op corpus: A6.6)")
    sharded = sorted(n for b in program.blocks for n, v in b.vars.items()
                     if v.attrs.get("__sharded__"))
    if sharded:
        causes.append(f"__sharded__ tables {sharded} (the hot-rows cache "
                      f"behind the executor: ROADMAP A6.9)")
    subs = sorted({op.type for b in program.blocks for op in b.ops
                   if "sub_block" in op.attrs})
    if len(program.blocks) > 1 or subs:
        causes.append(f"sub-blocks ({len(program.blocks)} blocks; ops "
                      f"{subs}; control flow: ROADMAP A6.4b.c)")
    if causes:
        raise NotImplementedError(
            "the port's executor cannot run this program: "
            + "; ".join(causes))


def emit_op_seq(program: ir.ProgramDesc, block: ir.BlockDesc, indices,
                env: Dict[str, Any], base_seed: int, step_seed: int,
                is_test: bool, device=None, record=None,
                tape=None, keep=None) -> None:
    """Run the ops at ``indices`` of ``block`` over ``env`` (mutated in
    place), the reference's interpreter loop (``:150-198``). ``record``
    maps a forward op's index to the ``in_grad_mask`` of its ``__vjp__``:
    that op runs with grad recording, and ``tape`` keeps what it
    recorded, by op index, for the ``__vjp__``. With ``keep``, an output
    whose name is not in it goes nowhere (no op reads it, and it is
    neither fetched nor state), so its memory is freed at once."""
    for i in indices:
        op = block.ops[i]
        spec = get_op(op.type)
        # the reference's rng salt per (block, op), pinned by IR passes
        op_salt = op.attrs.get("__op_index__", i)
        ctx = EmitContext(base_seed=base_seed, step_base_seed=step_seed,
                          op_index=block.idx * 100_000 + op_salt,
                          is_test=is_test, program=program, op=op,
                          device=device, tape=tape)
        ins = {}
        for slot, names in op.inputs.items():
            try:
                ins[slot] = [env[n] for n in names]
            except KeyError as e:
                raise KeyError(
                    f"op {op.type!r} input {slot} references undefined var "
                    f"{e.args[0]!r}; did you run the startup program?") from e
        if any(sr.is_sparse(v) for vals in ins.values() for v in vals) \
                and op.type not in sr.SPARSE_APPLY_OPS:
            outs = sr.try_sparse_emit(op.type, ins, op.attrs)
            if outs is None:
                outs = spec.emit(ctx, sr.densify_ins(ins), op.attrs)
        elif record is not None and i in record:
            outs, tape[i] = grad_ops.record_forward(ctx, op, ins, record[i])
        else:
            outs = spec.emit(ctx, ins, op.attrs)
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            for n, v in zip(names, vals):
                if keep is None or n in keep:
                    env[n] = v


def recorded_forwards(block: ir.BlockDesc, live_ops) -> Dict[int, list]:
    """{forward op index: its ``__vjp__``'s ``in_grad_mask``} for every
    live forward op that a live ``__vjp__`` names, unless it carries
    ``__remat__`` or its ``__vjp__`` takes the lookup fast path (which
    needs no graph)."""
    live = set(live_ops)
    record = {}
    for i in live_ops:
        op = block.ops[i]
        if op.type != "__vjp__":
            continue
        j = op.attrs["fwd_op_index"]
        fwd = ir.OpDesc.from_dict(op.attrs["fwd_op"])
        if (j not in live or block.ops[j].type != fwd.type
                or fwd.attrs.get("__remat__")
                or grad_ops.sparse_path_applies(
                    fwd, op.attrs["in_grad_mask"],
                    op.attrs["out_grad_mask"])):
            continue
        record[j] = list(op.attrs["in_grad_mask"])
    return record


def _contiguous(v):
    return v.contiguous() if isinstance(v, torch.Tensor) else v


def build_block_fn(program: ir.ProgramDesc, block_idx: int,
                   sig: BlockSignature, is_test: bool = False, device=None):
    """Returns ``fn(state, consts, feeds, step_seed) -> (fetches,
    new_state)`` over dicts of tensors."""
    block = program.block(block_idx)
    seed0 = program.random_seed
    record = recorded_forwards(block, sig.live_ops)
    # what the step reads: every live op's inputs, the fetches and the
    # state; an output outside it (a training dropout's Mask, a layer
    # norm's Mean) is dropped as soon as its op returns
    keep = {n for i in sig.live_ops
            for names in block.ops[i].inputs.values() for n in names}
    keep.update(sig.fetch_names, sig.state_names, sig.created_persistable)

    def fn(state: Dict[str, Any], consts: Dict[str, Any],
           feeds: Dict[str, Any], step_seed: int):
        env: Dict[str, Any] = {}
        env.update(consts)
        env.update(state)
        env.update(feeds)
        # a non-zero program seed makes every run reproducible; seed 0
        # draws a new base every step (the reference's convention)
        base = seed0 if seed0 != 0 else draw_seed(0, step_seed)
        with torch.no_grad():
            emit_op_seq(program, block, sig.live_ops, env, base, base,
                        is_test, device, record, {}, keep)
        # an NHWC-resident fetch leaves channels-last (``:251-254``)
        fetches = [_contiguous(sr.densify(env[n])) for n in sig.fetch_names]
        new_state = {n: env[n] for n in sig.state_names if n in env}
        for n in sig.created_persistable:
            if n in env:
                new_state[n] = env[n]
        return fetches, new_state

    return fn


class BlockRunner:
    """A runnable (program block, feed / fetch signature) on one device:
    the eager counterpart of ``CompiledBlock``. It holds the block's
    signature, checked once by :func:`check_supported`, and the
    :func:`build_block_fn` function; each call gathers the state and
    consts from the scope, runs the ops and writes the new state back."""

    # monotonic instance tag: the program label of a block nobody named
    _SEQ = itertools.count(1)

    def __init__(self, program: ir.ProgramDesc, block_idx: int,
                 feed_names: Sequence[str], fetch_names: Sequence[str],
                 is_test: bool = False, device=None):
        self._obs_tag = next(BlockRunner._SEQ)
        check_supported(program)
        block = program.block(block_idx)
        self.sig = analyze_block(block, feed_names, fetch_names)
        self.block = block
        self.device = torch.device("cpu" if device is None else device)
        self._program_desc = program
        self.fn = build_block_fn(program, block_idx, self.sig, is_test,
                                 self.device)

    @property
    def obs_label(self) -> str:
        """The memory metrics' program label: the name a caller pinned on
        the desc (``_obs_name``), else ``block<n>``."""
        return (getattr(self._program_desc, "_obs_name", None)
                or f"block{self._obs_tag}")

    def feed_dtype(self, name: str):
        if self.block.has_var(name):
            return self.block.var(name).dtype
        return None

    def _scope_value(self, name: str, v):
        """A scope value as a tensor on this runner's device: a host array
        is copied there; a tensor on another device raises."""
        if isinstance(v, torch.Tensor):
            if v.device != self.device:
                raise ValueError(
                    f"variable {name!r} lies on {v.device}, the executor "
                    f"runs on {self.device}: a scope is read by executors "
                    f"of its own device only")
            return v
        return torch.as_tensor(np.asarray(v), device=self.device)

    def _gather_state(self, scope):
        state = {}
        for n in self.sig.state_names:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"variable {n!r} not initialized in scope — run the "
                    f"startup program first (reference: two-program "
                    f"convention, framework.py default_startup_program)")
            state[n] = self._scope_value(n, v)
        consts = {}
        for n in self.sig.const_names:
            v = scope.find_var(n)
            if v is None:
                if self.block.has_var(n) and not self.block.var(n).persistable:
                    raise RuntimeError(
                        f"variable {n!r} is neither fed nor initialized — "
                        f"add it to the feed dict (an op in the program "
                        f"consumes it)")
                raise RuntimeError(
                    f"persistable variable {n!r} not found in scope — run "
                    f"the startup program first")
            consts[n] = self._scope_value(n, v)
        return state, consts

    def __call__(self, scope, feeds: Dict[str, Any], step_seed: int):
        state, consts = self._gather_state(scope)
        fetches, new_state = self.fn(state, consts, feeds, step_seed)
        for n, v in new_state.items():
            scope.set_var(n, v)
        return fetches
