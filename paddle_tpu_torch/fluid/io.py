"""Model I/O of the port (the saved-model half of
``paddle_tpu/fluid/io.py``; reference: python/paddle/fluid/io.py
save_vars :222, save_persistables :270, load_persistables :490,
save_inference_model :570, load_inference_model :704).

The on-disk layout is the JAX package's, byte for byte where it is JSON:
one ``.npy`` per variable (``/`` in a name written as ``__``), a
``__manifest__.json`` with the names and each file's CRC32, and for an
inference model the pruned program in ``__model__.json`` (``{"program",
"feed_names", "fetch_names"}``). So a directory written by either package
loads on the other.

- :func:`load_vars` checks every file against its manifest CRC32 before
  it loads anything from it (a mismatch counts
  ``paddle_checkpoint_crc_failures_total`` and raises
  :class:`~paddle_tpu_torch.fluid.sharded_io.ChecksumError`) and puts the
  arrays straight onto the executor's device.
- The chaos site ``ckpt.write_var`` fires before each file is written
  (``faults.inject``) and may tear it after its checksum is recorded
  (``faults.mutate_file``), as in the reference.
- ``main_program=None`` is the default main program (``_need_program``,
  ``:50``).
- :func:`save_checkpoint` / :func:`load_checkpoint` (``:216-256``): the
  persistables under ``<dir>/checkpoint_<step>``, the newest
  ``max_num_checkpoints`` kept.
- Not ported: the sharded layout (``sharded=True`` and a per-shard
  directory raise; ROADMAP A6.9) and ``AsyncCheckpointer`` (ROADMAP
  A6.4b).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from paddle_tpu_torch import device as _device
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.scope import global_scope
from paddle_tpu_torch.fluid import framework, sharded_io
from paddle_tpu_torch.utils import faults

_MODEL_FILENAME = "__model__.json"
_MANIFEST = "__manifest__.json"


def _var_path(dirname: str, name: str) -> str:
    return os.path.join(dirname, name.replace("/", "__") + ".npy")


def _need_program(main_program):
    return main_program if main_program is not None \
        else framework.default_main_program()


def _refuse_sharded():
    raise NotImplementedError("the sharded checkpoint layout is not ported "
                              "(ROADMAP A6.9)")


def _persistable_names(program) -> List[str]:
    return sorted({vd.name for vd in program.desc.global_block.vars.values()
                   if vd.persistable})


def _host_array(val) -> np.ndarray:
    if not isinstance(val, torch.Tensor):
        return np.asarray(val)
    if val.dtype == torch.bfloat16:
        raise TypeError("a bfloat16 variable has no numpy dtype to save "
                        "(not ported)")
    return val.detach().cpu().numpy()


def _write_snapshot_dir(dirname: str, snapshot) -> List[str]:
    """Serialize {name: ndarray} to ``dirname`` with the manifest — the one
    definition of the layout :func:`load_vars` reads back. Each file's
    CRC32 is recorded in the manifest."""
    t_start = time.perf_counter()
    os.makedirs(dirname, exist_ok=True)
    crcs = {}
    n_bytes = 0
    for name, arr in snapshot.items():
        path = _var_path(dirname, name)
        faults.inject("ckpt.write_var")
        np.save(path, arr)
        crcs[name] = sharded_io._crc32_file(path)
        faults.mutate_file("ckpt.write_var", path)   # tear post-checksum
        n_bytes += os.path.getsize(path)
    with open(os.path.join(dirname, _MANIFEST), "w") as f:
        json.dump({"vars": sorted(snapshot), "crc32": crcs}, f)
    sharded_io.CKPT_SAVE_BYTES.labels(layout="plain").inc(n_bytes)
    sharded_io.CKPT_SAVE_SECONDS.labels(layout="plain").observe(
        time.perf_counter() - t_start)
    return sorted(snapshot)


def save_vars(executor, dirname, main_program=None,
              vars: Optional[List[str]] = None, predicate=None,
              filename=None, scope=None, sharded=False):
    """reference: io.py:222. The scope's values of ``vars`` (default: the
    program's persistables, filtered by ``predicate``) copied to the host
    and written; a name the scope lacks is skipped, as in the JAX
    package."""
    if sharded:
        _refuse_sharded()
    scope = scope or global_scope()
    if vars is None:
        main_program = _need_program(main_program)
        vars = _persistable_names(main_program)
        if predicate is not None:
            vars = [v for v in vars
                    if predicate(main_program.global_block().var(v))]
    snapshot = {}
    for name in vars:
        val = scope.find_var(name)
        if val is not None:
            snapshot[name] = _host_array(val)
    return _write_snapshot_dir(dirname, snapshot)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    """reference: io.py:270."""
    return save_vars(executor, dirname, main_program, filename=filename,
                     scope=scope)


def _load_device(executor) -> torch.device:
    dev = getattr(executor, "device", None)
    return dev if dev is not None else _device.resolve(None)


def load_vars(executor, dirname, main_program=None,
              vars: Optional[List[str]] = None, predicate=None,
              filename=None, scope=None):
    """reference: io.py load_vars. Reads ``vars`` (default: the manifest's)
    into ``scope``, each checked against the manifest's CRC32 first, onto
    the executor's device."""
    scope = scope or global_scope()
    mpath = os.path.join(dirname, _MANIFEST)
    if not os.path.exists(mpath) and sharded_io.is_sharded_dir(dirname):
        _refuse_sharded()
    crcs = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            mdata = json.load(f)
        crcs = mdata.get("crc32") or {}
        if vars is None:
            vars = mdata["vars"]
    elif vars is None:
        raise FileNotFoundError(f"no manifest at {mpath}")
    dev = _load_device(executor)
    t_start = time.perf_counter()
    loaded = []
    for name in vars:
        path = _var_path(dirname, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no saved tensor for var {name!r} at {path}")
        want = crcs.get(name)
        if want is not None:
            got = sharded_io._crc32_file(path)
            if got != want:
                sharded_io.CKPT_CRC_FAILURES.inc()
                raise sharded_io.ChecksumError(
                    f"var file {path} fails its manifest checksum "
                    f"(recorded {want:#010x}, file is {got:#010x}) — torn "
                    "or corrupt; restore from an older serial")
        scope.set_var(name, torch.from_numpy(np.load(path)).to(dev))
        loaded.append(name)
    sharded_io.CKPT_RESTORE_SECONDS.labels(layout="plain").observe(
        time.perf_counter() - t_start)
    return loaded


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    """reference: io.py:490."""
    return load_vars(executor, dirname, main_program, scope=scope)


def save_inference_model(dirname, feeded_var_names: List[str], target_vars,
                         executor, main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         scope=None):
    """reference: io.py:570 — prune to the feeds and targets, write the
    program and the persistables it references."""
    main_program = _need_program(main_program)
    os.makedirs(dirname, exist_ok=True)
    target_names = [v if isinstance(v, str) else v.name for v in target_vars]

    pruned_block = ir.prune_block(main_program.desc.global_block,
                                  target_names, feeded_var_names)
    pruned = ir.ProgramDesc()
    pruned.random_seed = main_program.desc.random_seed
    pruned.blocks = [pruned_block]

    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME),
              "w") as f:
        json.dump({
            "program": pruned.to_dict(),
            "feed_names": list(feeded_var_names),
            "fetch_names": target_names,
        }, f)
    needed = [n for n, vd in pruned_block.vars.items() if vd.persistable]
    save_vars(executor, dirname, main_program, vars=needed, scope=scope)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """reference: io.py:704 — returns (program, feed_names, fetch_names);
    the program runs in test mode, its persistables are in ``scope`` on
    the executor's device."""
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME)) as f:
        payload = json.load(f)
    desc = ir.ProgramDesc.parse_from_string(
        json.dumps(payload["program"]).encode())
    program = framework.Program(desc)
    program._is_test = True
    load_vars(executor, dirname,
              vars=[n for n, vd in desc.global_block.vars.items()
                    if vd.persistable], scope=scope)
    return program, payload["feed_names"], payload["fetch_names"]


def _param_names(main_program) -> List[str]:
    """Persistables that are parameters (optimizer state is persistable
    but not a parameter)."""
    block = main_program.global_block()
    return [n for n in _persistable_names(main_program)
            if block.has_var(n) and block.var(n).is_parameter]


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    """reference: io.py save_params — parameters only."""
    main_program = _need_program(main_program)
    return save_vars(executor, dirname, main_program,
                     vars=_param_names(main_program), filename=filename,
                     scope=scope)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    """reference: io.py load_params."""
    main_program = _need_program(main_program)
    return load_vars(executor, dirname, main_program,
                     vars=_param_names(main_program), scope=scope)


# -- checkpoints (``io.py:216-256``) ----------------------------------------

def save_checkpoint(executor, checkpoint_dir, trainer_id=0,
                    main_program=None, step=None, max_num_checkpoints=3,
                    scope=None):
    """The program's persistables under ``checkpoint_<step>`` (``step``
    None: one past the newest); only the newest ``max_num_checkpoints``
    directories stay. Returns the step."""
    main_program = _need_program(main_program)
    step = step if step is not None else _latest_step(checkpoint_dir) + 1
    d = os.path.join(checkpoint_dir, f"checkpoint_{step}")
    save_persistables(executor, d, main_program, scope=scope)
    for s in sorted(_all_steps(checkpoint_dir))[:-max_num_checkpoints]:
        shutil.rmtree(os.path.join(checkpoint_dir, f"checkpoint_{s}"),
                      ignore_errors=True)
    return step


def load_checkpoint(executor, checkpoint_dir, serial=None,
                    main_program=None, scope=None):
    """Load ``checkpoint_<serial>`` (None: the newest) into the scope.
    Returns the step."""
    step = serial if serial is not None else _latest_step(checkpoint_dir)
    if step < 0:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
    load_persistables(executor,
                      os.path.join(checkpoint_dir, f"checkpoint_{step}"),
                      main_program, scope=scope)
    return step


def _all_steps(checkpoint_dir):
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in os.listdir(checkpoint_dir):
        if name.startswith("checkpoint_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return out


def _latest_step(checkpoint_dir):
    steps = _all_steps(checkpoint_dir)
    return max(steps) if steps else -1
