"""One replica of the serving fleet (the port's counterpart of
``paddle_tpu/serving/replica.py``): a single-model
:class:`~paddle_tpu_torch.serving.server.ModelServer` process built from
a JSON spec, with the lifecycle protocol the router supervises it by:

* the wire serves IMMEDIATELY (``readyz`` answers ``ready=false`` while
  the engine builds and warms), and the endpoint file is written
  atomically BEFORE warmup so the router can start polling readiness the
  moment the process binds a port;
* ``mark_ready()`` flips ``readyz`` true only after warmup completes --
  the router never routes traffic to a still-warming replica;
* a ``drain`` RPC (or SIGTERM) stops admission, lets in-flight work
  settle, and exits CLEANLY (code 0) -- the rolling-restart primitive;
  SIGKILL remains the crash the router's failover is proven against;
* ``oom_exit`` (default true): a dispatch OOM exits 42 without a reply,
  leaving ``<role>.<pid>.memdump.json`` in ``FLAGS_flight_recorder_dir``
  for the router to classify and replace (``serving/server.py``).

Spec format (``--spec`` file or ``--spec-json`` inline)::

    {"model": {"kind": "decoder_lm", "name": "lm", "slots": true,
               "weights": "/path/lm.npz", "device": "cuda",
               "buckets": [1, 2],
               "params": {"prompt_len": 8, "max_new": 8, "vocab": 32,
                          "d_model": 16, "d_inner": 32, "n_head": 2,
                          "n_layer": 2, "n_slots": 2,
                          "modes": ["prefill_paged", "decode_paged"],
                          "page_size": 4, "kv_codec": "none"}},
     "max_queue_depth": 64, "linger_s": 0.002, "oom_exit": true,
     "env": {"FLAGS_fault_plan": "..."}}

(``env`` is consumed by the SUPERVISOR: ``serving/router.py`` merges it
into the child's environment at spawn.) ``params`` maps as the
reference's ``build_decoder_lm_programs`` reads it: ``prompt_len`` +
``max_new`` is the model's ``cache_len``, ``prompt_buckets`` (default
``[prompt_len]``) the prompt ladder, ``n_slots`` (default 2) the slot
pool; ``modes`` with a paged view (``prefill_paged`` / ``decode_paged``)
selects the paged layout with ``page_size``, ``n_pages`` and
``kv_codec``, any other the contiguous one; ``spec_k`` adds the verify
window. ``"slots": false`` builds the wave engine over ``buckets``
(default ``[1, 2]``).

Port differences (one spec file drives a JAX replica and a port replica
alike: the reference's ``build_engine`` reads only ``kind``, ``name``,
``params``, ``slots`` and ``buckets``):

* ``weights`` (required for ``decoder_lm``) names an ``.npz`` of the
  parameter arrays under their JAX scope names (``lm_emb``,
  ``lm_l0_attn.wq``, ...; ``models/convert.py`` ``params_from_jax``).
  The reference builds its weights from ``params["seed"]`` through the
  JAX startup program, whose random bits the port cannot draw; a spec
  without ``weights`` raises ``ValueError`` -- a replica never serves
  the zeros a ``DecoderLM`` starts from. ``seed`` is ignored.
* ``device``: ``"cuda"`` by default; ``"cpu"`` only when the spec asks.
  A ``cuda`` spec on a machine without a card raises (the router records
  a crash), never falls back to the CPU.
* ``kind: "saved"`` (``ServedModel``) raises ``ValueError``: it needs
  the executor (ROADMAP A6). No ``aot_dir``: eager PyTorch has no
  executable to load.

Run as ``python -m paddle_tpu_torch.serving.replica --spec spec.json
--endpoint-file ep.txt`` -- exactly how
``paddle_tpu_torch.serving.router.Router`` spawns its pool.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np

from paddle_tpu_torch import flags

PAGED_MODES = ("prefill_paged", "decode_paged", "decode_verify_paged")


def build_engine(model_spec: dict):
    """Spec dict -> a warmable serving engine (NOT yet warmed)."""
    kind = model_spec.get("kind", "saved")
    name = model_spec.get("name", "model")
    if kind == "saved":
        raise ValueError(
            "replica spec kind 'saved' (ServedModel) is not in the port: "
            "it needs the ProgramDesc executor (ROADMAP A6)")
    if kind != "decoder_lm":
        raise ValueError(f"unknown model kind {kind!r} in replica spec")
    weights = model_spec.get("weights")
    if not weights:
        raise ValueError(
            "a decoder_lm replica spec needs 'weights': the path to an "
            ".npz of its parameters under their JAX names (the port "
            "cannot draw the reference's seeded startup weights, and a "
            "replica never serves zeros)")
    from paddle_tpu_torch import device as _device
    from paddle_tpu_torch.models import convert
    from paddle_tpu_torch.models.transformer import DecoderLM
    from paddle_tpu_torch.serving import bucketing, engine
    dev = _device.resolve(model_spec.get("device", "cuda"))
    params = dict(model_spec.get("params") or {})
    prompt_len = int(params.get("prompt_len", 16))
    lm = DecoderLM(int(params.get("vocab", 64)),
                   int(params.get("d_model", 32)),
                   int(params.get("d_inner", 64)),
                   int(params.get("n_head", 2)),
                   int(params.get("n_layer", 2)),
                   cache_len=prompt_len + int(params.get("max_new", 16)),
                   device=dev)
    with np.load(weights) as arrays:
        lm.load_state_dict(convert.params_from_jax(
            {k: arrays[k] for k in arrays.files}))
    buckets = params.get("prompt_buckets") or (prompt_len,)
    if model_spec.get("slots", True):
        modes = params.get("modes") or ("prefill_slot", "decode_slot")
        paged = any(m in PAGED_MODES for m in modes)
        kw = dict(page_size=params.get("page_size"),
                  n_pages=params.get("n_pages"),
                  kv_codec=params.get("kv_codec") or "none") if paged else {}
        return engine.make_slot_model(
            name, lm, n_slots=int(params.get("n_slots") or 2),
            prompt_buckets=buckets,
            layout="paged" if paged else "contiguous",
            spec_k=params.get("spec_k"), device=dev, **kw)
    policy = model_spec.get("buckets") or (1, 2)
    return engine.GenerativeModel(
        name, lm, buckets,
        bucketing.BucketPolicy(tuple(int(b) for b in policy)))


def _write_endpoint(path: str, endpoint: str):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(endpoint)
    os.replace(tmp, path)                 # atomic: never read half-written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one ModelServer replica behind serving.router")
    ap.add_argument("--spec", default=None,
                    help="path to the JSON replica spec")
    ap.add_argument("--spec-json", default=None,
                    help="the spec inline (wins over --spec)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (endpoint-file rendezvous)")
    ap.add_argument("--endpoint-file", default=None,
                    help="atomically write 'host:port' here once bound")
    ap.add_argument("--replica-id", default=None,
                    help="pool slot label (metrics / log prefix)")
    args = ap.parse_args(argv)

    if args.spec_json:
        spec = json.loads(args.spec_json)
    elif args.spec:
        with open(args.spec) as f:
            spec = json.load(f)
    else:
        ap.error("one of --spec / --spec-json is required")

    if not flags.get("trace_role"):
        flags.set("trace_role", "replica")

    from paddle_tpu_torch.serving.server import ModelServer
    # oom_exit (default True): a dispatch OOM kills this process
    # WITHOUT acking errors -- the supervising router finds the memdump,
    # classifies the death cause="oom", and replaces the replica with
    # its fallback spec. Spec-gated so an unsupervised replica can keep
    # the settle-with-error behavior.
    server = ModelServer(
        linger_s=float(spec.get("linger_s", 0.002)),
        max_queue_depth=int(spec.get("max_queue_depth", 64)),
        oom_exit=bool(spec.get("oom_exit", True)))

    # serve FIRST (ready=False): readyz answers "not ready" during the
    # build and warmup below, and the endpoint file lands before them so
    # the supervisor can poll instead of guessing at warmup time
    endpoint = server.serve(host=args.host, port=args.port, ready=False)
    if args.endpoint_file:
        _write_endpoint(args.endpoint_file, endpoint)

    # the HTTP scrape endpoint (FLAGS_metrics_port), when enabled,
    # answers GET /readyz with the SAME verdict as the wire readyz
    from paddle_tpu_torch.observability import exporters
    exporters.set_ready_probe(lambda: server.ready)
    exporters.ensure_started()

    # SIGTERM -> drain, not drop: stop admission, settle in-flight,
    # exit 0. SIGKILL stays the hard-crash arm. The spool and flight
    # recorder start from their flags first, here on the main thread,
    # so the recorder's SIGTERM dumper cannot replace this handler later
    from paddle_tpu_torch.observability import tracing
    tracing.active()

    def _sigterm(signum, frame):
        threading.Thread(target=_drain_and_exit, daemon=True).start()

    def _drain_and_exit():
        server.drain(timeout_s=60.0)
        server.request_exit()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass                               # not the main thread (tests)

    server.add_model(build_engine(spec["model"]))
    server.mark_ready()
    print(f"READY {endpoint}", flush=True)

    server.wait_exit()
    # let the drain reply (and any concurrent replies) flush before the
    # listener dies; then leave cleanly so the supervisor sees code 0
    time.sleep(0.3)
    server.stop()
    from paddle_tpu_torch.observability import flight_recorder, spool
    spool.shutdown()
    flight_recorder.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
