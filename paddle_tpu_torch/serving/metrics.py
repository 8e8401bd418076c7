"""Serving telemetry of the port (the port's own copy of
``paddle_tpu/serving/metrics.py``): the metric families the model
server, the slot and wave engines, the page pool, the router and the
autoscaler update, declared in one place so a scrape of
``observability.exporters.MetricsServer`` shows the serving surface at
zero before the first request.

Label conventions: ``model`` carries the operator-chosen model tag
(bounded -- the hosted-model set), ``cause`` / ``outcome`` are
enum-like strings, never ids or paths.

Not here yet: the compile families and their guard
(``paddle_serving_compilations_total``, ``..._aot_fallback_total``,
``forbid_compiles``, ``count_compile``) wait for the port's inference
and AOT item.
"""

from __future__ import annotations

from paddle_tpu_torch.observability import metrics as _metrics

REQUEST_LATENCY = _metrics.histogram(
    "paddle_serving_request_latency_seconds",
    "End-to-end request latency (enqueue to reply ready); p50/p99 come "
    "from the bucket counts", labelnames=("model",))
REQUESTS = _metrics.counter(
    "paddle_serving_requests_total",
    "Requests by terminal outcome: ok | shed | error",
    labelnames=("model", "outcome"))
REQUESTS_APPLIED = _metrics.counter(
    "paddle_serving_requests_applied_total",
    "Requests actually EXECUTED (dedup-visible: a client retry answered "
    "from the idempotency cache does not count — the at-most-once "
    "witness the chaos suite asserts)", labelnames=("model",))
QUEUE_DEPTH = _metrics.gauge(
    "paddle_serving_queue_depth",
    "Requests waiting in the model's admission queue",
    labelnames=("model",))
QUEUE_WAIT = _metrics.histogram(
    "paddle_serving_queue_wait_seconds",
    "Admission-to-dispatch wait (enqueue until the batcher coalesces "
    "the request into a wave, or the slot scheduler pops it for "
    "admission) — the queueing-delay component the depth gauge cannot "
    "show; p50/p99 surface in tools/serve_bench.py",
    labelnames=("model",))
BATCH_OCCUPANCY = _metrics.gauge(
    "paddle_serving_batch_occupancy_ratio",
    "Real rows / bucket rows of the last dispatched batch (padding "
    "waste is 1 - occupancy)", labelnames=("model",))
BATCHES = _metrics.counter(
    "paddle_serving_batches_total",
    "Coalesced batches dispatched to an executable",
    labelnames=("model",))
TOKENS_GENERATED = _metrics.counter(
    "paddle_serving_tokens_generated_total",
    "Tokens emitted by the KV-cache decode path", labelnames=("model",))
DECODE_STEPS = _metrics.counter(
    "paddle_serving_decode_steps_total",
    "Single-token decode executable dispatches", labelnames=("model",))
PREFILLS = _metrics.counter(
    "paddle_serving_prefills_total",
    "Prefill executable dispatches (one per generation wave, or one "
    "per slot admission on the in-flight path)", labelnames=("model",))
TTFT = _metrics.histogram(
    "paddle_serving_ttft_seconds",
    "Time to first token: submit to the first generated token of a "
    "request. On the slot scheduler this is bounded by queue wait + one "
    "prefill; on the wave path it includes the whole wave",
    labelnames=("model",))
INTER_TOKEN = _metrics.histogram(
    "paddle_serving_inter_token_latency_seconds",
    "Per-token gap after the first token (one observation per emitted "
    "token on the slot scheduler — the decode-step cadence)",
    labelnames=("model",))
SLOT_OCCUPANCY = _metrics.gauge(
    "paddle_serving_decode_slot_occupancy_ratio",
    "In-flight requests / decode slots of the slot pool (the in-flight "
    "batching analogue of batch occupancy)", labelnames=("model",))
SLOT_ADMISSIONS = _metrics.counter(
    "paddle_serving_slot_admissions_total",
    "Requests that JOINED a decode slot mid-flight (one per prompt "
    "prefilled into the pool)", labelnames=("model",))
SLOT_EVICTIONS = _metrics.counter(
    "paddle_serving_slot_evictions_total",
    "Slots freed, by cause: eos | max_new | cancelled | error",
    labelnames=("model", "cause"))

# -- speculative decoding families (draft-verify slot engine) -----------
# The acceptance economy of the draft-verify step: proposed counts every
# DRAFT token placed in a verify window, accepted counts the drafts the
# target model kept (accepted <= proposed; the acceptance RATE is their
# ratio). tokens_per_step observes the COMMITTED token count of each
# live slot per verify dispatch (accepted drafts + 1 bonus token), so
# sum/count is the mean acceptance length — the speedup witness.
# Non-speculative decode observes 1.0 per emitted token, keeping the
# family comparable across arms.
SPEC_PROPOSED = _metrics.counter(
    "paddle_serving_spec_proposed_tokens_total",
    "Draft tokens proposed into verify windows (speculative decoding)",
    labelnames=("model",))
SPEC_ACCEPTED = _metrics.counter(
    "paddle_serving_spec_accepted_tokens_total",
    "Draft tokens the target model accepted (longest-prefix match of "
    "the verify dispatch; always <= proposed)", labelnames=("model",))
TOKENS_PER_STEP = _metrics.histogram(
    "paddle_serving_tokens_per_step",
    "Tokens committed per slot per decode dispatch (1.0 on the "
    "sequential path; up to spec_k + 1 under draft-verify — sum/count "
    "is the mean acceptance length)", labelnames=("model",),
    buckets=(1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0, 24.0,
             32.0))

# -- paged KV pool families (serving/kv_pool.py) ------------------------
# The paged layout replaces the single worst-case reservation of the
# contiguous pool with a page economy; these three gauges + the
# eviction counter ARE its accounting (total is static per model, free
# moves with admissions/releases, shared counts pages referenced by
# MORE THAN ONE in-flight slot — the prefix-sharing witness the tests
# refcount against).
KV_PAGES_TOTAL = _metrics.gauge(
    "paddle_kv_pages_total",
    "Pages in the model's KV page pool (static: n_pages per layer "
    "group — the capacity side of the admission rule)",
    labelnames=("model",))
KV_PAGES_FREE = _metrics.gauge(
    "paddle_kv_pages_free",
    "Pages on the free list right now (admission takes "
    "span - shared_prefix_pages of these; cached prefix pages are NOT "
    "free — they evict on demand)", labelnames=("model",))
KV_PREFIX_SHARED_PAGES = _metrics.gauge(
    "paddle_kv_prefix_shared_pages",
    "Pages physically referenced by >= 2 in-flight slots via the "
    "prompt-prefix radix tree (each counted once)",
    labelnames=("model",))
KV_PAGE_EVICTIONS = _metrics.counter(
    "paddle_kv_page_evictions_total",
    "Cached prefix pages dropped from the radix tree, by cause: "
    "capacity (LRU reclaim to satisfy an admission) | reset (engine "
    "reset/warmup scrub)", labelnames=("model", "cause"))

# -- router families (serving/router.py) -------------------------------
# ``replica`` is the router-assigned slot index ("0".."N-1") — bounded
# by the pool size, stable across restarts of the replica in that slot.
ROUTER_REPLICA_UP = _metrics.gauge(
    "paddle_router_replica_up",
    "1 while the replica in this pool slot is alive AND ready (readyz "
    "true), else 0 — the router's routing-eligibility view",
    labelnames=("replica",))
ROUTER_REQUESTS = _metrics.counter(
    "paddle_router_requests_total",
    "Requests routed, by terminal outcome: ok | typed_error | "
    "unavailable", labelnames=("outcome",))
ROUTER_FAILOVERS = _metrics.counter(
    "paddle_router_failovers_total",
    "Re-dispatches of a request to another replica, by cause: "
    "conn_error | breaker_open | dead_sticky | draining",
    labelnames=("cause",))
ROUTER_DRAIN_DURATION = _metrics.histogram(
    "paddle_router_drain_duration_seconds",
    "Observed drain time of a replica (drain RPC begin to in-flight "
    "settled) during restart_replica / rolling restart")
ROUTER_RESTARTS = _metrics.counter(
    "paddle_router_replica_restarts_total",
    "Replica respawns, by cause: crash (supervisor restart-with-"
    "backoff) | rolling (operator-driven drain+replace) | oom "
    "(memdump-witnessed death, replaced with the fallback spec) | "
    "quarantine_retry (cooldown expired on a FAILED slot)",
    labelnames=("cause",))
ROUTER_REPLICA_INFLIGHT = _metrics.gauge(
    "paddle_router_replica_inflight",
    "Requests the router currently has outstanding against this pool "
    "slot — the router-side congestion view the autoscaler reads "
    "instead of object internals", labelnames=("replica",))
ROUTER_REPLICA_QUEUE_DEPTH = _metrics.gauge(
    "paddle_router_replica_queue_depth",
    "Queued requests on the replica (summed over its hosted models, "
    "polled via the stats RPC by the router's monitor thread)",
    labelnames=("replica",))
ROUTER_REPLICA_STATE = _metrics.gauge(
    "paddle_router_replica_state",
    "One-hot replica lifecycle state per pool slot: exactly one of "
    "starting | ready | draining | down | failed is 1",
    labelnames=("replica", "state"))

# -- autoscaler families (serving/autoscaler.py) ------------------------
AUTOSCALER_DECISIONS = _metrics.counter(
    "paddle_autoscaler_decisions_total",
    "Control-loop verdicts, by action: hold | scale_up | scale_down "
    "(one per step; scale actions also appear in the fleet-size trace)",
    labelnames=("action",))
AUTOSCALER_FLEET_SIZE = _metrics.gauge(
    "paddle_autoscaler_fleet_size",
    "Replica counts the reconciler sees, by kind: desired (the "
    "policy's target) | ready (routable now) | total (pool slots "
    "incl. starting/draining)", labelnames=("kind",))
AUTOSCALER_SIGNAL = _metrics.gauge(
    "paddle_autoscaler_signal",
    "The scaling signals of the last step: queue_wait_p99_s (windowed "
    "across the fleet) | queue_depth (summed)", labelnames=("signal",))
AUTOSCALER_SLO_ATTAINMENT = _metrics.gauge(
    "paddle_autoscaler_slo_attainment_ratio",
    "Fraction of windowed queue-wait observations at or under the "
    "policy SLO (1.0 with an empty window — no evidence of breach)")


def histogram_percentile(family, q: float, **labels) -> float:
    """Percentile estimate (upper bucket bound) from an exported
    histogram — how the load tests assert p50/p99 without a client-side
    timer array. Returns 0.0 with no observations."""
    hist = family.labels(**labels)
    buckets, _, count = hist.snapshot()
    if count <= 0:
        return 0.0
    target = q * count
    for ub, cum in buckets:
        if cum >= target:
            return ub
    return buckets[-1][0]


def latency_percentile(model: str, q: float) -> float:
    """Request-latency percentile (see :func:`histogram_percentile`)."""
    return histogram_percentile(REQUEST_LATENCY, q, model=model)


def queue_wait_percentile(model: str, q: float) -> float:
    """Queue-wait percentile (see :func:`histogram_percentile`)."""
    return histogram_percentile(QUEUE_WAIT, q, model=model)


def histogram_exemplar(family, bucket: str = "top", **labels):
    """The trace_id last recorded for a bucket of an exported histogram
    — ``bucket="top"`` returns the exemplar of the HIGHEST bucket that
    has one (the p99-outlier lookup recipe in docs/observability.md:
    slow sample → trace_id → grep the merged trace). Returns None when
    no exemplar was recorded."""
    ex = family.labels(**labels).exemplars()
    if not ex:
        return None
    if bucket == "top":
        return ex[max(ex)]
    return ex.get(float(bucket))
