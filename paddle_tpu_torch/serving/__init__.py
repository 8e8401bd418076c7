"""Serving side of the port (counterpart of ``paddle_tpu/serving``): the
page pool, prompt and batch buckets, the slot and wave engines, the
model server with its JSON/TCP wire and client, and the fleet: the
replica process, the router and the autoscaler.

Public surface::

    from paddle_tpu_torch import serving
    engine = serving.make_slot_model("lm", decoder_lm, n_slots=16,
                                     prompt_buckets=(32, 64, 128))
    server = serving.ModelServer()
    server.add_model(engine)
    endpoint = server.serve()
    client = serving.ServingClient(endpoint)
    toks = client.generate("lm", prompts, max_new=32)

    router = serving.Router(spec=replica_spec, replicas=2).start()
    router.wait_ready()
    endpoint = router.serve()          # clients speak to it unchanged

Submodules import lazily (PEP 562), so ``paddle_tpu_torch.serving.
metrics`` imports without the engines. Not here yet (they wait for
their items): ``ServedModel`` and ``forbid_compiles``.
"""

from __future__ import annotations

_LAZY = {
    "BucketPolicy": ("paddle_tpu_torch.serving.bucketing", "BucketPolicy"),
    "FeedSignature": ("paddle_tpu_torch.serving.bucketing",
                      "FeedSignature"),
    "GenerativeModel": ("paddle_tpu_torch.serving.engine",
                        "GenerativeModel"),
    "SlotGenerativeModel": ("paddle_tpu_torch.serving.engine",
                            "SlotGenerativeModel"),
    "ContiguousSlotGenerativeModel": ("paddle_tpu_torch.serving.engine",
                                      "ContiguousSlotGenerativeModel"),
    "PagedSlotGenerativeModel": ("paddle_tpu_torch.serving.engine",
                                 "PagedSlotGenerativeModel"),
    "make_slot_model": ("paddle_tpu_torch.serving.engine",
                        "make_slot_model"),
    "NgramDrafter": ("paddle_tpu_torch.serving.engine", "NgramDrafter"),
    "ModelDrafter": ("paddle_tpu_torch.serving.engine", "ModelDrafter"),
    "PagePool": ("paddle_tpu_torch.serving.kv_pool", "PagePool"),
    "PagesExhaustedError": ("paddle_tpu_torch.serving.kv_pool",
                            "PagesExhaustedError"),
    "SlotExhaustedError": ("paddle_tpu_torch.serving.engine",
                           "SlotExhaustedError"),
    "PromptTooLongError": ("paddle_tpu_torch.serving.engine",
                           "PromptTooLongError"),
    "ModelServer": ("paddle_tpu_torch.serving.server", "ModelServer"),
    "Router": ("paddle_tpu_torch.serving.router", "Router"),
    "ROUTER_ENV": ("paddle_tpu_torch.serving.router", "ROUTER_ENV"),
    "Autoscaler": ("paddle_tpu_torch.serving.autoscaler", "Autoscaler"),
    "AutoscalePolicy": ("paddle_tpu_torch.serving.autoscaler",
                        "AutoscalePolicy"),
    "RouterSource": ("paddle_tpu_torch.serving.autoscaler", "RouterSource"),
    "PlacementError": ("paddle_tpu_torch.serving.autoscaler",
                       "PlacementError"),
    "bin_pack": ("paddle_tpu_torch.serving.autoscaler", "bin_pack"),
    "plan_placement": ("paddle_tpu_torch.serving.autoscaler",
                       "plan_placement"),
    "validate_host": ("paddle_tpu_torch.serving.autoscaler",
                      "validate_host"),
    "RequestShedError": ("paddle_tpu_torch.serving.server",
                         "RequestShedError"),
    "ReplicaDrainingError": ("paddle_tpu_torch.serving.server",
                             "ReplicaDrainingError"),
    "RequestCancelledError": ("paddle_tpu_torch.serving.server",
                              "RequestCancelledError"),
    "ModelNotFoundError": ("paddle_tpu_torch.serving.server",
                           "ModelNotFoundError"),
    "SERVING_ENV": ("paddle_tpu_torch.serving.server", "SERVING_ENV"),
    "ServingClient": ("paddle_tpu_torch.serving.client", "ServingClient"),
    "ServingUnavailableError": ("paddle_tpu_torch.serving.client",
                                "ServingUnavailableError"),
    "ServingRequestError": ("paddle_tpu_torch.serving.client",
                            "ServingRequestError"),
    "metrics": ("paddle_tpu_torch.serving.metrics", None),
    "bucketing": ("paddle_tpu_torch.serving.bucketing", None),
    "engine": ("paddle_tpu_torch.serving.engine", None),
    "kv_pool": ("paddle_tpu_torch.serving.kv_pool", None),
    "server": ("paddle_tpu_torch.serving.server", None),
    "client": ("paddle_tpu_torch.serving.client", None),
    "router": ("paddle_tpu_torch.serving.router", None),
    "replica": ("paddle_tpu_torch.serving.replica", None),
    "autoscaler": ("paddle_tpu_torch.serving.autoscaler", None),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module 'paddle_tpu_torch.serving' has no "
                             f"attribute {name!r}")
    import importlib
    mod = importlib.import_module(entry[0])
    value = mod if entry[1] is None else getattr(mod, entry[1])
    globals()[name] = value
    return value


def __dir__():
    return __all__
