"""Observability of the port: the metrics registry (``metrics``), the
span tracer (``tracing``), the cross-process trace context
(``trace_context``) and the scrape endpoint (``exporters``)."""
