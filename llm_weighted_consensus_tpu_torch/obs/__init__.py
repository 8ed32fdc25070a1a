"""Performance observability of the port: mergeable latency histograms
(``histogram``) and the process-global phase aggregator (``phases``)
behind ``/metrics``."""
