"""horovod_tpu_torch.obs — the observability plane (host-side copy of
the JAX package's): `registry` (counters, gauges, histograms),
`catalog` (the metric families), `events` (structured event log),
`spans`/`tracing` (request trace ids and causal spans), `flightrec`
(the crash flight recorder), `reqlog` (request record/replay) and
`slo` (burn-rate objectives). The HTTP exporter, fleet aggregation and
straggler attribution are later slices of the port.
"""
