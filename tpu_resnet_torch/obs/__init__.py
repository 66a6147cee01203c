"""Observability of a training run (port of ``tpu_resnet/obs``):

``breakdown``   ``StepBreakdown``: a log interval's data wait, dispatch and
                sampled device backlog, and the first dispatch's
                ``compile_seconds``.
``spans``       ``SpanTracer``: lifecycle spans in ``events.jsonl``;
                ``TailSampler``: which request spans a server keeps.
``manifest``    ``manifest.json`` (config, device, versions, git
                revision) and the run's ``run_id``.
``server``      ``/metrics`` (Prometheus text) and ``/healthz`` over HTTP;
                the training and the serving series sets.
``mfu``         the step's model FLOPs (``flops.json``) and the live
                ``model_flops_per_sec`` / ``mfu``.
``memory``      the step's memory ledger (``memory.json``), live
                ``hbm_bytes_*`` gauges and ``oom_report.json``.

Importing the package imports no torch: the scrape and parse helpers and
the file readers work without it.
"""

from tpu_resnet_torch.obs import memory, mfu
from tpu_resnet_torch.obs.breakdown import StepBreakdown
from tpu_resnet_torch.obs.manifest import (
    build_manifest,
    ensure_run_id,
    read_run_id,
    write_manifest,
)
from tpu_resnet_torch.obs.server import (
    SERVE_GAUGES,
    SERVE_HISTOGRAMS,
    Histogram,
    TelemetryRegistry,
    TelemetryServer,
    histogram_quantile,
    merge_histograms,
    parse_histograms,
    parse_prometheus,
    read_telemetry_port,
    scrape,
)
from tpu_resnet_torch.obs.spans import SpanTracer, TailSampler

__all__ = [
    "SERVE_GAUGES",
    "SERVE_HISTOGRAMS",
    "Histogram",
    "StepBreakdown",
    "SpanTracer",
    "TelemetryRegistry",
    "TailSampler",
    "TelemetryServer",
    "build_manifest",
    "ensure_run_id",
    "histogram_quantile",
    "memory",
    "merge_histograms",
    "mfu",
    "parse_histograms",
    "parse_prometheus",
    "read_run_id",
    "read_telemetry_port",
    "scrape",
    "write_manifest",
]
