"""Prometheus text-format rendering of the in-process observability state;
a copy of ``avenir_tpu/telemetry/export.py``.

Renders :class:`~avenir_tpu_torch.utils.metrics.Counters` (named counter
groups, the Hadoop-counter stand-in),
:class:`~avenir_tpu_torch.utils.metrics.LatencyTracker` percentiles,
point-in-time gauges and device-memory bytes in the Prometheus text
exposition format (version 0.0.4).  ``python -m avenir_tpu_torch.telemetry
metrics`` renders a journal's last snapshot through it.

Counter groups/names keep their dotted spelling as label values
(``group="Serving.naiveBayes", name="bucket.8"``) rather than being
mangled into metric names, so label values round-trip exactly to what
``Counters.as_dict`` reports.  Every sample can carry writer-identity
labels (``process``/``replica``/``tenant`` — :func:`fleet_identity`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional


def _escape(value: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_text(labels: Optional[Mapping[str, str]]) -> str:
    """The writer-identity label prefix spliced into every sample:
    ``'process="1",replica="a",'`` (trailing comma so metric-specific
    labels append directly), or ``''`` when no identity was given."""
    if not labels:
        return ""
    return "".join(f'{k}="{_escape(v)}",' for k, v in sorted(labels.items()))


def fleet_identity(replica: Optional[str] = None,
                   tenant: Optional[str] = None,
                   worker: Optional[str] = None) -> Dict[str, str]:
    """This writer's scrape identity: the process index in a fleet (0 in
    one process),
    the replica suffix when the deployment sets one
    (``trace.writer.suffix``, the knob that names the journal shard), the
    tenant (``tenant.id``) and the worker name, each when given."""
    from avenir_tpu_torch.parallel.mesh import process_grid

    out = {"process": str(process_grid()[0])}
    if replica:
        out["replica"] = str(replica)
    if tenant:
        out["tenant"] = str(tenant)
    if worker:
        out["worker"] = str(worker)
    return out


def render_counters(counters, lines: List[str],
                    labels: Optional[Mapping[str, str]] = None) -> None:
    base = _label_text(labels)
    lines.append("# HELP avenir_counter_total Named job/serving counters "
                 "(Counters groups).")
    lines.append("# TYPE avenir_counter_total counter")
    groups = counters.as_dict()
    for group in sorted(groups):
        for name in sorted(groups[group]):
            lines.append(
                f'avenir_counter_total{{{base}group="{_escape(group)}",'
                f'name="{_escape(name)}"}} {groups[group][name]}')


def render_latency(latency: Mapping[str, object], lines: List[str],
                   labels: Optional[Mapping[str, str]] = None) -> None:
    base = _label_text(labels)
    lines.append("# HELP avenir_latency_seconds Request latency over the "
                 "retained ring window.")
    lines.append("# TYPE avenir_latency_seconds summary")
    for model in sorted(latency):
        tracker = latency[model]
        for q in (50.0, 99.0):
            lines.append(
                f'avenir_latency_seconds{{{base}model="{_escape(model)}",'
                f'quantile="{q / 100.0:g}"}} {tracker.percentile(q):.6g}')
        lines.append(
            f'avenir_latency_seconds_count{{{base}model="{_escape(model)}"}} '
            f"{tracker.count}")


def render_gauges(gauges: Mapping[str, float], lines: List[str],
                  labels: Optional[Mapping[str, str]] = None) -> None:
    base = _label_text(labels)
    lines.append("# HELP avenir_gauge Point-in-time gauges (queue depths, "
                 "uptime).")
    lines.append("# TYPE avenir_gauge gauge")
    for name in sorted(gauges):
        lines.append(
            f'avenir_gauge{{{base}name="{_escape(name)}"}} {gauges[name]:g}')


def render_device_bytes(device_bytes: Mapping, lines: List[str],
                        labels: Optional[Mapping[str, str]] = None) -> None:
    """GraftProf device-memory gauges: ``{(device, kind): bytes}`` from
    :meth:`telemetry.profile.Profiler.gauges` — ``kind`` is
    ``bytes_in_use`` / ``peak_bytes`` as ``device.memory_stats()``
    reports them."""
    base = _label_text(labels)
    lines.append("# HELP avenir_device_bytes Device memory "
                 "(device.memory_stats) sampled at dispatch boundaries.")
    lines.append("# TYPE avenir_device_bytes gauge")
    for device, kind in sorted(device_bytes):
        lines.append(
            f'avenir_device_bytes{{{base}device="{_escape(device)}",'
            f'kind="{_escape(kind)}"}} {device_bytes[(device, kind)]:g}')


def prometheus_text(counters=None,
                    latency: Optional[Mapping[str, object]] = None,
                    gauges: Optional[Mapping[str, float]] = None,
                    device_bytes: Optional[Mapping] = None,
                    labels: Optional[Mapping[str, str]] = None) -> str:
    """The full exposition document; any section may be omitted.
    ``labels`` (process/replica identity) splice into every sample."""
    lines: List[str] = []
    if counters is not None:
        render_counters(counters, lines, labels=labels)
    if latency:
        render_latency(latency, lines, labels=labels)
    if gauges:
        render_gauges(gauges, lines, labels=labels)
    if device_bytes:
        render_device_bytes(device_bytes, lines, labels=labels)
    return "\n".join(lines) + "\n"
