"""Telemetry exporters for the flight recorder — port of ``repro.telemetry``
(a copy, imports rewritten).

The registry itself lives in ``repro_torch.core.telemetry`` (a leaf module the
instrumented hot paths import); this package holds the operator-facing
output formats — JSON snapshot, Prometheus text exposition, the Chrome
trace-event / Perfetto export of a simulation timeline
(``repro_torch.telemetry.export``), the self-contained HTML run report
(``repro_torch.telemetry.report``), and the benchmark regression gate +
history trajectory (``repro_torch.telemetry.baseline``).
"""
from repro_torch.telemetry.baseline import (  # noqa: F401
    append_history, compare_reports, format_verdict, history_entries)
from repro_torch.telemetry.export import (  # noqa: F401
    json_snapshot, parse_prometheus, perfetto_trace, prometheus_text,
    validate_trace, write_perfetto)
from repro_torch.telemetry.report import (  # noqa: F401
    html_report, write_html_report)
