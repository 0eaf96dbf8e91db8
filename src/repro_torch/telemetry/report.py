"""Self-contained operator HTML report for one simulation run — port of
``repro.telemetry.report`` (a copy, imports rewritten).

:func:`html_report` renders a :class:`~repro_torch.core.telemetry.Telemetry`
registry (and optionally the :class:`~repro_torch.cluster.engine.SimResult` it
observed) into a single dependency-free HTML document: inline-SVG line
charts of every recorded sim-time series, decision-latency histograms,
TOPSIS explanation tables, and the counter/gauge registry. No JavaScript,
no external assets — the file opens anywhere, including as a CI artifact.

The markup is deliberately well-formed XML (every tag closed, only the
five predefined entities), so ``xml.etree.ElementTree`` can parse the
whole document — the tests pin that, which keeps the report honest about
escaping. Everything here reads telemetry and sim state; nothing writes
back (pure-observer invariant).

Chart styling follows a fixed design spec: categorical colors assigned in
slot order (never cycled, at most 8 label variants per chart with the
rest folded into a note), 2px round-join lines, hairline solid gridlines,
a legend only when a chart carries two or more series, and all text in
ink tokens — identity always comes from the colored mark beside the text.
Light and dark palettes are both declared; the browser's color scheme
picks one.
"""
from __future__ import annotations

import html
import math

from repro_torch.telemetry.export import _labels_str

# fixed categorical slots (light, dark) — assigned in order, never cycled
_SERIES_LIGHT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                 "#e87ba4", "#008300", "#4a3aa7", "#e34948")
_SERIES_DARK = ("#3987e5", "#d95926", "#199e70", "#c98500",
                "#d55181", "#008300", "#9085e9", "#e66767")
MAX_CHART_SERIES = 8          # fold further label variants into a note
_HOVER_POINT_CAP = 120        # per-polyline invisible hover targets

_CSS = """
:root { color-scheme: light dark; }
* { box-sizing: border-box; }
body { margin: 0; font-family: system-ui, -apple-system, "Segoe UI",
       sans-serif; }
.viz-root {
  color-scheme: light;
  --page: #f9f9f7; --surface-1: #fcfcfb;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --text-muted: #898781;
  --gridline: #e1e0d9; --baseline: #c3c2b7;
  --ring: rgba(11,11,11,0.10);
"""
_CSS += "".join(f"  --series-{i + 1}: {c};\n"
                for i, c in enumerate(_SERIES_LIGHT))
_CSS += """}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --page: #0d0d0d; --surface-1: #1a1a19;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --text-muted: #898781;
    --gridline: #2c2c2a; --baseline: #383835;
    --ring: rgba(255,255,255,0.10);
"""
_CSS += "".join(f"    --series-{i + 1}: {c};\n"
                for i, c in enumerate(_SERIES_DARK))
_CSS += """  }
}
.viz-root { background: var(--page); color: var(--text-primary);
            padding: 24px; max-width: 1060px; margin: 0 auto; }
h1 { font-size: 22px; font-weight: 600; margin: 0 0 4px; }
h2 { font-size: 15px; font-weight: 600; margin: 28px 0 10px; }
.sub { color: var(--text-secondary); font-size: 13px; margin: 0 0 16px; }
.card { background: var(--surface-1); border: 1px solid var(--ring);
        border-radius: 8px; padding: 14px 16px; margin: 0 0 14px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: var(--surface-1); border: 1px solid var(--ring);
        border-radius: 8px; padding: 10px 14px; min-width: 120px; }
.tile .label { font-size: 12px; color: var(--text-secondary); }
.tile .value { font-size: 22px; font-weight: 600; }
.chart-title { font-size: 13px; font-weight: 600; margin: 0 0 2px; }
.legend { display: flex; flex-wrap: wrap; gap: 4px 14px;
          font-size: 12px; color: var(--text-secondary);
          margin: 4px 0 6px; }
.legend .key { display: inline-block; width: 14px; height: 3px;
               border-radius: 2px; vertical-align: middle;
               margin-right: 5px; }
.note { font-size: 12px; color: var(--text-muted); margin: 4px 0 0; }
table { border-collapse: collapse; font-size: 12.5px; width: 100%; }
th { text-align: left; color: var(--text-secondary); font-weight: 600;
     border-bottom: 1px solid var(--baseline); padding: 4px 10px 4px 0; }
td { border-bottom: 1px solid var(--gridline); padding: 4px 10px 4px 0;
     font-variant-numeric: tabular-nums; }
svg text { font-family: system-ui, -apple-system, "Segoe UI", sans-serif; }
"""


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def _num(v: float) -> str:
    """Compact human number for labels and table cells."""
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "-"
    a = abs(v)
    if a >= 1e6:
        return f"{v / 1e6:.4g}M"
    if a >= 1e4:
        return f"{v / 1e3:.4g}K"
    if a != 0.0 and a < 1e-3:
        return f"{v:.2e}"
    return f"{v:.4g}"


def _slot(i: int) -> str:
    return f"var(--series-{i + 1})"


def _ticks(lo: float, hi: float, n: int = 4) -> list[float]:
    """Clean-ish tick values covering [lo, hi]."""
    if hi <= lo:
        return [lo]
    span = hi - lo
    step = 10.0 ** math.floor(math.log10(span / n))
    for mult in (1.0, 2.0, 2.5, 5.0, 10.0):
        if span / (step * mult) <= n:
            step *= mult
            break
    first = math.ceil(lo / step) * step
    out = []
    t = first
    while t <= hi + 1e-12 * span:
        out.append(t)
        t += step
    return out or [lo]


def _line_chart(title: str, variants: list[tuple[str, list[float],
                                                 list[float]]],
                unit_hint: str = "") -> str:
    """One inline-SVG line chart: ``variants`` is a list of
    ``(legend_label, times, values)`` with at most
    :data:`MAX_CHART_SERIES` entries (the caller folds the rest)."""
    W, H = 960, 230
    ml, mr, mt, mb = 56, 12, 8, 24
    pw, ph = W - ml - mr, H - mt - mb
    all_t = [t for _, ts, _ in variants for t in ts]
    all_v = [v for _, _, vs in variants for v in vs]
    t0, t1 = min(all_t), max(all_t)
    v0, v1 = min(all_v), max(all_v)
    if v1 <= v0:
        v0, v1 = v0 - 1.0, v1 + 1.0
    if t1 <= t0:
        t1 = t0 + 1.0
    v0 = min(v0, 0.0) if v0 > 0 and v0 < 0.25 * v1 else v0
    pad = 0.06 * (v1 - v0)
    v1 += pad
    if v0 != 0.0:
        v0 -= pad

    def x(t):
        return ml + pw * (t - t0) / (t1 - t0)

    def y(v):
        return mt + ph * (1.0 - (v - v0) / (v1 - v0))

    parts = [f'<svg viewBox="0 0 {W} {H}" width="100%" height="{H}" '
             f'role="img" aria-label="{_esc(title)}">']
    # hairline gridlines + y ticks (muted ink, never the series color)
    for tv in _ticks(v0, v1):
        yy = y(tv)
        parts.append(f'<line x1="{ml}" y1="{yy:.1f}" x2="{W - mr}" '
                     f'y2="{yy:.1f}" stroke="var(--gridline)" '
                     f'stroke-width="1"/>')
        parts.append(f'<text x="{ml - 6}" y="{yy + 3.5:.1f}" '
                     f'text-anchor="end" font-size="11" '
                     f'fill="var(--text-muted)">{_esc(_num(tv))}</text>')
    # x axis baseline + end ticks (sim seconds)
    parts.append(f'<line x1="{ml}" y1="{mt + ph}" x2="{W - mr}" '
                 f'y2="{mt + ph}" stroke="var(--baseline)" '
                 f'stroke-width="1"/>')
    for tt, anchor in ((t0, "start"), (t1, "end")):
        parts.append(f'<text x="{x(tt):.1f}" y="{H - 7}" '
                     f'text-anchor="{anchor}" font-size="11" '
                     f'fill="var(--text-muted)">'
                     f'{_esc(_num(tt))}s</text>')
    for si, (label, ts, vs) in enumerate(variants):
        color = _slot(si)
        pts = " ".join(f"{x(t):.1f},{y(v):.1f}" for t, v in zip(ts, vs))
        if len(ts) == 1:
            parts.append(f'<circle cx="{x(ts[0]):.1f}" '
                         f'cy="{y(vs[0]):.1f}" r="4" fill="{color}" '
                         f'stroke="var(--surface-1)" stroke-width="2"/>')
        else:
            parts.append(f'<polyline points="{pts}" fill="none" '
                         f'stroke="{color}" stroke-width="2" '
                         f'stroke-linejoin="round" '
                         f'stroke-linecap="round"/>')
            # end-marker with a surface ring so it reads over the line
            parts.append(f'<circle cx="{x(ts[-1]):.1f}" '
                         f'cy="{y(vs[-1]):.1f}" r="4" fill="{color}" '
                         f'stroke="var(--surface-1)" stroke-width="2"/>')
        # invisible hover targets carrying native tooltips
        stride = max(1, len(ts) // _HOVER_POINT_CAP)
        for t, v in list(zip(ts, vs))[::stride]:
            parts.append(f'<circle cx="{x(t):.1f}" cy="{y(v):.1f}" '
                         f'r="7" fill="transparent">'
                         f'<title>{_esc(label)}: {_esc(_num(v))}'
                         f'{_esc(unit_hint)} at t={_esc(_num(t))}s'
                         f'</title></circle>')
    parts.append("</svg>")
    return "".join(parts)


def _bar_chart(edges, counts) -> str:
    """Histogram bars over bucket index (log-spaced latency edges, plus
    the +Inf overflow bucket): rounded at the data end, square at the
    baseline."""
    W, H = 960, 170
    ml, mr, mt, mb = 56, 12, 8, 34
    pw, ph = W - ml - mr, H - mt - mb
    labels = [_num(e) for e in edges] + ["+Inf"] * (len(counts)
                                                    - len(edges))
    n = len(counts)
    peak = max(counts) or 1
    bw = min(24.0, pw / n - 2.0)
    parts = [f'<svg viewBox="0 0 {W} {H}" width="100%" height="{H}" '
             f'role="img" aria-label="latency histogram">']
    for tv in _ticks(0, peak, 3):
        yy = mt + ph * (1.0 - tv / peak)
        parts.append(f'<line x1="{ml}" y1="{yy:.1f}" x2="{W - mr}" '
                     f'y2="{yy:.1f}" stroke="var(--gridline)" '
                     f'stroke-width="1"/>')
        parts.append(f'<text x="{ml - 6}" y="{yy + 3.5:.1f}" '
                     f'text-anchor="end" font-size="11" '
                     f'fill="var(--text-muted)">{_esc(_num(tv))}</text>')
    parts.append(f'<line x1="{ml}" y1="{mt + ph}" x2="{W - mr}" '
                 f'y2="{mt + ph}" stroke="var(--baseline)" '
                 f'stroke-width="1"/>')
    lbl_stride = max(1, n // 8)
    for i, c in enumerate(counts):
        cx = ml + pw * (i + 0.5) / n
        x0 = cx - bw / 2.0
        h = ph * c / peak
        ytop = mt + ph - h
        if c:
            r = min(4.0, bw / 2.0, h)
            parts.append(
                f'<path d="M{x0:.1f},{mt + ph:.1f} '
                f'L{x0:.1f},{ytop + r:.1f} '
                f'Q{x0:.1f},{ytop:.1f} {x0 + r:.1f},{ytop:.1f} '
                f'L{x0 + bw - r:.1f},{ytop:.1f} '
                f'Q{x0 + bw:.1f},{ytop:.1f} {x0 + bw:.1f},{ytop + r:.1f} '
                f'L{x0 + bw:.1f},{mt + ph:.1f} Z" fill="{_slot(0)}">'
                f'<title>&#8804; {_esc(labels[i])}s: {c}</title>'
                f'</path>')
        if i % lbl_stride == 0:
            parts.append(f'<text x="{cx:.1f}" y="{H - 7}" '
                         f'text-anchor="middle" font-size="10" '
                         f'fill="var(--text-muted)">'
                         f'{_esc(labels[i])}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _scatter_chart(xlabel: str, ylabel: str,
                   points: list[tuple[float, float, str, bool]]) -> str:
    """Inline-SVG scatter of one frontier: ``points`` is
    ``(x, y, tooltip, is_dominant)``; the dominant pick renders in the
    second categorical slot with a surface ring, everything else in the
    first."""
    W, H = 960, 230
    ml, mr, mt, mb = 56, 12, 8, 34
    pw, ph = W - ml - mr, H - mt - mb
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 <= x0:
        x0, x1 = x0 - 1.0, x1 + 1.0
    if y1 <= y0:
        y0, y1 = y0 - 1.0, y1 + 1.0
    xpad, ypad = 0.05 * (x1 - x0), 0.08 * (y1 - y0)
    x0, x1 = x0 - xpad, x1 + xpad
    y0, y1 = y0 - ypad, y1 + ypad

    def x(v):
        return ml + pw * (v - x0) / (x1 - x0)

    def y(v):
        return mt + ph * (1.0 - (v - y0) / (y1 - y0))

    parts = [f'<svg viewBox="0 0 {W} {H}" width="100%" height="{H}" '
             f'role="img" aria-label="{_esc(xlabel)} vs {_esc(ylabel)} '
             f'frontier">']
    for tv in _ticks(y0, y1):
        yy = y(tv)
        parts.append(f'<line x1="{ml}" y1="{yy:.1f}" x2="{W - mr}" '
                     f'y2="{yy:.1f}" stroke="var(--gridline)" '
                     f'stroke-width="1"/>')
        parts.append(f'<text x="{ml - 6}" y="{yy + 3.5:.1f}" '
                     f'text-anchor="end" font-size="11" '
                     f'fill="var(--text-muted)">{_esc(_num(tv))}</text>')
    parts.append(f'<line x1="{ml}" y1="{mt + ph}" x2="{W - mr}" '
                 f'y2="{mt + ph}" stroke="var(--baseline)" '
                 f'stroke-width="1"/>')
    for tv in _ticks(x0, x1):
        parts.append(f'<text x="{x(tv):.1f}" y="{H - 18}" '
                     f'text-anchor="middle" font-size="11" '
                     f'fill="var(--text-muted)">{_esc(_num(tv))}</text>')
    parts.append(f'<text x="{ml + pw / 2:.1f}" y="{H - 4}" '
                 f'text-anchor="middle" font-size="11" '
                 f'fill="var(--text-secondary)">{_esc(xlabel)} &#8594; '
                 f'(lower is better; y: {_esc(ylabel)})</text>')
    # dominated-into-front ordering: plain points first, dominant on top
    for px, py, tip, dom in sorted(points, key=lambda p: p[3]):
        if dom:
            parts.append(f'<circle cx="{x(px):.1f}" cy="{y(py):.1f}" '
                         f'r="6" fill="{_slot(1)}" '
                         f'stroke="var(--surface-1)" stroke-width="2">'
                         f'<title>{_esc(tip)}</title></circle>')
        else:
            parts.append(f'<circle cx="{x(px):.1f}" cy="{y(py):.1f}" '
                         f'r="3.5" fill="{_slot(0)}" fill-opacity="0.8">'
                         f'<title>{_esc(tip)}</title></circle>')
    parts.append("</svg>")
    return "".join(parts)


_FRONTIER_TABLE_CAP = 20      # frontier rows shown per regime table


def _frontier_section(frontier: dict) -> list[str]:
    """The Pareto-frontier cards: per regime, a scatter of the frontier
    over the first two metric axes (dominant pick highlighted) and the
    top frontier rows. ``frontier`` is
    ``repro_torch.core.pareto.FrontierAtlas.to_report()`` payload —
    regime -> {metrics, n_schemes, n_front, dominant, front}."""
    body: list[str] = []
    body.append("<h2>Pareto frontier</h2>")
    for regime, data in sorted(frontier.items()):
        metrics = list(data.get("metrics") or [])
        front = list(data.get("front") or [])
        dom = data.get("dominant") or {}
        body.append('<div class="card">')
        body.append(f'<p class="chart-title">{_esc(regime)}</p>')
        body.append(
            f'<p class="sub">{_esc(data.get("n_front", len(front)))} '
            f'Pareto-optimal of {_esc(data.get("n_schemes", "?"))} '
            f'schemes &#183; dominant pick: scheme '
            f'#{_esc(dom.get("index", "?"))}'
            + (f' ({_esc(dom["name"])})' if dom.get("name") else "")
            + "</p>")
        if len(metrics) >= 2 and front:
            mx, my = metrics[0], metrics[1]
            pts = []
            for p in front:
                pm = p.get("metrics") or {}
                tip = (f'#{p.get("index")} '
                       + " ".join(f"{k}={_num(float(v))}"
                                  for k, v in pm.items()))
                pts.append((float(pm[mx]), float(pm[my]), tip,
                            p.get("index") == dom.get("index")))
            body.append(_scatter_chart(mx, my, pts))
        if front:
            body.append("<table>")
            body.append("<tr><th>#</th><th>name</th><th>weights</th>"
                        + "".join(f"<th>{_esc(m)}</th>" for m in metrics)
                        + "</tr>")
            for p in front[:_FRONTIER_TABLE_CAP]:
                pm = p.get("metrics") or {}
                w = ", ".join(_num(float(v))
                              for v in (p.get("weights") or []))
                mark = " &#9733;" if p.get("index") == dom.get("index") \
                    else ""
                body.append(
                    f'<tr><td>{_esc(p.get("index"))}{mark}</td>'
                    f'<td>{_esc(p.get("name") or "-")}</td>'
                    f'<td>{_esc(w)}</td>'
                    + "".join(f"<td>{_esc(_num(float(pm.get(m))))}</td>"
                              if pm.get(m) is not None else "<td>-</td>"
                              for m in metrics)
                    + "</tr>")
            body.append("</table>")
            if len(front) > _FRONTIER_TABLE_CAP:
                body.append(f'<p class="note">showing '
                            f'{_FRONTIER_TABLE_CAP} of {len(front)} '
                            f'frontier schemes</p>')
        body.append("</div>")
    return body


def _series_groups(tel) -> dict[str, list]:
    groups: dict[str, list] = {}
    for s in tel.timeseries.values():
        groups.setdefault(s.name, []).append(s)
    return {name: sorted(cells, key=lambda s: sorted(s.labels.items()))
            for name, cells in sorted(groups.items())}


def _tiles(summary: dict) -> str:
    tiles = [("Pods placed", summary.get("pods")),
             ("Unschedulable rate", summary.get("unschedulable_rate")),
             ("Preemptions", summary.get("preemptions")),
             ("Migrations", summary.get("migrations")),
             ("Wakes", summary.get("wakes")),
             ("Sleeps", summary.get("sleeps"))]
    for sched, row in sorted(summary.get("schedulers", {}).items()):
        tiles.append((f"{sched} energy (kJ)", row.get("energy_kj")))
    out = ['<div class="tiles">']
    for label, value in tiles:
        if value is None:
            continue
        shown = _num(float(value)) if isinstance(value, (int, float)) \
            else _esc(value)
        out.append(f'<div class="tile"><div class="label">{_esc(label)}'
                   f'</div><div class="value">{shown}</div></div>')
    out.append("</div>")
    return "".join(out)


def html_report(tel=None, result=None, title: str = "GreenPod run report",
                provenance: dict | None = None,
                frontier: dict | None = None) -> str:
    """Render the run as one self-contained HTML document (returned as a
    string). ``tel`` supplies the recorded registry (series, histograms,
    counters, gauges); ``result`` supplies the summary tiles and TOPSIS
    explanations; ``frontier`` (a
    ``repro_torch.core.pareto.FrontierAtlas.to_report()`` payload) adds a
    Pareto-frontier table + scatter section per regime. Any may be
    omitted; the corresponding sections collapse to a note."""
    body: list[str] = []
    body.append(f"<h1>{_esc(title)}</h1>")
    if provenance:
        keys = ("git_sha", "platform", "jax_platform", "utc_timestamp")
        frag = " &#183; ".join(f"{_esc(k)} {_esc(provenance[k])}"
                               for k in keys if provenance.get(k))
        body.append(f'<p class="sub">{frag}</p>')
    else:
        body.append('<p class="sub">Simulation-clock telemetry report '
                    '&#8212; all timestamps are sim seconds.</p>')

    if result is not None:
        body.append("<h2>Run summary</h2>")
        body.append(_tiles(result.summary()))

    if frontier:
        body.extend(_frontier_section(frontier))

    body.append("<h2>Timelines</h2>")
    groups = _series_groups(tel) if tel is not None else {}
    if not groups:
        body.append('<p class="note">No time series recorded (run with '
                    'telemetry enabled to capture timelines).</p>')
    for name, cells in groups.items():
        shown = cells[:MAX_CHART_SERIES]
        folded = len(cells) - len(shown)
        variants = []
        for s in shown:
            label = (_labels_str(s.labels)[1:-1] if s.labels
                     else name)
            variants.append((label, list(s.times), list(s.values)))
        body.append('<div class="card">')
        body.append(f'<p class="chart-title">{_esc(name)}</p>')
        if len(variants) >= 2:
            legend = "".join(
                f'<span><span class="key" style="background:{_slot(i)}">'
                f'</span>{_esc(label)}</span>'
                for i, (label, _, _) in enumerate(variants))
            body.append(f'<div class="legend">{legend}</div>')
        body.append(_line_chart(name, variants))
        if folded:
            body.append(f'<p class="note">+{folded} more label '
                        f'variant{"s" if folded > 1 else ""} not charted '
                        f'(see the series table below).</p>')
        body.append("</div>")

    hists = sorted(tel.histograms.values(),
                   key=lambda h: (h.name, sorted(h.labels.items()))) \
        if tel is not None else []
    if hists:
        body.append("<h2>Decision latency</h2>")
        for h in hists:
            body.append('<div class="card">')
            label = f"{h.name}{_labels_str(h.labels)}"
            body.append(f'<p class="chart-title">{_esc(label)}</p>')
            body.append(f'<p class="sub">count {h.count} &#183; mean '
                        f'{_esc(_num(h.sum / h.count if h.count else 0.0))}'
                        f's &#183; bucket upper bounds in seconds</p>')
            body.append(_bar_chart(list(h.edges), list(h.counts)))
            body.append("</div>")

    explanations = getattr(result, "explanations", None) if result else None
    if explanations:
        body.append("<h2>TOPSIS decisions</h2>")
        body.append('<div class="card"><table>')
        body.append("<tr><th>t (s)</th><th>pod</th><th>node</th>"
                    "<th>runner-up</th><th>gap</th>"
                    "<th>top criterion</th></tr>")
        for exp in explanations[:50]:
            contribs = exp.get("contributions") or []
            top = max(contribs, key=lambda c: abs(c["delta_cc"]),
                      default=None)
            top_s = (f"{top['criterion']} ({_num(top['delta_cc'])})"
                     if top else "-")
            body.append(
                f"<tr><td>{_esc(_num(exp.get('t', 0.0)))}</td>"
                f"<td>{_esc(exp.get('pod'))}</td>"
                f"<td>{_esc(exp.get('node'))}</td>"
                f"<td>{_esc(exp.get('runner_up_node') or '-')}</td>"
                f"<td>{_esc(_num(exp.get('gap')))}</td>"
                f"<td>{_esc(top_s)}</td></tr>")
        body.append("</table>")
        if len(explanations) > 50:
            body.append(f'<p class="note">showing 50 of '
                        f'{len(explanations)} decisions</p>')
        body.append("</div>")

    if tel is not None and (tel.counters or tel.gauges):
        body.append("<h2>Registry</h2>")
        body.append('<div class="card"><table>')
        body.append("<tr><th>metric</th><th>value</th><th>min</th>"
                    "<th>max</th><th>samples</th></tr>")
        for name, labels, value in sorted(
                tel.counters.values(),
                key=lambda c: (c[0], sorted(c[1].items()))):
            body.append(f"<tr><td>{_esc(name + _labels_str(labels))}</td>"
                        f"<td>{_esc(_num(value))}</td>"
                        f"<td>-</td><td>-</td><td>-</td></tr>")
        for g in sorted(tel.gauges.values(),
                        key=lambda g: (g.name, sorted(g.labels.items()))):
            body.append(
                f"<tr><td>{_esc(g.name + _labels_str(g.labels))}</td>"
                f"<td>{_esc(_num(g.value))}</td>"
                f"<td>{_esc(_num(g.min))}</td>"
                f"<td>{_esc(_num(g.max))}</td>"
                f"<td>{g.samples}</td></tr>")
        body.append("</table></div>")

    if groups:
        # the table view: every series, including folded variants
        body.append("<h2>Series table</h2>")
        body.append('<div class="card"><table>')
        body.append("<tr><th>series</th><th>points</th><th>samples</th>"
                    "<th>first t</th><th>last t</th><th>last value</th>"
                    "<th>min</th><th>max</th></tr>")
        for name, cells in groups.items():
            for s in cells:
                body.append(
                    f"<tr><td>{_esc(s.name + _labels_str(s.labels))}</td>"
                    f"<td>{len(s)}</td><td>{s.samples}</td>"
                    f"<td>{_esc(_num(s.times[0]))}</td>"
                    f"<td>{_esc(_num(s.times[-1]))}</td>"
                    f"<td>{_esc(_num(s.values[-1]))}</td>"
                    f"<td>{_esc(_num(min(s.values)))}</td>"
                    f"<td>{_esc(_num(max(s.values)))}</td></tr>")
        body.append("</table></div>")

    return ('<html><head><meta charset="utf-8"/>'
            f"<title>{_esc(title)}</title>"
            f"<style>{_CSS}</style></head>"
            f'<body><div class="viz-root">{"".join(body)}</div>'
            "</body></html>")


def write_html_report(path, tel=None, result=None,
                      title: str = "GreenPod run report",
                      provenance: dict | None = None,
                      frontier: dict | None = None) -> str:
    """Write :func:`html_report` to ``path``; returns the path."""
    doc = html_report(tel=tel, result=result, title=title,
                      provenance=provenance, frontier=frontier)
    with open(path, "w") as f:
        f.write(doc)
    return str(path)
