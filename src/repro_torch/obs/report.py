"""Self-contained HTML perf report: one file, no external assets.

Counterpart of the reference's ``obs/report.py``, with its sections, CSS,
SVG and text, so that the same inputs give the same bytes. It stitches a
run's evidence into one page:

  * headline tiles (seeds/sec per backend, serving qps, p99, SLO breaches)
    from records in the reference's ``BENCH_runtime.json`` /
    ``BENCH_service.json`` schema;
  * a phase breakdown (bars) from the trace recorder's spans
    (``obs.trace``): top-level span seconds per lane;
  * the measured shard skew (``obs.shardprof``): per-shard relative load of
    the latest profile, an imbalance table over every profile, and the
    ``partition.predicted_vs_measured_*`` gauges;
  * the async admission pipeline (queue depth over time, deadline misses,
    eviction churn, swap latency) from the service record's ``async`` blob
    and the metrics registry;
  * the SLO watchdog's summary (per-class window p99 against its budget);
  * the kernel-tuning table from the ``repro_torch.tune`` cache: per
    workload key the winning config, default and tuned time, GB/s and share
    of the bandwidth roof.

Everything renders as inline SVG and CSS (no scripts, no network), light
and dark through ``prefers-color-scheme``; every mark has a native
``<title>`` tooltip, values sit at the bar tips in ink tokens.

Entry points: ``write_report`` (explicit data) and
``write_report_from_artifacts`` (the ``BENCH_*`` files and the tuning cache
on disk, plus the live recorder, registry and profile ring).
"""
from __future__ import annotations

import html
import json
import os
from typing import Iterable, List, Optional

# Reference data-viz palette (validated: see docs/observability.md). Light
# and dark values swap via CSS custom properties; marks use series slots,
# text always uses ink tokens.
_CSS = """
:root {
  color-scheme: light;
  --surface: #fcfcfb; --page: #f9f9f7;
  --ink: #0b0b0b; --ink-2: #52514e; --ink-muted: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7;
  --border: rgba(11,11,11,0.10);
  --s1: #2a78d6; --s2: #eb6834; --s3: #1baf7a;
  --good: #0ca30c; --warning: #fab219; --critical: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  :root {
    color-scheme: dark;
    --surface: #1a1a19; --page: #0d0d0d;
    --ink: #ffffff; --ink-2: #c3c2b7; --ink-muted: #898781;
    --grid: #2c2c2a; --axis: #383835;
    --border: rgba(255,255,255,0.10);
    --s1: #3987e5; --s2: #d95926; --s3: #199e70;
  }
}
* { box-sizing: border-box; }
body { margin: 0; padding: 24px; background: var(--page); color: var(--ink);
       font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif; }
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 15px; margin: 0 0 8px; }
.sub { color: var(--ink-2); margin: 0 0 20px; }
.card { background: var(--surface); border: 1px solid var(--border);
        border-radius: 8px; padding: 16px 18px; margin-bottom: 16px; }
.tiles { display: flex; flex-wrap: wrap; gap: 16px; margin-bottom: 16px; }
.tile { background: var(--surface); border: 1px solid var(--border);
        border-radius: 8px; padding: 14px 18px; min-width: 150px; }
.tile .label { color: var(--ink-2); font-size: 12px; }
.tile .value { font-size: 26px; font-weight: 600; margin-top: 2px; }
.tile .hint { color: var(--ink-muted); font-size: 11px; margin-top: 2px; }
table { border-collapse: collapse; width: 100%; font-size: 13px; }
th { text-align: left; color: var(--ink-2); font-weight: 500;
     border-bottom: 1px solid var(--axis); padding: 4px 10px 4px 0; }
td { border-bottom: 1px solid var(--grid); padding: 4px 10px 4px 0;
     font-variant-numeric: tabular-nums; }
.status { display: inline-flex; align-items: center; gap: 6px; }
.status .dot { width: 9px; height: 9px; border-radius: 50%; }
svg text { font: 12px system-ui, -apple-system, "Segoe UI", sans-serif;
           fill: var(--ink-2); }
svg .val { fill: var(--ink); }
svg .muted { fill: var(--ink-muted); font-size: 11px; }
.empty { color: var(--ink-muted); font-style: italic; }
"""


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def _fmt(v, digits: int = 2) -> str:
    """Compact numeric formatting for labels (1,284 / 12.9K / 4.2M)."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return _esc(v)
    a = abs(v)
    if a >= 1e9:
        return f"{v / 1e9:.1f}G"
    if a >= 1e6:
        return f"{v / 1e6:.1f}M"
    if a >= 1e4:
        return f"{v / 1e3:.1f}K"
    if a >= 100 or v == int(v):
        return f"{v:,.0f}"
    return f"{v:.{digits}f}"


def _bar_path(x: float, y: float, w: float, h: float, r: float = 4.0) -> str:
    """Horizontal bar: square at the baseline (left), 4px rounded data end
    (right). Degrades to square ends when the bar is shorter than the
    radius."""
    r = min(r, w / 2, h / 2)
    if r <= 0.5:
        return (f"M{x:.1f},{y:.1f} h{w:.1f} v{h:.1f} h{-w:.1f} Z")
    return (f"M{x:.1f},{y:.1f} h{w - r:.1f} "
            f"a{r:.1f},{r:.1f} 0 0 1 {r:.1f},{r:.1f} "
            f"v{h - 2 * r:.1f} "
            f"a{r:.1f},{r:.1f} 0 0 1 {-r:.1f},{r:.1f} "
            f"h{-(w - r):.1f} Z")


def _hbar_chart(rows, *, unit: str = "", color: str = "var(--s1)",
                width: int = 720) -> str:
    """Horizontal bar chart: rows = [(label, value, tooltip)]. Single
    series (no legend — the section title names it); value at each bar tip,
    ink-colored; native <title> tooltip per mark."""
    rows = [(str(l), max(float(v), 0.0), t) for l, v, t in rows]
    if not rows or all(v == 0 for _, v, _ in rows):
        return '<p class="empty">no data captured</p>'
    vmax = max(v for _, v, _ in rows)
    bar_h, gap, label_w, val_w = 18, 8, 150, 80
    plot_w = width - label_w - val_w
    height = len(rows) * (bar_h + gap) + 6
    parts = [f'<svg viewBox="0 0 {width} {height}" width="100%" '
             f'role="img" aria-label="bar chart">']
    # hairline baseline the bars grow from
    parts.append(f'<line x1="{label_w}" y1="0" x2="{label_w}" '
                 f'y2="{height - 4}" stroke="var(--axis)" stroke-width="1"/>')
    y = 3.0
    for label, v, tip in rows:
        w = plot_w * (v / vmax) if vmax > 0 else 0.0
        parts.append(f'<text x="{label_w - 8}" y="{y + bar_h - 5}" '
                     f'text-anchor="end">{_esc(label)}</text>')
        parts.append(f'<path d="{_bar_path(label_w + 1, y, max(w, 1.5), bar_h)}" '
                     f'fill="{color}"><title>{_esc(tip)}</title></path>')
        parts.append(f'<text class="val" x="{label_w + max(w, 1.5) + 7}" '
                     f'y="{y + bar_h - 5}">{_fmt(v)}{_esc(unit)}</text>')
        y += bar_h + gap
    parts.append("</svg>")
    return "".join(parts)


def _grouped_shard_chart(shard_rel: List[float], *, width: int = 720) -> str:
    """Per-shard relative-load columns (load / mean) with the 1.0x line —
    the straggler view. Single series; the mean line is chart chrome."""
    if not shard_rel:
        return '<p class="empty">no shard profile captured</p>'
    n = len(shard_rel)
    vmax = max(max(shard_rel), 1.25)
    plot_h, base_y, top = 120, 150, 10
    slot = min((width - 60) / n, 64)
    bar_w = min(slot * 0.7, 24)
    parts = [f'<svg viewBox="0 0 {width} 172" width="100%" role="img" '
             f'aria-label="per-shard relative load">']
    scale = plot_h / vmax
    mean_y = base_y - 1.0 * scale
    parts.append(f'<line x1="40" y1="{base_y}" x2="{40 + slot * n}" '
                 f'y2="{base_y}" stroke="var(--axis)" stroke-width="1"/>')
    parts.append(f'<line x1="40" y1="{mean_y:.1f}" x2="{40 + slot * n}" '
                 f'y2="{mean_y:.1f}" stroke="var(--grid)" stroke-width="1"/>')
    parts.append(f'<text class="muted" x="{44 + slot * n}" '
                 f'y="{mean_y + 4:.1f}">mean</text>')
    for i, rel in enumerate(shard_rel):
        h = max(rel, 0.0) * scale
        x = 40 + i * slot + (slot - bar_w) / 2
        y = base_y - h
        # vertical column: square baseline, rounded cap (rotate the path)
        r = min(4.0, bar_w / 2, h / 2)
        d = (f"M{x:.1f},{base_y:.1f} v{-(h - r):.1f} "
             f"a{r:.1f},{r:.1f} 0 0 1 {r:.1f},{-r:.1f} "
             f"h{bar_w - 2 * r:.1f} "
             f"a{r:.1f},{r:.1f} 0 0 1 {r:.1f},{r:.1f} "
             f"v{h - r:.1f} Z") if h > 1 else \
            (f"M{x:.1f},{base_y:.1f} h{bar_w:.1f} v-1 h{-bar_w:.1f} Z")
        parts.append(f'<path d="{d}" fill="var(--s1)">'
                     f'<title>shard {i}: {rel:.2f}x mean load</title></path>')
        parts.append(f'<text class="val" x="{x + bar_w / 2:.1f}" '
                     f'y="{y - 5:.1f}" text-anchor="middle">{rel:.2f}x</text>')
        parts.append(f'<text class="muted" x="{x + bar_w / 2:.1f}" '
                     f'y="{base_y + 14}" text-anchor="middle">{i}</text>')
    parts.append(f'<text class="muted" x="40" y="{top}">'
                 f'relative load (per-shard bytes / mean)</text>')
    parts.append("</svg>")
    return "".join(parts)


def _tile(label: str, value: str, hint: str = "") -> str:
    h = f'<div class="hint">{_esc(hint)}</div>' if hint else ""
    return (f'<div class="tile"><div class="label">{_esc(label)}</div>'
            f'<div class="value">{value}</div>{h}</div>')


def _status(ok: Optional[bool], text: str) -> str:
    """Status chip: colored dot + label (never color alone)."""
    color = "var(--ink-muted)" if ok is None else (
        "var(--good)" if ok else "var(--critical)")
    mark = "–" if ok is None else ("✓" if ok else "✗")
    return (f'<span class="status"><span class="dot" '
            f'style="background:{color}"></span>{mark} {_esc(text)}</span>')


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------

def _section_tiles(runtime, service, slo) -> str:
    tiles = []
    if runtime:
        backs = runtime.get("backends", {})
        avail = {k: v for k, v in backs.items() if v.get("available")}
        if avail:
            best = max(avail.items(),
                       key=lambda kv: kv[1].get("seeds_per_s_warm", 0.0))
            tiles.append(_tile(
                "seeds/sec (warm)", _fmt(best[1].get("seeds_per_s_warm", 0)),
                f"{best[0]} · {runtime.get('graph', '?')}"))
    if service:
        qps = service.get("qps") or (service.get("host") or {}).get("qps")
        p99 = service.get("p99_ms") or (service.get("host") or {}).get("p99_ms")
        if qps:
            tiles.append(_tile("serving qps", _fmt(qps),
                               f"n={_fmt(service.get('n', 0))}"))
        if p99:
            tiles.append(_tile("query p99", f"{float(p99):.2f}<small>ms</small>"))
        if service.get("device_vs_host"):
            tiles.append(_tile("device vs host",
                               f"{float(service['device_vs_host']):.2f}x",
                               "amortized latency ratio"))
    breaches = (slo or {}).get("_breach_count", 0)
    tiles.append(_tile("SLO breaches", str(breaches),
                       "rising-edge count" if breaches else "within budget"))
    return f'<div class="tiles">{"".join(tiles)}</div>'


def _section_phases(events) -> str:
    totals: dict = {}
    counts: dict = {}
    for ev in events or []:
        if ev.get("depth", 0) == 0:
            p = ev.get("phase", "other")
            totals[p] = totals.get(p, 0.0) + float(ev.get("dur_s", 0.0))
            counts[p] = counts.get(p, 0) + 1
    rows = [(p, t, f"{p}: {t:.3f}s across {counts[p]} top-level spans")
            for p, t in sorted(totals.items(), key=lambda kv: -kv[1])]
    chart = _hbar_chart([(p, t * 1e3, tip) for p, t, tip in rows], unit="ms")
    return (f'<div class="card"><h2>Phase breakdown</h2>'
            f'<p class="sub">top-level span seconds per trace lane '
            f'({len(events or [])} spans recorded)</p>{chart}</div>')


def _section_skew(profiles, metrics_rows) -> str:
    body = []
    prof_dicts = []
    for p in profiles or []:
        prof_dicts.append(p.summary() if hasattr(p, "summary") else dict(p))
    if prof_dicts:
        last = prof_dicts[-1]
        byts = last.get("shard_bytes") or []
        mean = (sum(byts) / len(byts)) if byts else 0.0
        rel = [b / mean if mean else 1.0 for b in byts]
        body.append(f'<p class="sub">latest profile: '
                    f'{_esc(last.get("backend"))} backend, '
                    f'{_esc(last.get("strategy"))} plan, phase '
                    f'{_esc(last.get("phase"))}, {last.get("sweeps")} sweeps, '
                    f'wall {float(last.get("wall_s", 0)):.3f}s</p>')
        body.append(_grouped_shard_chart(rel))
        hdr = ("<tr><th>backend</th><th>strategy</th><th>phase</th>"
               "<th>time imb</th><th>bytes imb</th><th>step imb</th>"
               "<th>GB/s</th><th>wall s</th></tr>")
        trs = []
        for d in prof_dicts:
            trs.append(
                "<tr>"
                f"<td>{_esc(d.get('backend'))}</td>"
                f"<td>{_esc(d.get('strategy'))}</td>"
                f"<td>{_esc(d.get('phase'))}</td>"
                f"<td>{float(d.get('time_imbalance', 0)):.2f}x</td>"
                f"<td>{float(d.get('bytes_imbalance', 0)):.2f}x</td>"
                f"<td>{float(d.get('step_imbalance', 0)):.2f}x</td>"
                f"<td>{float(d.get('achieved_gbps', 0)):.2f}</td>"
                f"<td>{float(d.get('wall_s', 0)):.3f}</td></tr>")
        body.append(f'<table>{hdr}{"".join(trs)}</table>')
    ratio_rows = [r for r in (metrics_rows or [])
                  if str(r.get("name", "")).startswith(
                      "partition.predicted_vs_measured")]
    if ratio_rows:
        hdr = ("<tr><th>gauge</th><th>strategy</th><th>backend</th>"
               "<th>measured / predicted</th><th>verdict</th></tr>")
        trs = []
        for r in ratio_rows:
            ratio = float(r.get("value", 0.0))
            tags = r.get("tags", {})
            ok = 0.5 <= ratio <= 2.0 if ratio else None
            trs.append(
                "<tr>"
                f"<td>{_esc(r['name'].split('.')[-1])}</td>"
                f"<td>{_esc(tags.get('strategy', '?'))}</td>"
                f"<td>{_esc(tags.get('backend', '?'))}</td>"
                f"<td>{ratio:.2f}</td>"
                f"<td>{_status(ok, 'model held' if ok else 'mispredicted')}"
                f"</td></tr>")
        body.append(f'<h2 style="margin-top:14px">Predicted vs measured'
                    f'</h2><table>{hdr}{"".join(trs)}</table>')
    if not body:
        body.append('<p class="empty">no shard profiles captured '
                    '(run a serial/mesh build or fixpoint)</p>')
    return (f'<div class="card"><h2>Shard skew — measured</h2>'
            f'{"".join(body)}</div>')


def _section_slo(slo) -> str:
    if not slo or not any(k for k in slo if not k.startswith("_")):
        return ('<div class="card"><h2>SLO</h2><p class="empty">no SLO '
                'budgets configured</p></div>')
    hdr = ("<tr><th>query class</th><th>samples</th><th>window p99</th>"
           "<th>budget</th><th>status</th></tr>")
    trs = []
    for qclass, st in sorted(slo.items()):
        if qclass.startswith("_"):
            continue
        budget = st.get("budget_ms")
        breach = st.get("in_breach", False)
        status = (_status(None, "no budget") if budget is None
                  else _status(not breach, "breached" if breach else "ok"))
        trs.append(
            "<tr>"
            f"<td>{_esc(qclass)}</td><td>{st.get('samples', 0)}</td>"
            f"<td>{float(st.get('window_p99_ms', 0)):.2f} ms</td>"
            f"<td>{'—' if budget is None else f'{budget:.2f} ms'}</td>"
            f"<td>{status}</td></tr>")
    return (f'<div class="card"><h2>SLO</h2>'
            f'<table>{hdr}{"".join(trs)}</table></div>')


def _depth_sparkline(timeline, *, width: int = 720) -> str:
    """Queue depth over time as a filled step line — the admission view.
    ``timeline`` is [(seconds since engine start, depth), ...]."""
    pts = [(float(t), float(d)) for t, d in timeline or []]
    if not pts:
        return '<p class="empty">no queue-depth timeline captured</p>'
    t0, t1 = pts[0][0], pts[-1][0]
    span = max(t1 - t0, 1e-9)
    dmax = max(max(d for _, d in pts), 1.0)
    plot_h, base_y, left = 90, 110, 46
    plot_w = width - left - 10
    xy = [(left + (t - t0) / span * plot_w,
           base_y - d / dmax * plot_h) for t, d in pts]
    line = " ".join(f"{x:.1f},{y:.1f}" for x, y in xy)
    area = (f"{left:.1f},{base_y} " + line
            + f" {left + plot_w:.1f},{base_y}")
    parts = [f'<svg viewBox="0 0 {width} 132" width="100%" role="img" '
             f'aria-label="queue depth over time">',
             f'<line x1="{left}" y1="{base_y}" x2="{left + plot_w}" '
             f'y2="{base_y}" stroke="var(--axis)" stroke-width="1"/>',
             f'<polygon points="{area}" fill="var(--s1)" opacity="0.15"/>',
             f'<polyline points="{line}" fill="none" stroke="var(--s1)" '
             f'stroke-width="1.5"><title>queue depth, {len(pts)} samples '
             f'over {span:.2f}s (peak {dmax:.0f})</title></polyline>',
             f'<text class="val" x="{left - 6}" '
             f'y="{base_y - plot_h + 4}" text-anchor="end">{dmax:.0f}</text>',
             f'<text class="muted" x="{left - 6}" y="{base_y + 4}" '
             f'text-anchor="end">0</text>',
             f'<text class="muted" x="{left}" y="{base_y + 16}">'
             f'{t0:.2f}s</text>',
             f'<text class="muted" x="{left + plot_w}" y="{base_y + 16}" '
             f'text-anchor="end">{t1:.2f}s</text>',
             "</svg>"]
    return "".join(parts)


def _metric_value(metrics_rows, name: str) -> float:
    """Sum of a counter/gauge across its tag series (0.0 when absent)."""
    return sum(float(r.get("value", 0.0)) for r in metrics_rows or []
               if r.get("name") == name)


def _section_admission(service, metrics_rows) -> str:
    """The async serving pipeline's admission health: queue depth over
    time, deadline misses, eviction churn, and double-buffered swap
    latency. Fed by the benchmark's ``async`` blob (admission_summary())
    plus the live metrics registry."""
    adm = (service or {}).get("async") or (service or {}).get("admission")
    if not adm:
        return ('<div class="card"><h2>Admission</h2><p class="empty">no '
                'async admission stats captured (serve with --async or run '
                'the service benchmark)</p></div>')
    body = []
    miss_rate = float(adm.get("deadline_miss_rate", 0.0))
    tiles = [
        _tile("sustained qps", _fmt(adm.get("sustained_qps", 0.0)),
              "open-loop completed / wall") if adm.get("sustained_qps")
        else "",
        _tile("e2e p99", f"{float(adm.get('e2e_p99_ms', adm.get('p99_ms', 0))):.1f}"
              f"<small>ms</small>",
              f"deadline {float(adm.get('deadline_ms', 0)):.0f}ms"),
        _tile("deadline misses", _fmt(adm.get("deadline_misses", 0)),
              f"{miss_rate:.1%} of {_fmt(adm.get('completed', 0))} served"),
        _tile("flushes", _fmt(adm.get("flushes", 0)),
              f"{_fmt(adm.get('cross_entry_batches', 0))} cross-entry"),
    ]
    body.append(f'<div class="tiles">{"".join(t for t in tiles if t)}</div>')
    body.append(_depth_sparkline(adm.get("queue_depth_timeline")))

    evictions = _metric_value(metrics_rows, "store.evictions")
    rebuilds = _metric_value(metrics_rows, "store.evicted_rebuilds")
    swaps = _metric_value(metrics_rows, "store.swaps")
    stalls = float(adm.get("admission_stalls", 0) or 0)
    swap_hist = next((r for r in metrics_rows or []
                      if r.get("name") == "store.swap_s"), None)
    rows = [("evictions", f"{evictions:.0f}",
             f"{rebuilds:.0f} transparent rebuilds on touch"),
            ("swaps", f"{swaps:.0f}",
             "double-buffered delta/rebuild installs"),
            ("admission stalls", f"{stalls:.0f}",
             "flight-ring dumps on oldest-wait blowout")]
    if swap_hist:
        rows.append(("swap latency",
                     f"{float(swap_hist.get('p99', 0)) * 1e3:.2f} ms p99",
                     f"mean {float(swap_hist.get('mean', 0)) * 1e3:.2f} ms "
                     f"over {int(swap_hist.get('count', 0))} swaps"))
    if adm.get("budget_bytes"):
        rows.append(("resident bytes",
                     f"{_fmt(adm.get('resident_bytes', 0))} "
                     f"/ {_fmt(adm['budget_bytes'])}",
                     "store banks vs eviction budget"))
    hdr = "<tr><th>signal</th><th>value</th><th>detail</th></tr>"
    trs = ["<tr>" f"<td>{_esc(n)}</td><td>{v}</td>"
           f'<td class="sub">{_esc(d)}</td></tr>' for n, v, d in rows]
    body.append(f'<table>{hdr}{"".join(trs)}</table>')
    return (f'<div class="card"><h2>Admission</h2>'
            f'<p class="sub">async serving pipeline: micro-batch queue '
            f'depth, deadline misses, tenancy eviction, swap latency</p>'
            f'{"".join(body)}</div>')


def _cfg_label(cfg: dict) -> str:
    """Compact KernelConfig rendering: only the knobs that differ from the
    all-defaults config ('defaults' when none do). The port's work-item
    geometry (``ie``, ``iw``) and the reference's tiles (``eb``, ``rt``, from
    a cache file both packages share) are both shown."""
    parts = []
    if cfg.get("edge_block"):
        parts.append(f"eb={cfg['edge_block']}")
    if cfg.get("reg_tile"):
        parts.append(f"rt={cfg['reg_tile']}")
    if cfg.get("item_edges"):
        parts.append(f"ie={cfg['item_edges']}")
    if cfg.get("item_warps"):
        parts.append(f"iw={cfg['item_warps']}")
    if cfg.get("local_sweeps"):
        parts.append(f"ls={cfg['local_sweeps']}")
    if cfg.get("pad_mode", "step") != "step":
        parts.append(f"pad={cfg['pad_mode']}")
    if cfg.get("fuse_sweeps"):
        parts.append("fused")
    if cfg.get("lane_fill"):
        parts.append(f"lf={cfg['lane_fill']}")
    return " ".join(parts) if parts else "defaults"


def _section_tuning(tuning) -> str:
    """Measured kernel winners (the ``repro_torch.tune`` cache; the page's
    text is the reference's, word for word): what config was
    chosen per workload key, and the evidence — default vs tuned time,
    achieved GB/s, fraction of the HBM roof."""
    if not tuning:
        return ('<div class="card"><h2>Kernel tuning</h2><p class="empty">'
                'no tuning cache captured (run with --tuning auto or seed '
                'TUNE_cache.json)</p></div>')
    hdr = ("<tr><th>workload key</th><th>chosen config</th>"
           "<th>default</th><th>tuned</th><th>speedup</th>"
           "<th>GB/s</th><th>roof</th></tr>")
    trs = []
    for key, entry in sorted(tuning.items()):
        cfg = _cfg_label(entry.get("config", {}))
        m = entry.get("measurement") or {}
        if m:
            speedup = float(m.get("speedup", 1.0))
            trs.append(
                "<tr>"
                f"<td>{_esc(key)}</td><td>{_esc(cfg)}</td>"
                f"<td>{float(m.get('default_us', 0)):,.0f} µs</td>"
                f"<td>{float(m.get('tuned_us', 0)):,.0f} µs</td>"
                f"<td>{_status(speedup >= 0.999, f'{speedup:.2f}x')}</td>"
                f"<td>{float(m.get('tuned_gbps', 0)):.2f}</td>"
                f"<td>{float(m.get('frac_of_roof', 0)) * 100:.1f}%</td>"
                "</tr>")
        else:
            trs.append(
                "<tr>"
                f"<td>{_esc(key)}</td><td>{_esc(cfg)}</td>"
                f"<td colspan=5>{_status(None, 'no measurement recorded')}"
                f"</td></tr>")
    return (f'<div class="card"><h2>Kernel tuning</h2>'
            f'<p class="sub">measured winners per workload key '
            f'(family|backend|impl|model|edge-bucket) from the repro.tune '
            f'cache; speedup = default time / tuned time on the same '
            f'operands</p><table>{hdr}{"".join(trs)}</table></div>')


def _section_backends(runtime) -> str:
    if not runtime or not runtime.get("backends"):
        return ""
    rows = []
    for name, b in runtime["backends"].items():
        if not b.get("available"):
            continue
        rows.append((name, b.get("seeds_per_s_warm", 0.0),
                     f"{name}: warm {b.get('warm_s', 0):.3f}s, "
                     f"cold {b.get('cold_s', 0):.3f}s, "
                     f"build {b.get('store_build_s', 0):.3f}s"))
    chart = _hbar_chart(rows, unit=" seeds/s")
    return (f'<div class="card"><h2>Runtime backends</h2>'
            f'<p class="sub">warm seed-selection throughput, '
            f'{_esc(runtime.get("graph", "?"))} '
            f'(n={_fmt(runtime.get("n", 0))}, m={_fmt(runtime.get("m", 0))})'
            f'</p>{chart}</div>')


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def write_report(path: str, *, title: str = "repro perf report",
                 runtime: Optional[dict] = None,
                 service: Optional[dict] = None,
                 events: Optional[Iterable[dict]] = None,
                 metrics_rows: Optional[Iterable[dict]] = None,
                 profiles: Optional[Iterable] = None,
                 slo: Optional[dict] = None,
                 tuning: Optional[dict] = None,
                 generated: str = "") -> str:
    """Render the report to ``path`` and return the path. Every section is
    optional — missing streams render as labelled empty states, never
    errors, so the report is safe to emit from any driver."""
    events = list(events or [])
    metrics_rows = list(metrics_rows or [])
    doc = [
        "<!doctype html>",
        '<html><head><meta charset="utf-8">',
        f"<title>{_esc(title)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{_esc(title)}</h1>",
        f'<p class="sub">{_esc(generated) if generated else ""}'
        f'{" · " if generated else ""}sections render empty when their '
        f"stream wasn't captured</p>",
        _section_tiles(runtime, service, slo),
        _section_backends(runtime),
        _section_phases(events),
        _section_skew(profiles, metrics_rows),
        _section_admission(service, metrics_rows),
        _section_tuning(tuning),
        _section_slo(slo),
        "</body></html>",
    ]
    with open(path, "w") as f:
        f.write("\n".join(doc))
    return path


def write_report_from_artifacts(path: str = "BENCH_report.html", *,
                                runtime_json: str = "BENCH_runtime.json",
                                service_json: str = "BENCH_service.json",
                                tuning_json: str = "TUNE_cache.json",
                                recorder=None, slo: Optional[dict] = None,
                                generated: str = "") -> str:
    """The harness entry point: stitch whatever the run left behind — the
    ``BENCH_*`` JSON records on disk, the tuning cache, the live trace
    recorder's spans, the global metrics registry, and the shard-profile
    ring."""
    from repro_torch.obs import metrics, shardprof, trace

    def _load(p):
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    tuning = None
    if os.path.exists(tuning_json):
        from repro_torch.tune.cache import TuningCache

        tuning = TuningCache(tuning_json).records() or None

    rec = recorder if recorder is not None else trace.get_recorder()
    return write_report(
        path,
        runtime=_load(runtime_json) if os.path.exists(runtime_json) else None,
        service=_load(service_json) if os.path.exists(service_json) else None,
        events=rec.events(),
        metrics_rows=metrics.registry().snapshot(),
        profiles=shardprof.profiles(),
        slo=slo,
        tuning=tuning,
        generated=generated)
