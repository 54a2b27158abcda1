"""Dashboard: HTTP view over the state API + metrics, with a
single-file UI.

Reference: ``python/ray/dashboard/`` (aiohttp head + React SPA)
[UNVERIFIED — mount empty, SURVEY.md §0]. The aggregation layer is
what matters architecturally — GCS + scheduler + store state behind
HTTP. The UI is deliberately a build-less single HTML file (tabbed
tables over the JSON APIs, auto-refresh, zero dependencies) rather
than a React bundle: same information surface, no toolchain.

  GET /                 tabbed UI (summary/nodes/actors/tasks/...)
  GET /api/summary      cluster summary
  GET /api/nodes|actors|tasks|objects|workers
  GET /metrics          Prometheus exposition
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:ui-monospace,monospace;margin:1.5em;background:#fafafa}
 h1{font-size:1.3em} .mut{color:#777}
 nav button{font:inherit;margin-right:.4em;padding:.3em .8em;border:1px
  solid #bbb;background:#fff;cursor:pointer;border-radius:4px}
 nav button.on{background:#2a6df4;color:#fff;border-color:#2a6df4}
 table{border-collapse:collapse;margin-top:1em;background:#fff}
 td,th{border:1px solid #ccc;padding:4px 8px;text-align:left;
  font-size:.85em;max-width:28em;overflow:hidden;text-overflow:ellipsis}
 th{background:#eee} pre{background:#fff;border:1px solid #ccc;
  padding:1em;display:inline-block;min-width:24em}
</style></head><body>
<h1>ray_tpu_torch <span class="mut" id="refreshed"></span></h1>
<nav id="nav"></nav><div id="content">summary loading…</div>
<p class="mut"><a href="/metrics">/metrics</a> (Prometheus)</p>
<script>
const TABS = ["summary","nodes","actors","tasks","objects","workers",
              "timeline","metrics"];
// metrics tab: the browser polls /metrics and keeps its own history —
// sparkline time series without any server-side state
const SERIES = {};
async function pollMetrics(){
  try {
    const text = await (await fetch("/metrics")).text();
    for (const line of text.split("\\n")) {
      if (!line || line.startsWith("#")) continue;
      const sp = line.lastIndexOf(" ");
      const name = line.slice(0, sp), v = parseFloat(line.slice(sp+1));
      if (!isFinite(v)) continue;
      (SERIES[name] = SERIES[name] || []).push(v);
      if (SERIES[name].length > 120) SERIES[name].shift();
    }
  } catch (e) {}
}
setInterval(pollMetrics, 3000); pollMetrics();
function spark(vals, w, h){
  const mn = Math.min(...vals), mx = Math.max(...vals);
  const span = (mx - mn) || 1;
  const pts = vals.map((v,i) =>
    `${(i/(Math.max(vals.length-1,1)))*w},${h-2-((v-mn)/span)*(h-6)}`);
  return `<polyline points="${pts.join(" ")}" fill="none" `
    + `stroke="#2a6df4" stroke-width="1.5"/>`;
}
function metricsView(){
  const names = Object.keys(SERIES).sort();
  if (!names.length) return "<p>collecting…</p>";
  let s = `<p class="mut">${names.length} series · 3s samples · `
    + `last ${SERIES[names[0]].length} points (browser-side)</p><table>`;
  for (const n of names){
    const vals = SERIES[n];
    const last = vals[vals.length-1];
    s += `<tr><td>${esc(n)}</td><td>${last}</td>`
      + `<td><svg width="240" height="36">${spark(vals,238,36)}</svg>`
      + `</td></tr>`;
  }
  return s + "</table>";
}
let tab = location.hash.slice(1) || "summary";
const nav = document.getElementById("nav");
TABS.forEach(t => {
  const b = document.createElement("button");
  b.textContent = t; b.id = "tab-" + t;
  b.onclick = () => { tab = t; location.hash = t; render(); };
  nav.appendChild(b);
});
function esc(t){
  const d = document.createElement("div");
  d.textContent = t;
  return d.innerHTML;
}
function cell(v){
  if (v === null || v === undefined) return "";
  if (typeof v === "object") return esc(JSON.stringify(v));
  return esc(String(v));
}
function table(rows){
  if (!rows || !rows.length) return "<p>none</p>";
  const cols = Object.keys(rows[0]);
  let h = "<table><tr>" + cols.map(c=>`<th>${esc(c)}</th>`).join("")
    + "</tr>";
  for (const r of rows.slice(-200))
    h += "<tr>" + cols.map(c=>`<td>${cell(r[c])}</td>`).join("") + "</tr>";
  return h + "</table>";
}
function timeline(evts){
  if (!evts || !evts.length) return "<p>no finished tasks yet</p>";
  evts = evts.slice(-400);
  const t0 = Math.min(...evts.map(e=>e.ts));
  const t1 = Math.max(...evts.map(e=>e.ts+e.dur));
  const span = Math.max(t1 - t0, 1);
  const lanes = [...new Set(evts.map(e=>e.tid))].sort((a,b)=>a-b);
  const W = 900, H = 18, PAD = 70;
  let s = `<p class="mut">${evts.length} task spans · `
    + `${(span/1e6).toFixed(2)}s window · lane = worker</p>`
    + `<svg width="${W+PAD+10}" height="${(lanes.length)*(H+4)+24}" `
    + `style="background:#fff;border:1px solid #ccc">`;
  lanes.forEach((lane,i) => {
    const y = i*(H+4)+4;
    s += `<text x="2" y="${y+13}" font-size="11" fill="#777">`
      + `w${esc(String(lane))}</text>`;
  });
  for (const e of evts){
    const i = lanes.indexOf(e.tid);
    const x = PAD + (e.ts - t0)/span*W;
    const w = Math.max(e.dur/span*W, 1.5);
    const y = i*(H+4)+4;
    const ms = (e.dur/1e3).toFixed(1);
    s += `<rect x="${x}" y="${y}" width="${w}" height="${H}" `
      + `fill="#2a6df4" opacity="0.75">`
      + `<title>${esc(e.name)} · ${ms}ms</title></rect>`;
  }
  return s + "</svg>";
}
async function render(){
  TABS.forEach(t => document.getElementById("tab-"+t)
    .classList.toggle("on", t === tab));
  try {
    if (tab === "metrics") {
      document.getElementById("content").innerHTML = metricsView();
      document.getElementById("refreshed").textContent =
        "· " + new Date().toLocaleTimeString();
      return;
    }
    const data = await (await fetch("/api/" + tab)).json();
    document.getElementById("content").innerHTML =
      tab === "summary" ? "<pre>" +
        JSON.stringify(data, null, 2) + "</pre>" :
      tab === "timeline" ? timeline(data) : table(data);
    document.getElementById("refreshed").textContent =
      "· " + new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("content").textContent = "fetch failed: "+e;
  }
}
render();
setInterval(render, 3000);
</script></body></html>"""


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch.util import metrics, state
        dash = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: ANN002
                pass

            def _send(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.rstrip("/")
                try:
                    if path == "/metrics":
                        self._send(metrics.prometheus_text().encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/api/summary":
                        self._send(json.dumps(state.summary()).encode(),
                                   "application/json")
                    elif path == "/api/timeline":
                        # Chrome-trace ("catapult") spans from the task
                        # event ring — the `ray timeline` surface; the
                        # UI's timeline tab renders the same payload.
                        from ray_tpu_torch._private import events
                        self._send(
                            json.dumps(events.get_task_events()).encode(),
                            "application/json")
                    elif path.startswith("/api/"):
                        kind = path[len("/api/"):]
                        fn = getattr(state, f"list_{kind}", None)
                        if fn is None:
                            self.send_error(404, f"unknown api {kind!r}")
                            return
                        rows = fn()
                        # server-side cap: a long session's task list
                        # would otherwise serialize MBs per 3s poll
                        if isinstance(rows, list) and len(rows) > 500:
                            rows = rows[-500:]
                        self._send(json.dumps(rows).encode(),
                                   "application/json")
                    elif path in ("", "/"):
                        self._send(_PAGE.encode(), "text/html")
                    else:
                        self.send_error(404)
                except Exception as e:  # noqa: BLE001
                    self.send_error(500, str(e)[:300])

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.2}, daemon=True,
            name="rtpu-dashboard")
        self._thread.start()

    def shutdown(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass    # double-shutdown / already-closed socket


_dashboard: Optional[Dashboard] = None


def start_dashboard(host: str = "127.0.0.1", port: int = 0
                    ) -> Tuple[str, int]:
    global _dashboard
    if _dashboard is None:
        _dashboard = Dashboard(host, port)
    return _dashboard.address


def stop_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        _dashboard.shutdown()
        _dashboard = None
