"""Live training dashboard: a stdlib HTTP server on loopback.

Counterpart of ``rsis_tpu/utils/dashboard.py`` (the reference's visdom
server, self-contained): under ``--visdom`` the trainer starts it on
``-port`` as a daemon thread beside the run. It reads the files
``utils/monitor.py`` writes into the model directory, so it also serves
a finished run (``python -m rsis_tpu_torch.utils.dashboard <model_dir>
[port]``):

  GET /          live loss curves (an inline-SVG page polling /metrics)
  GET /metrics   the metrics.jsonl records as a JSON array
  GET /snapshots JSON list of snapshot PNGs (the monitor's mask grids)
  GET /snap/<f>  one snapshot image
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html><html><head><title>rsis-tpu training</title>
<style>body{font-family:sans-serif;margin:20px;background:#fafafa}
svg{background:#fff;border:1px solid #ddd}h2{margin:8px 0 2px}
.legend span{margin-right:14px;font-size:13px}</style></head><body>
<h1>rsis-tpu live training</h1><div id=charts></div>
<h2>latest snapshot</h2><img id=snap style="max-width:900px"/>
<script>
const KEYS=["total","iou","stop","class"],COL={train:"#1668d6",val:"#d6381c"};
async function tick(){
 const recs=await (await fetch("metrics")).json();
 const div=document.getElementById("charts");div.innerHTML="";
 for(const k of KEYS){
  const w=900,h=160,pad=30;let svg=`<h2>${k}</h2>`+
   `<div class=legend><span style="color:${COL.train}">train</span>`+
   `<span style="color:${COL.val}">val</span></div>`+
   `<svg width=${w} height=${h}>`;
  for(const split of ["train","val"]){
   const ys=recs.filter(r=>r.split===split).map(r=>r[k]);
   if(!ys.length)continue;
   const ymax=Math.max(...ys,1e-9),ymin=Math.min(...ys,0);
   const pts=ys.map((y,i)=>`${pad+i*(w-2*pad)/Math.max(ys.length-1,1)},`+
     `${h-pad-(y-ymin)*(h-2*pad)/(ymax-ymin+1e-9)}`).join(" ");
   svg+=`<polyline fill=none stroke="${COL[split]}" points="${pts}"/>`;
  }
  div.innerHTML+=svg+"</svg>";
 }
 const snaps=await (await fetch("snapshots")).json();
 if(snaps.length)document.getElementById("snap").src="snap/"+snaps[snaps.length-1];
}
tick();setInterval(tick,2000);
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    model_dir = "."

    def log_message(self, *a):  # silence per-request stderr spam
        pass

    def _send(self, body: bytes, ctype: str = "text/html"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        d = self.model_dir
        if self.path in ("/", "/index.html"):
            return self._send(_PAGE.encode())
        if self.path == "/metrics":
            recs = []
            path = os.path.join(d, "metrics.jsonl")
            if os.path.exists(path):
                with open(path) as fp:
                    recs = [json.loads(ln) for ln in fp if ln.strip()]
            return self._send(json.dumps(recs).encode(), "application/json")
        if self.path == "/snapshots":
            snaps = sorted(f for f in os.listdir(d) if f.endswith(".png"))
            return self._send(json.dumps(snaps).encode(), "application/json")
        if self.path.startswith("/snap/"):
            name = os.path.basename(self.path[len("/snap/"):])
            path = os.path.join(d, name)
            if os.path.exists(path) and name.endswith(".png"):
                with open(path, "rb") as fp:
                    return self._send(fp.read(), "image/png")
        self.send_response(404)
        self.end_headers()


class Dashboard:
    """Daemon-thread HTTP server over a model dir's metrics/snapshots."""

    def __init__(self, model_dir: str, port: int = 8097,
                 host: str = "127.0.0.1"):
        # loopback by default: the metrics/snapshot server is
        # unauthenticated; pass host="0.0.0.0" deliberately to expose it
        handler = type("Handler", (_Handler,), {"model_dir": model_dir})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)

    def start(self) -> "Dashboard":
        self._thread.start()
        print(f"Dashboard live at http://localhost:{self.port}/")
        return self

    def stop(self) -> None:
        self.server.shutdown()


def main(argv=None):
    import sys
    args = argv if argv is not None else sys.argv[1:]
    model_dir = args[0] if args else "."
    port = int(args[1]) if len(args) > 1 else 8097
    Dashboard(model_dir, port).start()._thread.join()


if __name__ == "__main__":
    main()
