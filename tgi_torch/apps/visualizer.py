"""Interactive visualizer: a browser UI over the generator (twin of
``tgi/apps/visualizer.py``).

Behavioral parity target: viz/renderer.py:125-448 and the widget panels
(viz/*.py: latent, style mixing, truncation and noise, pose, FOV and
conditioning pose, render type, depth-sample multiplier, layer viewer,
backbone cache, performance readout). As in ``tgi``, the reference's
imgui/OpenGL widgets become an HTTP page: the sliders drive the renderer
and each frame comes back as a PNG. No GL, glfw or imgui.

Renders run eagerly on the generator's device (``tgi`` caches a jitted
render per depth multiplier and noise mode); each frame goes through the
tri-plane gather twice (coarse and fine pass). The backbone's planes are
cached for the last latent setting (the reference's backbone cache), so
moving the camera re-renders from them. z is drawn from torch's PRNG
seeded by the seed control, as ``gen_samples --seeds`` draws it, so a
seed gives another face than ``tgi``'s; ``z_fn`` replaces the draw.

Run:  python -m tgi_torch.apps.visualizer --network G.pt --port 8000
(``http.server``, Pillow and click are imported where they are used.)
"""

from __future__ import annotations

import collections
import io
import json
import os
import threading
import time
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from tgi_torch import default_device

PAGE = """<!doctype html>
<html><head><title>tgi_torch visualizer</title><style>
body{font-family:monospace;background:#111;color:#ddd;display:flex;gap:24px;padding:24px}
label{display:block;margin:6px 0 2px}input[type=range]{width:240px}
img{image-rendering:pixelated;border:1px solid #333}
select,input[type=number]{background:#222;color:#ddd;border:1px solid #444}
fieldset{border:1px solid #333;margin-bottom:8px}
</style></head><body>
<div>
<h3>tgi_torch visualizer</h3>
<fieldset><legend>latent</legend>
<label>seed <input id="seed" type="number" value="0"></label>
<label>truncation <input id="trunc" type="range" min="0" max="1" step="0.05" value="0.7"></label>
<label>trunc cutoff <input id="cutoff" type="number" value="14" min="0" max="14"></label>
</fieldset>
<fieldset><legend>style mixing (viz/stylemix_widget)</legend>
<label>mix seed <input id="mixseed" type="number" value="-1"></label>
<label>mix from layer <input id="mixlayer" type="range" min="0" max="14" step="1" value="7"></label>
</fieldset>
<fieldset><legend>pose (viz/pose_widget)</legend>
<label>yaw <input id="yaw" type="range" min="-0.8" max="0.8" step="0.02" value="0"></label>
<label>pitch <input id="pitch" type="range" min="-0.5" max="0.5" step="0.02" value="0"></label>
<label>fov <input id="fov" type="range" min="12" max="45" step="0.5" value="18.837"></label>
<label>cond yaw <input id="cyaw" type="range" min="-0.8" max="0.8" step="0.02" value="0"></label>
<label>cond pitch <input id="cpitch" type="range" min="-0.5" max="0.5" step="0.02" value="0"></label>
</fieldset>
<fieldset><legend>render (viz/render_type_widget)</legend>
<label>type <select id="rtype"><option>image</option><option>image_raw</option>
<option>image_depth</option><option>planes</option></select></label>
<label>plane / channel <input id="layerch" type="number" value="0" min="0" max="95"></label>
<label>depth mult <select id="mult"><option>1</option><option selected>2</option></select></label>
<label>noise <select id="noise"><option>const</option><option>random</option></select></label>
</fieldset>
<fieldset><legend>capture (viz/capture_widget)</legend>
<button id="capture">save png</button> <span id="saved"></span>
</fieldset>
<fieldset><legend>performance (viz/performance_widget)</legend>
<div id="stat"></div><div id="srvstat"></div>
</fieldset>
</div>
<img id="view" width="512" height="512">
<script>
const ids = ["seed","yaw","pitch","trunc","cutoff","rtype","mult","fov",
             "cyaw","cpitch","mixseed","mixlayer","noise","layerch"];
const els = ids.map(id=>document.getElementById(id));
let busy=false, dirty=false;
function params(){
  const q = new URLSearchParams();
  els.forEach(e=>q.set(e.id,e.value));
  return q;
}
async function refresh(){
  if(busy){dirty=true;return} busy=true;
  const q = params(); const t0=performance.now();
  const r = await fetch("/render?"+q); const b = await r.blob();
  document.getElementById("view").src = URL.createObjectURL(b);
  document.getElementById("stat").textContent =
      "round trip "+(performance.now()-t0).toFixed(0)+" ms";
  const s = await (await fetch("/stats")).json();
  document.getElementById("srvstat").textContent =
      "server render last "+s.last_ms.toFixed(1)+" ms / avg "
      +s.avg_ms.toFixed(1)+" ms ("+s.fps.toFixed(1)+" fps, "
      +s.frames+" frames)";
  busy=false; if(dirty){dirty=false;refresh()}
}
document.getElementById("capture").onclick = async ()=>{
  const r = await (await fetch("/capture?"+params())).json();
  document.getElementById("saved").textContent = r.path;
};
els.forEach(e=>e.addEventListener("input",refresh)); refresh();
</script></body></html>"""


class VisualizerState:
    """Render core with the plane cache (viz/renderer.py's backbone cache)
    and the performance readout. ``z_fn(seed, z_dim)`` -> [1, z_dim]
    replaces torch's draw of z."""

    def __init__(self, G, params, capture_dir="_screenshots", z_fn=None):
        self.G = G
        self.params = params
        self.capture_dir = capture_dir
        self.z_fn = z_fn
        self.device = params["mapping"]["fc0"]["weight"].device
        self._plane_cache = {}
        # The server's threads render one frame at a time.
        self._lock = threading.Lock()
        # Performance readout (viz/performance_widget.py): rolling
        # server-side render wall-clock over the last 20 frames.
        self._times = collections.deque(maxlen=20)
        self._frames = 0

    def stats(self):
        times = list(self._times)
        avg = (sum(times) / len(times)) if times else 0.0
        return {"last_ms": times[-1] * 1e3 if times else 0.0,
                "avg_ms": avg * 1e3,
                "fps": (1.0 / avg) if avg > 0 else 0.0,
                "frames": self._frames}

    def capture(self, **kwargs):
        """Save the current render as PNG (viz/capture_widget.py)."""
        from PIL import Image

        from tgi_torch.utils.image import to_uint8
        img = self.render(**kwargs)
        os.makedirs(self.capture_dir, exist_ok=True)
        path = os.path.join(self.capture_dir,
                            f"capture_{time.strftime('%Y%m%d_%H%M%S')}_"
                            f"{self._frames:05d}.png")
        Image.fromarray(to_uint8(img), "RGB").save(path)
        return path

    def _z(self, seed):
        if self.z_fn is not None:
            return self.z_fn(seed, self.G.cfg.z_dim).to(self.device)
        return torch.randn((1, self.G.cfg.z_dim),
                           generator=torch.Generator().manual_seed(
                               int(seed))).to(self.device)

    def _ws(self, G, seed, trunc, cutoff, cond):
        # cutoff=0 truncates no layer (x[:, :0] is an empty slice), not
        # all of them: the integer passes through.
        return G.mapping(self.params, self._z(seed), cond,
                         truncation_psi=trunc, truncation_cutoff=int(cutoff))

    def render(self, seed=0, yaw=0.0, pitch=0.0, trunc=0.7, cutoff=14,
               rtype="image", mult=2, fov=18.837, cyaw=0.0, cpitch=0.0,
               mixseed=-1, mixlayer=7, noise="const", layerch=0):
        """One frame, [3, H, W] float in [-1, 1] (numpy)."""
        with self._lock, torch.no_grad():
            t0 = time.perf_counter()
            out = self._render(seed, yaw, pitch, trunc, cutoff, rtype, mult,
                               fov, cyaw, cpitch, mixseed, mixlayer, noise,
                               layerch)
            self._times.append(time.perf_counter() - t0)
            self._frames += 1
        return out

    def _camera(self, yaw, pitch, fov):
        from tgi_torch.render.cameras import (fov_to_intrinsics,
                                              look_at_pose, pack_camera)
        cam = look_at_pose(np.pi / 2 + yaw, np.pi / 2 + pitch,
                           [0., 0., 0.2], radius=2.7, device=self.device)
        return pack_camera(cam[None], fov_to_intrinsics(fov,
                                                        device=self.device))

    def _render(self, seed, yaw, pitch, trunc, cutoff, rtype, mult, fov,
                cyaw, cpitch, mixseed, mixlayer, noise, layerch):
        G = self.G
        rk = G.cfg.rendering_kwargs
        if mult != 1:
            G = type(G)(G.cfg.with_rendering(
                depth_resolution=int(rk["depth_resolution"] * mult),
                depth_resolution_importance=int(
                    rk["depth_resolution_importance"] * mult)))
        c = self._camera(yaw, pitch, fov)
        # Conditioning pose (viz/pose_widget's cond-pose control).
        cond = self._camera(cyaw, cpitch, 18.837)

        ckey = (seed, round(trunc, 3), int(cutoff), round(cyaw, 3),
                round(cpitch, 3), int(mixseed), int(mixlayer))
        if ckey not in self._plane_cache:
            ws = self._ws(G, seed, trunc, cutoff, cond)
            if mixseed >= 0:
                # Style mixing (viz/stylemix_widget): layers >= mixlayer
                # take the mixing seed's w.
                ws_b = self._ws(G, int(mixseed), trunc, cutoff, cond)
                sel = (torch.arange(ws.shape[1], device=ws.device)
                       [None, :, None] >= int(mixlayer))
                ws = torch.where(sel, ws_b, ws)
            planes = G.backbone_planes(self.params, ws)
            self._plane_cache = {ckey: (ws, planes)}   # keep the last only
        ws, planes = self._plane_cache[ckey]

        if rtype == "planes":
            # Layer viewer (viz/layer_widget): one tri-plane channel.
            p = planes.float()[0].cpu().numpy()        # [3, 32, H, W]
            idx = int(layerch)
            img = p[(idx // 32) % 3, idx % 32]
            lo, hi = np.percentile(img, [1, 99])
            img = np.clip((img - lo) / max(hi - lo, 1e-8), 0, 1)
            return np.repeat(img[None], 3, axis=0) * 2 - 1

        out = G.synthesis(self.params, ws, c, det=True, planes=planes,
                          noise_mode=noise,
                          generator=torch.Generator(
                              device=self.device).manual_seed(int(seed)))
        img = out[rtype][0].float().cpu().numpy()
        if rtype == "image_depth":
            d = (img - img.min()) / (np.ptp(img) + 1e-8)
            img = np.repeat(d, 3, axis=0) * 2 - 1
        return img


def render_kwargs(query: dict) -> dict:
    """The render's controls from a URL query (first value of each)."""
    q = {k: v[0] for k, v in query.items()}
    return dict(
        seed=int(q.get("seed", 0)), yaw=float(q.get("yaw", 0)),
        pitch=float(q.get("pitch", 0)), trunc=float(q.get("trunc", 0.7)),
        cutoff=int(q.get("cutoff", 14)), rtype=q.get("rtype", "image"),
        mult=int(q.get("mult", 2)), fov=float(q.get("fov", 18.837)),
        cyaw=float(q.get("cyaw", 0)), cpitch=float(q.get("cpitch", 0)),
        mixseed=int(q.get("mixseed", -1)),
        mixlayer=int(q.get("mixlayer", 7)), noise=q.get("noise", "const"),
        layerch=int(q.get("layerch", 0)))


def make_handler(state: VisualizerState):
    """The request handler class serving ``state``: ``/`` (the page),
    ``/render`` (a PNG), ``/stats`` and ``/capture`` (JSON)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, ctype, body):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                return self._send("text/html", PAGE.encode())
            if url.path == "/stats":
                return self._send("application/json",
                                  json.dumps(state.stats()).encode())
            if url.path not in ("/render", "/capture"):
                self.send_response(404)
                self.end_headers()
                return
            kwargs = render_kwargs(parse_qs(url.query))
            if url.path == "/capture":
                path = state.capture(**kwargs)
                return self._send("application/json",
                                  json.dumps({"path": path}).encode())
            from PIL import Image

            from tgi_torch.utils.image import to_uint8
            buf = io.BytesIO()
            Image.fromarray(to_uint8(state.render(**kwargs)), "RGB").save(
                buf, format="PNG")
            self._send("image/png", buf.getvalue())

    return Handler


def serve(G, params, port=8000):
    """Serve the visualizer on 127.0.0.1 until interrupted."""
    from http.server import ThreadingHTTPServer
    state = VisualizerState(G, params)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    print(f"tgi_torch visualizer on http://127.0.0.1:{server.server_port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    """Command line: ``python -m tgi_torch.apps.visualizer --network
    G.pt``."""
    import click

    @click.command()
    @click.option("--network", required=True,
                  help="the port's .pt or a reference EG3D .pkl")
    @click.option("--port", default=8000)
    @click.option("--device", default=default_device())
    def cli(network, port, device):
        from tgi_torch.apps.run_pti import load_any_generator
        G, params = load_any_generator(network, device=device)
        serve(G, params, port)

    cli.main(args=argv, standalone_mode=True)


if __name__ == "__main__":
    main()
