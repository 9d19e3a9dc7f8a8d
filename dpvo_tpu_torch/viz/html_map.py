"""Self-contained interactive 3D map export.

Copy of ``dpvo_tpu/viz/html_map.py`` (numpy only): one HTML file with the
point cloud, camera trajectory and frusta embedded, plus a dependency-free
canvas renderer (drag to orbit, wheel to zoom, shift-drag to pan), so the
map can be inspected from any browser with no server and no network.  It
writes the same bytes as the JAX package's ``export_html`` for the same
inputs.
"""
from __future__ import annotations

import json
import os

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dpvo_tpu map</title>
<style>
 body {{ margin:0; background:#111; color:#ccc; font:12px monospace; }}
 #hud {{ position:fixed; top:8px; left:8px; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">dpvo_tpu map — {npts} points, {ncam} cameras.
 drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
{video_pane}
<canvas id="c"></canvas>
<script>
const PTS = {pts};     // [x,y,z,r,g,b] flat
const CAMS = {cams};   // camera centers [x,y,z] flat
const SEGS = {segs};   // frustum segments [x0,y0,z0,x1,y1,z1] flat
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let yaw = -0.5, pitch = -0.4, dist = {dist}, cx = {cx}, cy = {cy},
    cz = {cz}, panx = 0, pany = 0;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; }}
addEventListener('resize', () => {{ resize(); draw(); }});
resize();
function proj(x, y, z) {{
  x -= cx; y -= cy; z -= cz;
  const cyw = Math.cos(yaw), syw = Math.sin(yaw);
  const cpt = Math.cos(pitch), spt = Math.sin(pitch);
  let x1 = cyw * x + syw * z, z1 = -syw * x + cyw * z;
  let y2 = cpt * y - spt * z1, z2 = spt * y + cpt * z1;
  z2 += dist;
  if (z2 < 0.05) return null;
  const f = 0.9 * Math.min(cv.width, cv.height) / z2;
  return [cv.width / 2 + f * x1 + panx,
          cv.height / 2 + f * y2 + pany, z2];
}}
function draw() {{
  ctx.fillStyle = '#111';
  ctx.fillRect(0, 0, cv.width, cv.height);
  for (let i = 0; i < PTS.length; i += 6) {{
    const p = proj(PTS[i], PTS[i+1], PTS[i+2]);
    if (!p) continue;
    ctx.fillStyle = `rgb(${{PTS[i+3]}},${{PTS[i+4]}},${{PTS[i+5]}})`;
    const s = Math.max(1, 3 - p[2] * 0.2);
    ctx.fillRect(p[0], p[1], s, s);
  }}
  ctx.strokeStyle = '#e33'; ctx.beginPath();
  for (let i = 0; i < CAMS.length; i += 3) {{
    const p = proj(CAMS[i], CAMS[i+1], CAMS[i+2]);
    if (!p) continue;
    if (i === 0) ctx.moveTo(p[0], p[1]); else ctx.lineTo(p[0], p[1]);
  }}
  ctx.stroke();
  ctx.strokeStyle = '#3b3';
  for (let i = 0; i < SEGS.length; i += 6) {{
    const a = proj(SEGS[i], SEGS[i+1], SEGS[i+2]);
    const b = proj(SEGS[i+3], SEGS[i+4], SEGS[i+5]);
    if (!a || !b) continue;
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    ctx.stroke();
  }}
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panx += dx; pany += dy; }}
  else {{ yaw += dx * 0.008; pitch += dy * 0.008; }}
  drag = [e.clientX, e.clientY, drag[2]];
  draw();
}};
cv.onwheel = e => {{
  dist *= Math.exp(e.deltaY * 0.001);
  e.preventDefault();
  draw();
}};
draw();
</script></body></html>
"""


def _video_pane_html(image_bgr):
    """Latest camera frame as an embedded JPEG/PNG corner pane — the
    analog of DPViewer's live video texture (ref viewer.cpp:279-288
    composites the current frame into the GL window each draw)."""
    import base64
    img = np.asarray(image_bgr)[..., ::-1]    # BGR -> RGB
    try:
        import cv2
        ok, buf = cv2.imencode(".jpg", img[..., ::-1])
        if not ok:
            return ""
        b64 = base64.b64encode(buf.tobytes()).decode()
        mime = "image/jpeg"
    except ImportError:
        import io
        try:
            from PIL import Image
            bio = io.BytesIO()
            Image.fromarray(img).save(bio, format="PNG")
            b64 = base64.b64encode(bio.getvalue()).decode()
            mime = "image/png"
        except ImportError:
            return ""
    return ('<img id="video" src="data:{};base64,{}" style="position:'
            'fixed;right:8px;top:8px;max-width:320px;border:1px solid '
            '#444" alt="current frame">'.format(mime, b64))


def export_html(path, points, colors, cam_centers, frustum_segments=(),
                max_points=60000, image=None):
    """Write an interactive map HTML.

    points (P, 3) f32 world; colors (P, 3) uint8 RGB;
    cam_centers (N, 3); frustum_segments iterable of (2, 3) arrays;
    image optional (H, W, 3) uint8 BGR latest camera frame, embedded as
    a video pane like the reference viewer's texture overlay.
    """
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8)
    if len(points) > max_points:
        sel = np.linspace(0, len(points) - 1, max_points).astype(int)
        points, colors = points[sel], colors[sel]

    ok = np.isfinite(points).all(axis=1)
    points, colors = points[ok], colors[ok]

    center = (np.median(points, axis=0) if len(points)
              else np.zeros(3, np.float32))
    spread = (np.percentile(np.linalg.norm(points - center, axis=1), 90)
              if len(points) else 1.0)

    pts_flat = np.concatenate(
        [points, colors.astype(np.float32)], axis=1).reshape(-1)
    segs = np.asarray([s for s in frustum_segments], np.float32)
    html = _TEMPLATE.format(
        npts=len(points), ncam=len(cam_centers),
        pts=json.dumps(np.round(pts_flat, 3).tolist()),
        cams=json.dumps(np.round(np.asarray(cam_centers, np.float32)
                                 .reshape(-1), 3).tolist()),
        segs=json.dumps(np.round(segs.reshape(-1), 3).tolist()
                        if len(segs) else []),
        dist=float(3.0 * spread + 1e-3),
        cx=float(center[0]), cy=float(center[1]), cz=float(center[2]),
        video_pane=_video_pane_html(image) if image is not None else "")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
