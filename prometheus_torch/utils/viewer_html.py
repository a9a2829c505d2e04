"""Self-contained interactive 3DGS scene viewer: one HTML file, WebGL2
(``prometheus_tpu/utils/viewer_html.py``, the same bytes).

``export_viewer_html`` writes one dependency-free HTML file with the
quantized ``.splat`` records base64-embedded and a WebGL2 gaussian-splat
renderer: open it in a browser (or host it anywhere) to orbit, pan and zoom
a generated scene, with per-splat EWA projection in the vertex shader,
depth-sorted alpha compositing and drag-and-drop of other ``.splat`` files.
``gaussians_to_splat_bytes`` quantizes a gaussian tuple (tensors on any
device, or numpy arrays) to those records in memory.

The shader's math is the renderer's (``ops/gaussian/projection.py``): 3D
covariance R(q) S S R(q)^T with quaternions (w, x, y, z), the EWA
perspective Jacobian, a +0.3 px low-pass, and a 3-sigma quad with the
gaussian weight evaluated in the eigenbasis.
"""
from __future__ import annotations

import base64
import os
import tempfile

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
  html, body { margin: 0; height: 100%; overflow: hidden; background: #111; }
  #c { width: 100%; height: 100%; display: block; }
  #hud { position: fixed; top: 8px; left: 10px; color: #ddd;
         font: 12px/1.5 monospace; user-select: none; pointer-events: none;
         text-shadow: 0 1px 2px #000; }
  #drop { position: fixed; inset: 0; display: none; align-items: center;
          justify-content: center; color: #fff; font: 20px monospace;
          background: rgba(30,90,160,.35); pointer-events: none; }
</style>
</head>
<body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="drop">drop a .splat file</div>
<script>
"use strict";
// ---- scene payload: 32-byte records [pos f32x3 | scale f32x3 | rgba u8x4 |
// ---- quat u8x4 (w,x,y,z)*128+128], importance-sorted (utils/gs_io.py) ----
const EMBED_B64 = "__DATA_B64__";
const FETCH_URL = "__FETCH_URL__";

const canvas = document.getElementById("c");
const hud = document.getElementById("hud");
const gl = canvas.getContext("webgl2", {antialias: false, alpha: false});
if (!gl) { hud.textContent = "WebGL2 required"; throw new Error("no webgl2"); }

const VS = `#version 300 es
precision highp float;
layout(location=0) in vec3 a_pos;
layout(location=1) in vec3 a_scale;
layout(location=2) in vec4 a_rgba;   // normalized u8
layout(location=3) in vec4 a_quat;   // normalized u8, (w,x,y,z)*128+128
uniform mat4 u_view;
uniform vec2 u_focal;
uniform vec2 u_viewport;
out vec4 v_color;
out vec2 v_c;
const float K = 3.0;                 // quad extent in sigmas
void main() {
  vec4 tv4 = u_view * vec4(a_pos, 1.0);
  vec3 tv = tv4.xyz;
  float d = -tv.z;                   // OpenGL: camera looks down -z
  if (d < 0.05) { gl_Position = vec4(0.0, 0.0, 2.0, 1.0); return; }

  // stored u8 = q*128+128; normalized attribute v in [0,1] -> (255v-128)/128
  vec4 q = normalize((a_quat * 255.0 - 128.0) / 128.0);
  float w = q.x, x = q.y, y = q.z, z = q.w;
  mat3 R = mat3(                      // column-major: columns of R
    vec3(1.0-2.0*(y*y+z*z), 2.0*(x*y+w*z), 2.0*(x*z-w*y)),
    vec3(2.0*(x*y-w*z), 1.0-2.0*(x*x+z*z), 2.0*(y*z+w*x)),
    vec3(2.0*(x*z+w*y), 2.0*(y*z-w*x), 1.0-2.0*(x*x+y*y)));
  mat3 M = mat3(R[0]*a_scale.x, R[1]*a_scale.y, R[2]*a_scale.z);
  mat3 cov3 = M * transpose(M);

  mat3 T = mat3(u_view);
  T[0].z = -T[0].z; T[1].z = -T[1].z; T[2].z = -T[2].z;
  mat3 J = mat3(
    vec3(u_focal.x / d, 0.0, 0.0),
    vec3(0.0, u_focal.y / d, 0.0),
    vec3(-u_focal.x * tv.x / (d*d), -u_focal.y * tv.y / (d*d), 0.0));
  mat3 A = J * T;
  mat3 c2 = A * cov3 * transpose(A);
  float c00 = c2[0][0] + 0.3, c11 = c2[1][1] + 0.3, c01 = c2[0][1];

  float mid = 0.5 * (c00 + c11);
  float disc = sqrt(max(0.25 * (c00 - c11) * (c00 - c11) + c01 * c01, 0.0));
  float l1 = mid + disc, l2 = max(mid - disc, 0.01);
  vec2 v1 = (abs(c01) > 1e-6) ? normalize(vec2(c01, l1 - c00))
                              : ((c00 >= c11) ? vec2(1.0, 0.0) : vec2(0.0, 1.0));
  vec2 v2 = vec2(-v1.y, v1.x);

  vec2 corner = vec2(float(gl_VertexID & 1) * 2.0 - 1.0,
                     float(gl_VertexID >> 1) * 2.0 - 1.0);
  vec2 off = corner.x * v1 * (K * sqrt(l1)) + corner.y * v2 * (K * sqrt(l2));
  vec2 center = vec2(u_focal.x * tv.x / d, u_focal.y * tv.y / d);
  gl_Position = vec4((center + off) / (0.5 * u_viewport), 0.0, 1.0);
  v_c = corner * K;
  v_color = vec4(a_rgba.rgb, a_rgba.a);
}`;

const FS = `#version 300 es
precision highp float;
in vec4 v_color;
in vec2 v_c;
out vec4 o;
void main() {
  float g = exp(-0.5 * dot(v_c, v_c));
  float a = v_color.a * g;
  if (a < 0.0039) discard;
  o = vec4(v_color.rgb * a, a);      // premultiplied; back-to-front over
}`;

function shader(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw new Error(gl.getShaderInfoLog(s));
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog);
if (!gl.getProgramParameter(prog, gl.LINK_STATUS))
  throw new Error(gl.getProgramInfoLog(prog));
gl.useProgram(prog);
const u_view = gl.getUniformLocation(prog, "u_view");
const u_focal = gl.getUniformLocation(prog, "u_focal");
const u_viewport = gl.getUniformLocation(prog, "u_viewport");

gl.disable(gl.DEPTH_TEST);
gl.enable(gl.BLEND);
gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);

// ---- scene state ----
let N = 0, raw = null, sorted = null, positions = null;
const vbo = gl.createBuffer();

function setAttribs() {
  gl.bindBuffer(gl.ARRAY_BUFFER, vbo);
  gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 32, 0);
  gl.vertexAttribPointer(1, 3, gl.FLOAT, false, 32, 12);
  gl.vertexAttribPointer(2, 4, gl.UNSIGNED_BYTE, true, 32, 24);
  gl.vertexAttribPointer(3, 4, gl.UNSIGNED_BYTE, true, 32, 28);
  for (let i = 0; i < 4; i++) {
    gl.enableVertexAttribArray(i);
    gl.vertexAttribDivisor(i, 1);
  }
}

const cam = {theta: 0.4, phi: 0.9, radius: 4.0,
             target: new Float32Array([0, 0, 0]), fovY: 60 * Math.PI / 180};

function loadScene(buf) {
  N = Math.floor(buf.byteLength / 32);
  raw = new Uint32Array(buf.slice(0, N * 32));
  sorted = new Uint32Array(N * 8);
  positions = new Float32Array(buf.slice(0, N * 32)); // strided view source
  gl.bindBuffer(gl.ARRAY_BUFFER, vbo);
  gl.bufferData(gl.ARRAY_BUFFER, raw.byteLength, gl.DYNAMIC_DRAW);
  setAttribs();
  // frame the scene: centroid + 90th-percentile radius
  let cx = 0, cy = 0, cz = 0;
  const step = Math.max(1, Math.floor(N / 5000));
  let m = 0;
  for (let i = 0; i < N; i += step) {
    cx += positions[i * 8]; cy += positions[i * 8 + 1];
    cz += positions[i * 8 + 2]; m++;
  }
  cx /= m; cy /= m; cz /= m;
  const d2 = [];
  for (let i = 0; i < N; i += step) {
    const dx = positions[i * 8] - cx, dy = positions[i * 8 + 1] - cy,
          dz = positions[i * 8 + 2] - cz;
    d2.push(dx * dx + dy * dy + dz * dz);
  }
  d2.sort((a, b) => a - b);
  cam.target.set([cx, cy, cz]);
  cam.radius = Math.max(0.5, 2.2 * Math.sqrt(d2[Math.floor(d2.length * 0.9)]));
  sortDirty = true;
}

// ---- depth sort (16-bit counting sort, back to front) ----
let sortDirty = true;
const BUCKETS = 65536;
const counts = new Uint32Array(BUCKETS);
let keys = null;
function depthSort(view) {
  if (keys === null || keys.length < N) keys = new Uint32Array(N);
  // view-space depth = -(row2 . p + tz); row-major math from column-major m
  const r0 = view[2], r1 = view[6], r2 = view[10], r3 = view[14];
  let dmin = Infinity, dmax = -Infinity;
  for (let i = 0; i < N; i++) {
    const d = -(r0 * positions[i * 8] + r1 * positions[i * 8 + 1] +
                r2 * positions[i * 8 + 2] + r3);
    keys[i] = d > 0 ? d * 4096 : 0;   // fixed point; clamp later
    if (keys[i] < dmin) dmin = keys[i];
    if (keys[i] > dmax) dmax = keys[i];
  }
  const range = Math.max(1, dmax - dmin);
  counts.fill(0);
  for (let i = 0; i < N; i++) {
    const b = Math.min(BUCKETS - 1, ((keys[i] - dmin) * (BUCKETS - 1) / range) | 0);
    keys[i] = b;
    counts[b]++;
  }
  // back-to-front: farthest (largest bucket) first
  let acc = 0;
  for (let b = BUCKETS - 1; b >= 0; b--) { const c = counts[b]; counts[b] = acc; acc += c; }
  for (let i = 0; i < N; i++) {
    const slot = counts[keys[i]]++;
    const src = i * 8, dst = slot * 8;
    for (let k = 0; k < 8; k++) sorted[dst + k] = raw[src + k];
  }
  gl.bindBuffer(gl.ARRAY_BUFFER, vbo);
  gl.bufferSubData(gl.ARRAY_BUFFER, 0, sorted);
}

// ---- camera ----
function viewMatrix() {
  const ct = Math.cos(cam.theta), st = Math.sin(cam.theta);
  const cp = Math.cos(cam.phi), sp = Math.sin(cam.phi);
  const eye = [cam.target[0] + cam.radius * sp * st,
               cam.target[1] + cam.radius * cp,
               cam.target[2] + cam.radius * sp * ct];
  const f = norm3(sub3(cam.target, eye));       // forward
  const r = norm3(cross3(f, [0, 1, 0]));
  const u = cross3(r, f);
  // column-major OpenGL view matrix
  return new Float32Array([
    r[0], u[0], -f[0], 0,
    r[1], u[1], -f[1], 0,
    r[2], u[2], -f[2], 0,
    -dot3(r, eye), -dot3(u, eye), dot3(f, eye), 1]);
}
function sub3(a, b) { return [a[0]-b[0], a[1]-b[1], a[2]-b[2]]; }
function dot3(a, b) { return a[0]*b[0] + a[1]*b[1] + a[2]*b[2]; }
function cross3(a, b) { return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2],
                                a[0]*b[1]-a[1]*b[0]]; }
function norm3(a) { const l = Math.hypot(a[0], a[1], a[2]) || 1;
                    return [a[0]/l, a[1]/l, a[2]/l]; }

// ---- input ----
let dragging = 0;
canvas.addEventListener("mousedown", e => { dragging = e.button === 0 && !e.shiftKey ? 1 : 2; });
window.addEventListener("mouseup", () => { dragging = 0; sortDirty = true; });
window.addEventListener("mousemove", e => {
  if (!dragging) return;
  if (dragging === 1) {
    cam.theta -= e.movementX * 0.005;
    cam.phi = Math.min(Math.PI - 0.05, Math.max(0.05, cam.phi - e.movementY * 0.005));
  } else {
    const v = viewMatrix();
    const s = cam.radius * 0.0015;
    cam.target[0] -= (v[0] * e.movementX - v[1] * e.movementY) * s;
    cam.target[1] -= (v[4] * e.movementX - v[5] * e.movementY) * s;
    cam.target[2] -= (v[8] * e.movementX - v[9] * e.movementY) * s;
  }
  sortDirty = true;
});
canvas.addEventListener("contextmenu", e => e.preventDefault());
canvas.addEventListener("wheel", e => {
  cam.radius *= Math.exp(e.deltaY * 0.001);
  sortDirty = true;
  e.preventDefault();
}, {passive: false});

// drag & drop another .splat
window.addEventListener("dragover", e => {
  e.preventDefault(); document.getElementById("drop").style.display = "flex";
});
window.addEventListener("dragleave", () =>
  document.getElementById("drop").style.display = "none");
window.addEventListener("drop", e => {
  e.preventDefault();
  document.getElementById("drop").style.display = "none";
  const f = e.dataTransfer.files[0];
  if (f) f.arrayBuffer().then(loadScene);
});

// ---- main loop ----
let frames = 0, fpsT = performance.now(), fps = 0, lastSort = 0;
function frame(now) {
  const w = canvas.clientWidth * devicePixelRatio,
        h = canvas.clientHeight * devicePixelRatio;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.07, 0.07, 0.09, 1.0);
  gl.clear(gl.COLOR_BUFFER_BIT);
  if (N > 0) {
    const v = viewMatrix();
    if (sortDirty && now - lastSort > 120) {
      depthSort(v); sortDirty = false; lastSort = now;
    }
    const fpx = 0.5 * h / Math.tan(cam.fovY / 2);
    gl.uniformMatrix4fv(u_view, false, v);
    gl.uniform2f(u_focal, fpx, fpx);
    gl.uniform2f(u_viewport, w, h);
    gl.drawArraysInstanced(gl.TRIANGLE_STRIP, 0, 4, N);
  }
  frames++;
  if (now - fpsT > 500) {
    fps = frames * 1000 / (now - fpsT); frames = 0; fpsT = now;
    hud.textContent = `__TITLE__ — ${N.toLocaleString()} splats — ` +
      `${fps.toFixed(0)} fps\\ndrag orbit · right-drag/shift pan · wheel zoom` +
      ` · drop a .splat to swap`;
  }
  requestAnimationFrame(frame);
}
requestAnimationFrame(frame);

// ---- boot ----
if (EMBED_B64.length > 0) {
  const bin = atob(EMBED_B64);
  const buf = new ArrayBuffer(bin.length);
  const u8 = new Uint8Array(buf);
  for (let i = 0; i < bin.length; i++) u8[i] = bin.charCodeAt(i);
  loadScene(buf);
} else if (FETCH_URL.length > 0) {
  fetch(FETCH_URL).then(r => r.arrayBuffer()).then(loadScene)
    .catch(e => hud.textContent = "failed to fetch " + FETCH_URL + ": " + e);
} else {
  hud.textContent = "drop a .splat file to view";
}
</script>
</body>
</html>
"""


def export_viewer_html(path: str, splat: "str | bytes | None" = None, *,
                       title: str = "prometheus-tpu scene",
                       fetch_url: str = "", max_splats: int = 500_000) -> str:
    """Write a standalone interactive viewer HTML; returns its path (with
    ``.html`` appended where it lacks it).

    ``splat``: a ``.splat`` file path or raw record bytes to base64-embed
    (``export_splat`` sorts the records by importance, so cutting them to
    ``max_splats`` keeps the most visible splats). Pass ``fetch_url``
    instead to reference an external file (needs an HTTP server), or
    neither for an empty drop-target viewer.
    """
    data = b""
    if isinstance(splat, (bytes, bytearray)):
        data = bytes(splat)
    elif isinstance(splat, str):
        with open(splat, "rb") as fp:
            data = fp.read()
    data = data[: max_splats * 32]
    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__DATA_B64__", base64.b64encode(data).decode())
            .replace("__FETCH_URL__", fetch_url))
    if not path.endswith(".html"):
        path += ".html"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fp:
        fp.write(html)
    return path


def gaussians_to_splat_bytes(gaussians,
                             opacity_threshold: float = 0.0) -> bytes:
    """Quantize a gaussian tuple (tensors or numpy arrays, batched or not)
    to ``.splat`` records in memory."""
    from .gs_io import export_splat

    arrays = [np.asarray(g.detach().float().cpu()) if hasattr(g, "detach")
              else np.asarray(g, np.float32) for g in gaussians]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.splat")
        export_splat(path, arrays, opacity_threshold)
        with open(path, "rb") as fp:
            return fp.read()
