"""Browser viewer of the reconstruction service: one self-contained page
(counterpart of disinfect_slam_tpu/viz/viewer_html.py; the page is the
same string).

Replaces the reference's GLFW/ImGui interactive renderer
(modules/renderer_module.cc:20-102, examples/tsdf/offline.cc:101-137) on
hosts without a display: the virtual camera lives in the browser and each
view is rendered by the service (the splat renderer) and streamed as PNG.

Interactions (parity with the reference UI):
  - left-drag  = arcball orbit          (renderer_module.cc:34-45)
  - wheel      = zoom                    (renderer_module.cc:20-32)
  - right-drag = pan                     (renderer_module.cc:47-56)
  - follow-cam checkbox + behind slider  (renderer_module.cc:70-80)
  - Start / Pause / Step of the replay   (offline.cc:139-155)
  - bbox query -> voxel count + ms       (renderer_module.cc:82-102)
"""

VIEWER_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>disinfect-slam-tpu viewer</title>
<style>
  body { margin:0; background:#111; color:#ddd; font:13px monospace; }
  #bar { padding:6px 10px; background:#1b1b1b; display:flex; gap:12px;
         align-items:center; flex-wrap:wrap; }
  #bar button { background:#333; color:#ddd; border:1px solid #555;
                padding:3px 10px; cursor:pointer; }
  #bar button:hover { background:#444; }
  #bar input[type=number] { width:56px; background:#222; color:#ddd;
                            border:1px solid #444; }
  #view { display:block; margin:8px auto; border:1px solid #333;
          cursor:grab; image-rendering:pixelated; }
  #status { padding:4px 10px; color:#8a8; }
  label { user-select:none; }
</style>
</head>
<body>
<div id="bar">
  <b>disinfect-slam-tpu</b>
  <button id="start">Start</button>
  <button id="pause">Pause</button>
  <button id="step">Step</button>
  <label><input type="checkbox" id="follow"/> follow cam</label>
  <label>behind <input type="range" id="behind" min="0" max="3" step="0.1" value="1"/></label>
  <label>view <select id="mode"><option>normal</option><option>rgba</option></select></label>
  <label>res <select id="scale"><option value="1">full</option><option value="2" selected>half</option></select></label>
  <label>bbox <input type="text" id="bbox" size="22" value="-2,2,-2,2,0,4"/></label>
  <button id="query">Query</button>
  <span id="qres"></span>
</div>
<img id="view" width="640" height="360" draggable="false"/>
<div id="status"></div>
<script>
"use strict";
// virtual camera state (orbit around target)
let yaw = 0.0, pitch = -0.15, radius = 3.0;
let target = [0, 0, 1];
let followPose = null;      // latest cam_T_world from the SLAM stream
let dirty = true, busy = false, lastMs = 0;

const img = document.getElementById("view");
const W = 640, H = 360, FX = 320;

function v3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm(a){const n=Math.hypot(a[0],a[1],a[2])||1; return [a[0]/n,a[1]/n,a[2]/n];}

// cam_T_world for eye->target, up=(0,-1,0) -- mirrors viz/headless.look_at
function lookAt(eye, tgt) {
  const fwd = norm(v3(tgt, eye));
  let right = norm(cross([0,-1,0], fwd));
  if (!isFinite(right[0])) right = [1,0,0];
  const down = cross(fwd, right);
  return [
    right[0], right[1], right[2], -dot(right, eye),
    down[0],  down[1],  down[2],  -dot(down, eye),
    fwd[0],   fwd[1],   fwd[2],   -dot(fwd, eye),
    0, 0, 0, 1];
}

function orbitEye() {
  const cp = Math.cos(pitch);
  return [target[0] + radius*Math.sin(yaw)*cp,
          target[1] + radius*Math.sin(pitch),
          target[2] - radius*Math.cos(yaw)*cp];
}

function currentPose() {
  if (document.getElementById("follow").checked && followPose) {
    // pull the virtual camera `behind` metres back along the live
    // camera's forward axis (renderer_module.cc:70-80)
    const behind = parseFloat(document.getElementById("behind").value);
    const P = followPose;            // cam_T_world, row-major
    // world_T_cam: R^T, eye = -R^T t
    const R = [[P[0],P[4],P[8]],[P[1],P[5],P[9]],[P[2],P[6],P[10]]];
    const t = [P[3], P[7], P[11]];
    const eye = [-(R[0][0]*t[0]+R[0][1]*t[1]+R[0][2]*t[2]),
                 -(R[1][0]*t[0]+R[1][1]*t[1]+R[1][2]*t[2]),
                 -(R[2][0]*t[0]+R[2][1]*t[1]+R[2][2]*t[2])];
    const fwd = [R[0][2], R[1][2], R[2][2]];
    const back = [eye[0]-behind*fwd[0], eye[1]-behind*fwd[1], eye[2]-behind*fwd[2]];
    const tgt  = [eye[0]+fwd[0], eye[1]+fwd[1], eye[2]+fwd[2]];
    return lookAt(back, tgt);
  }
  return lookAt(orbitEye(), target);
}

async function renderLoop() {
  const follow = document.getElementById("follow").checked;
  if ((dirty || follow || playing) && !busy) {
    busy = true; dirty = false;
    const mode = document.getElementById("mode").value;
    // half-res render + display upscale: the reference renders its own
    // view at 640x360 every GUI frame (renderer_module.cc:104-109); at
    // half res the splat render is ~interactive-rate and the <img>
    // upscales to the same display size
    const s = parseInt(document.getElementById("scale").value);
    const pose = currentPose().map(x => x.toPrecision(7)).join(",");
    const t0 = performance.now();
    try {
      const r = await fetch(`/render?w=${W/s}&h=${H/s}&fx=${FX/s}&fmt=png&view=${mode}&pose=${pose}`);
      if (r.ok) {
        const blob = await r.blob();
        const url = URL.createObjectURL(blob);
        const old = img.src;
        img.src = url;
        if (old.startsWith("blob:")) URL.revokeObjectURL(old);
      }
    } catch (e) {}
    lastMs = performance.now() - t0;
    busy = false;
  }
  setTimeout(renderLoop, playing || document.getElementById("follow").checked ? 120 : 40);
}

let playing = false;
async function pollStatus() {
  try {
    const s = await (await fetch("/stats")).json();
    playing = !!(s.replay && s.replay.playing);
    let line = `blocks=${s.active_blocks}  frames=${s.frames}  render=${lastMs.toFixed(0)}ms`;
    if (s.replay) line += `  replay ${s.replay.frame}/${s.replay.total}` +
                          (s.replay.done ? " [done]" : playing ? " [playing]" : " [paused]");
    document.getElementById("status").textContent = line;
    if (document.getElementById("follow").checked) {
      const p = await (await fetch("/pose_json")).json();
      if (p.pose) followPose = p.pose;
    }
  } catch (e) {}
  setTimeout(pollStatus, 500);
}

// ---- mouse control ----
let drag = null;
img.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY, btn: e.button, shift: e.shiftKey};
  e.preventDefault();
});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.btn === 0 && !drag.shift) {          // arcball orbit
    yaw   += dx * 0.008;
    pitch = Math.max(-1.5, Math.min(1.5, pitch + dy * 0.008));
  } else {                                       // pan in the view plane
    const eye = orbitEye();
    const fwd = norm(v3(target, eye));
    const right = norm(cross([0,-1,0], fwd));
    const down = cross(fwd, right);
    const s = radius * 0.0016;
    for (let i = 0; i < 3; i++)
      target[i] += -dx * s * right[i] - dy * s * down[i];
  }
  dirty = true;
});
img.addEventListener("wheel", e => {
  radius *= Math.exp(e.deltaY * 0.001);
  radius = Math.max(0.05, Math.min(50, radius));
  dirty = true;
  e.preventDefault();
}, {passive: false});
img.addEventListener("contextmenu", e => e.preventDefault());

// ---- replay + query controls ----
async function ctrl(cmd) { try { await fetch(`/ctrl?cmd=${cmd}`); } catch (e) {} dirty = true; }
document.getElementById("start").onclick = () => ctrl("start");
document.getElementById("pause").onclick = () => ctrl("pause");
document.getElementById("step").onclick = () => ctrl("step");
document.getElementById("mode").onchange = () => dirty = true;
document.getElementById("follow").onchange = () => dirty = true;
document.getElementById("behind").oninput = () => dirty = true;
document.getElementById("query").onclick = async () => {
  const bbox = document.getElementById("bbox").value;
  const t0 = performance.now();
  try {
    const r = await (await fetch(`/query_json?bbox=${bbox}`)).json();
    document.getElementById("qres").textContent =
      `${r.count} voxels in ${(performance.now()-t0).toFixed(0)}ms`;
  } catch (e) { document.getElementById("qres").textContent = "query failed"; }
};

renderLoop();
pollStatus();
</script>
</body>
</html>
"""
