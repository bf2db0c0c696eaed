"""Interactive camera-trajectory viewer: the port's counterpart of
vis_3d/cam_viz_tool.py.

The same `SLAMFrontend` API (update_pose / update_cam_trajectory /
update_mesh / reset / start / join / render) accumulates estimated and
ground-truth camera poses and writes a self-contained HTML viewer
(wireframe frusta and trajectory polylines on a canvas, drag to orbit,
scroll to zoom, a frame slider); the HTML is byte-equal to the root tool's
for the same poses.  `--save_rendering` also writes `cam_viz.png` through
vis_3d/render.py (numpy, no matplotlib; no legend: the ground truth in
grey, the estimate in tab:red).

Usage (API):
    fe = SLAMFrontend("out_dir").start()
    for i, pose in enumerate(c2w_list):         # pose: (4, 4) c2w
        fe.update_pose(i, pose, gt=False)
    fe.join()                                   # writes out_dir/cam_viz.html

Usage (CLI):
    python -m egom2p_torch.vis_3d.cam_viz_tool --recon pred_tok_cam.npy \
        [--gt gt_cam.npy] --output viz_dir [--save_rendering]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

# Frustum wireframe (reference: cam_viz_tool.py:14-26): apex + image plane
# corners + an "up" tick, drawn as line segments.
CAM_POINTS = np.array([
    [0, 0, 0], [-1, -1, 1.5], [1, -1, 1.5], [1, 1, 1.5], [-1, 1, 1.5],
    [-0.5, 1, 1.5], [0.5, 1, 1.5], [0, 1.2, 1.5]], dtype=np.float64)
CAM_LINES = np.array([[1, 2], [2, 3], [3, 4], [4, 1], [1, 3], [2, 4],
                      [1, 0], [0, 2], [3, 0], [0, 4], [5, 7], [7, 6]])


def camera_wireframe(pose: np.ndarray, scale: float = 0.005) -> np.ndarray:
    """(4,4) c2w pose -> (12, 2, 3) world-space line segments."""
    pts = CAM_POINTS * scale
    world = pts @ pose[:3, :3].T + pose[:3, 3]
    return np.stack([world[CAM_LINES[:, 0]], world[CAM_LINES[:, 1]]], axis=1)


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>cam_viz</title><style>
body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:8px}#c{display:block}
input[type=range]{width:320px;vertical-align:middle}
.sw{display:inline-block;width:10px;height:10px;margin:0 4px 0 12px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">drag: orbit &middot; scroll: zoom
 <span class="sw" style="background:#f33"></span>estimate
 <span class="sw" style="background:#ccc"></span>ground truth<br>
 frame <input id="fr" type="range" min="1" value="0"> <span id="fi"></span>
</div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const fr = document.getElementById('fr'), fi = document.getElementById('fi');
let W, H, yaw = 0.6, pitch = 0.4, zoom = 1.0;
function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener('resize', resize);
const all = [];
for (const tr of [DATA.est, DATA.gt]) for (const p of tr.traj) all.push(p);
let ctr=[0,0,0], rad=1e-6;
if (all.length){
  for (let k=0;k<3;k++) ctr[k]=all.reduce((s,p)=>s+p[k],0)/all.length;
  for (const p of all) rad=Math.max(rad, Math.hypot(p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2]));
}
function proj(p){
  const x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1=cy*x+sy*z, z1=-sy*x+cy*z;
  const y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  const d=3*rad/zoom, f=0.9*Math.min(W,H)/(2*rad)*(d/(d+z2+2*rad));
  return [W/2+f*x1, H/2-f*y2];
}
function line(a,b,col,w){const pa=proj(a),pb=proj(b);
  ctx.strokeStyle=col;ctx.lineWidth=w;ctx.beginPath();
  ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.stroke();}
function draw(){
  ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
  const n=+fr.value; fi.textContent=n+' / '+fr.max;
  for (const [tr,col] of [[DATA.gt,'#ccc'],[DATA.est,'#f33']]){
    const m=Math.min(n,tr.traj.length);
    for (let i=1;i<m;i++) line(tr.traj[i-1],tr.traj[i],col,1.5);
    for (const [idx,segs] of Object.entries(tr.frusta)){
      if (+idx>=m) continue;
      const last=(+idx===m-1);
      for (const s of segs) line(s[0],s[1],last?col:'#666',last?1.5:0.6);
    }
  }
}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-lx)*.008;
  pitch=Math.max(-1.5,Math.min(1.5,pitch+(e.clientY-ly)*.008));
  lx=e.clientX;ly=e.clientY;draw();};
cv.onwheel=e=>{zoom*=e.deltaY<0?1.1:0.9;zoom=Math.max(.1,Math.min(50,zoom));draw();e.preventDefault();};
fr.oninput=draw;
fr.max=Math.max(DATA.est.traj.length,DATA.gt.traj.length);fr.value=fr.max;
resize();
</script></body></html>
"""


class SLAMFrontend:
    """Accumulates poses and renders the HTML viewer on join()
    (reference API: cam_viz_tool.py:180-209)."""

    def __init__(self, output, init_pose=None, cam_scale=1.0,
                 save_rendering=False, near=0, estimate_c2w_list=None,
                 gt_c2w_list=None, frustum_every: int = 1):
        self.output = output
        self.cam_scale = cam_scale
        self.save_rendering = save_rendering
        self.frustum_every = max(1, int(frustum_every))
        self._est = {}
        self._gt = {}
        if estimate_c2w_list is not None:
            for i, p in enumerate(np.asarray(estimate_c2w_list)):
                self.update_pose(i, p, gt=False)
        if gt_c2w_list is not None:
            for i, p in enumerate(np.asarray(gt_c2w_list)):
                self.update_pose(i, p, gt=True)

    # -- reference-compatible surface ---------------------------------------
    def update_pose(self, index: int, pose, gt: bool = False):
        pose = np.asarray(pose, dtype=np.float64)
        assert pose.shape == (4, 4), "pose must be a (4,4) c2w matrix"
        (self._gt if gt else self._est)[int(index)] = pose

    def update_cam_trajectory(self, c2w_list, gt: bool = False):
        for i, p in enumerate(np.asarray(c2w_list)):
            self.update_pose(i, p, gt=gt)

    def update_mesh(self, path):  # meshes are an open3d-only nicety
        pass

    def reset(self):
        self._est.clear()
        self._gt.clear()

    def start(self):
        return self

    def join(self) -> str:
        return self.render()

    # -- rendering -----------------------------------------------------------
    def _track(self, poses: dict, extent: float) -> dict:
        idxs = sorted(poses)
        traj = [poses[i][:3, 3].tolist() for i in idxs]
        # frustum scale relative to scene extent (open3d used absolute 0.005)
        scale = 0.02 * extent * self.cam_scale
        frusta = {
            str(k): camera_wireframe(poses[i], scale).round(5).tolist()
            for k, i in enumerate(idxs) if k % self.frustum_every == 0
        }
        return {"traj": traj, "frusta": frusta}

    def _scene_extent(self) -> float:
        """ONE extent over est+gt: per-track scales would render the two
        sets of frusta at different sizes, reading as a fake scale error."""
        pts = [p[:3, 3] for poses in (self._est, self._gt)
               for p in poses.values()]
        arr = np.asarray(pts) if pts else np.zeros((1, 3))
        return float(np.linalg.norm(arr.max(0) - arr.min(0))) or 1.0

    def render(self) -> str:
        os.makedirs(self.output, exist_ok=True)
        extent = self._scene_extent()
        data = {"est": self._track(self._est, extent),
                "gt": self._track(self._gt, extent)}
        html = _HTML.replace("__DATA__", json.dumps(data))
        out = os.path.join(self.output, "cam_viz.html")
        with open(out, "w") as f:
            f.write(html)
        if self.save_rendering:
            self._render_png(os.path.join(self.output, "cam_viz.png"))
        print(f"wrote {out}")
        return out

    def _render_png(self, path: str):
        from egom2p_torch.vis_3d import render

        lines = [render.Polyline(np.stack([poses[i][:3, 3] for i in sorted(poses)]), color)
                 for poses, color in ((self._gt, "#b3b3b3"), (self._est, "#d62728")) if poses]
        render.render_png(path, lines)


def main(argv=None) -> str:
    """Parse `argv`, write the viewer (and the PNG), and return the HTML's
    path."""
    from egom2p_torch.data.cam_gaze import cam_9d_to_mat

    p = argparse.ArgumentParser("camera trajectory viewer (PyTorch port)")
    p.add_argument("--recon", required=True, help="(T, 9) or (T, 4, 4) npy")
    p.add_argument("--gt", default=None)
    p.add_argument("--output", default="cam_viz_out")
    p.add_argument("--save_rendering", action="store_true")
    args = p.parse_args(argv)

    def load(path):
        arr = np.load(path)
        if arr.ndim == 3 and arr.shape[-2:] == (4, 4):
            return arr
        return cam_9d_to_mat(arr)

    fe = SLAMFrontend(args.output, save_rendering=args.save_rendering).start()
    fe.update_cam_trajectory(load(args.recon), gt=False)
    if args.gt:
        fe.update_cam_trajectory(load(args.gt), gt=True)
    return fe.join()


if __name__ == "__main__":
    main()
