"""The port's host tools against the root tools that import the JAX package,
on seeded numpy inputs (the root tools are loaded by file path):

* egom2p_torch/vis_3d/vis_gaze.py: overlay_gaze bitwise vis_3d/vis_gaze.py's
  (resampling, NaN frames, points on and beyond the edges), and the CLI's
  mp4 through data/video_ingest.py decoded equal to the root CLI's;
* egom2p_torch/vis_3d/cam_viz_tool.py: the viewer's HTML byte-equal
  (frustum_every > 1, est-only and gt-only tracks, the CLI on (T, 9) and
  (T, 4, 4) files), and the --save_rendering PNG;
* egom2p_torch/vis_3d/vis_cam.py: the positions and ticks it draws bitwise
  the arrays vis_3d/vis_cam.py hands matplotlib (recorded through a
  stand-in module), and its PNG: size, colours at projected points, the
  decoder against Pillow's, and the screen directions of the x, y and z
  axes found in the pixels against matplotlib's default view;
* egom2p_torch/examples/tok_{cam,gaze}_example.py at a small width on a
  seeded .pth against the root examples (their CLI legs run in this
  process): tokens exactly, the reconstruction within RECON_ATOL and the
  printed metrics within METRIC_RTOL; --random-init reads no checkpoint;
* egom2p_torch/scripts/*.sh run by bash with `python` / `torchrun` /
  `gcloud` shims that record their argv: the port CLI's get_args gives
  every key it shares with the root CLI the root script's value.
"""
import ast
import importlib.util
import json
import os
import pathlib
import runpy
import shlex
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import egom2p_tpu.tokenizers.seq_vqvae as jseq
from egom2p_torch.cli import run_training as port_train_cli
from egom2p_torch.cli import run_training_vqvae as port_vqvae_cli
from egom2p_torch.core.checkpoint import save_seq_vqvae_pth
from egom2p_torch.data.cam_gaze import cam_9d_to_mat, smooth_cam_trajectories
from egom2p_torch.data.video_ingest import read_video, write_video
from egom2p_torch.examples import tok_cam_example, tok_gaze_example
from egom2p_torch.tokenizers.seq_vqvae import seq_vqvae_from_config
from egom2p_torch.vis_3d import cam_viz_tool, render, vis_cam, vis_gaze

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL_ARGS = ["--vq_dim", "64", "--vq_depth", "2", "--vq_heads", "2", "--latent_dim", "8",
              "--codebook_size", "16"]
SMALL_SEQ = dict(dim=64, depth=2, num_heads=2, latent_dim=8, codebook_size=16)
# fp32 through 2 + 2 blocks of 64 in two libraries (tests/test_torch_seq_vqvae.py:
# 3.8e-6 at most), the outputs denormalized by factors below 1
RECON_ATOL = 1e-5
# ATE / RTE / RRE and the gaze MSE: smooth functions of reconstructions whose
# entries (of order 0.1-1) agree to RECON_ATOL
METRIC_RTOL = 1e-5


def root_tool(relpath, name):
    """A root tool loaded from its file under its own module name."""
    spec = importlib.util.spec_from_file_location(name, REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_root_script(relpath, argv, monkeypatch):
    """Run a root script as __main__ with `argv`."""
    monkeypatch.setattr(sys, "argv", [str(REPO / relpath), *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends the repo
    runpy.run_path(str(REPO / relpath), run_name="__main__")


def seeded_poses(rng, n=60):
    """(n, 4, 4) c2w poses: a smooth path behind a random rigid transform."""
    mats = cam_9d_to_mat(smooth_cam_trajectories(rng, 1)[1][0])[:n]
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    first = np.eye(4)
    first[:3, :3] = q * np.sign(np.linalg.det(q))
    first[:3, 3] = rng.normal(size=3)
    return first @ mats


# ------------------------------------------------------------------ gaze overlay
GAZE_CASES = {
    # 60 gaze points onto 16 frames (the 30 fps track onto an 8 fps clip)
    "resampled": (16, lambda rng: rng.uniform(0, 1, (60, 2))),
    # NaN frames, points on the corners and beyond the edges (clipped)
    "nan_and_edges": (12, lambda rng: np.array(
        [[0, 0], [1, 1], [np.nan, 0.5], [-0.3, 1.7], [1, 0], [0.5, np.nan],
         [0.999, 0.001], [2.0, -1.0], [np.nan, np.nan], [0.5, 0.5]])),
    # fewer frames than gaze points, and a track shorter than the clip
    "short_track": (40, lambda rng: rng.uniform(-0.1, 1.1, (7, 2))),
}


@pytest.mark.parametrize("case", list(GAZE_CASES))
def test_overlay_gaze_is_bitwise_the_root_tools(case):
    root = root_tool("vis_3d/vis_gaze.py", "root_vis_gaze")
    rng = np.random.default_rng(1)
    frames, make = GAZE_CASES[case]
    video = rng.integers(0, 256, (frames, 64, 48, 3), dtype=np.uint8)
    gaze, gt = make(rng), make(rng)
    want = root.overlay_gaze(root.overlay_gaze(video, gaze), gt, color=(32, 255, 32))
    got = vis_gaze.overlay_gaze(vis_gaze.overlay_gaze(video, gaze), gt, color=(32, 255, 32))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, video)
    if case == "nan_and_edges":  # the frames whose point is NaN in both are untouched
        idx = np.linspace(0, len(gaze) - 1, frames).round().astype(int)
        blank = np.isnan(gaze[idx]).any(1) & np.isnan(gt[idx]).any(1)
        assert blank.sum() >= 2
        np.testing.assert_array_equal(got[blank], video[blank])


def test_gaze_cli_writes_the_root_clis_mp4(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    clip = tmp_path / "clip.mp4"
    write_video(str(clip), rng.integers(0, 256, (12, 96, 128, 3), dtype=np.uint8), fps=8.0)
    np.save(tmp_path / "pred.npy", rng.uniform(0, 1, (60, 2)))
    np.save(tmp_path / "gt.npy", rng.uniform(0, 1, (60, 2)))
    flags = ["--video", str(clip), "--gaze", str(tmp_path / "pred.npy"),
             "--gt", str(tmp_path / "gt.npy")]
    got = vis_gaze.main(flags + ["--output", str(tmp_path / "port")])
    assert got == str(tmp_path / "port" / "clip.mp4_gaze.mp4")
    run_root_script("vis_3d/vis_gaze.py", flags + ["--output", str(tmp_path / "jax")], monkeypatch)
    frames = read_video(got, out_size=256)
    assert frames.shape[1:] == (256, 256, 3) and len(frames) == 12
    np.testing.assert_array_equal(frames, read_video(str(tmp_path / "jax" / "clip.mp4_gaze.mp4"),
                                                     out_size=256))


# ------------------------------------------------------------ trajectory viewer
VIEWER_CASES = {"both_every_3": (True, True, 3), "est_only": (True, False, 1),
                "gt_only": (False, True, 2)}


@pytest.mark.parametrize("case", list(VIEWER_CASES))
def test_viewer_html_is_byte_equal(case, tmp_path):
    root = root_tool("vis_3d/cam_viz_tool.py", "root_cam_viz_tool")
    est, gt, every = VIEWER_CASES[case]
    rng = np.random.default_rng(3)
    poses = {"est": seeded_poses(rng), "gt": seeded_poses(rng, 45)}
    paths = []
    for module, name in ((root, "jax"), (cam_viz_tool, "port")):
        fe = module.SLAMFrontend(str(tmp_path / name), cam_scale=1.5,
                                 frustum_every=every).start()
        if est:
            for i, p in enumerate(poses["est"]):
                fe.update_pose(i, p, gt=False)
        if gt:
            fe.update_cam_trajectory(poses["gt"], gt=True)
        fe.update_mesh("mesh.ply")
        paths.append(fe.join())
    html = [pathlib.Path(p).read_bytes() for p in paths]
    assert html[0] == html[1]
    data = json.loads(html[1].split(b"const DATA = ")[1].split(b";\n")[0])
    assert len(data["est"]["traj"]) == (60 if est else 0)
    assert len(data["gt"]["frusta"]) == ((45 + every - 1) // every if gt else 0)


def test_viewer_cli_and_rendering(tmp_path, monkeypatch):
    """The CLI on a (T, 9) estimate and (T, 4, 4) ground truth: the root
    CLI's HTML, and a PNG with the estimate in tab:red."""
    root = root_tool("vis_3d/cam_viz_tool.py", "root_cam_viz_tool")
    rng = np.random.default_rng(4)
    np.save(tmp_path / "recon.npy", smooth_cam_trajectories(rng, 1)[1][0])
    np.save(tmp_path / "gt.npy", seeded_poses(rng))
    flags = ["--recon", str(tmp_path / "recon.npy"), "--gt", str(tmp_path / "gt.npy")]
    out = cam_viz_tool.main(flags + ["--output", str(tmp_path / "port"), "--save_rendering"])
    root.main(flags + ["--output", str(tmp_path / "jax")])
    assert pathlib.Path(out).read_bytes() == (tmp_path / "jax" / "cam_viz.html").read_bytes()
    img = render.read_png(tmp_path / "port" / "cam_viz.png")
    assert img.shape == (1200, 1200, 3)
    for color in ("#d62728", "#b3b3b3"):
        assert (img == render.rgb(color)).all(-1).sum() > 500, color


# ------------------------------------------------------------------- cam plot
def _record_matplotlib(monkeypatch):
    """A stand-in matplotlib whose 3-D axes record what they are handed."""
    calls = []

    class Axes:
        def plot(self, *xyz, **kw):
            calls.append(("plot", np.stack(xyz, axis=1), kw["color"]))

        def quiver(self, *args, **kw):
            calls.append(("quiver", np.array(args), kw["color"], kw["alpha"]))

        def __getattr__(self, name):
            return lambda *a, **kw: None

    class Figure:
        def add_subplot(self, *a, **kw):
            return Axes()

        def __getattr__(self, name):
            return lambda *a, **kw: None

    mpl = types.ModuleType("matplotlib")
    plt = types.ModuleType("matplotlib.pyplot")
    mpl.use, mpl.pyplot = lambda *a, **kw: None, plt
    plt.figure, plt.close = lambda *a, **kw: Figure(), lambda *a, **kw: None
    monkeypatch.setitem(sys.modules, "matplotlib", mpl)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", plt)
    return calls


@pytest.mark.parametrize("form", ["9d_with_gt", "poses_alone"])
def test_cam_plot_arrays_are_the_root_tools(form, tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    poses = [seeded_poses(rng), seeded_poses(rng)]
    if form == "9d_with_gt":
        np.save(tmp_path / "recon.npy", smooth_cam_trajectories(rng, 1)[1][0])
        np.save(tmp_path / "gt.npy", poses[1])
        flags = ["--recon", str(tmp_path / "recon.npy"), "--gt", str(tmp_path / "gt.npy")]
    else:
        np.save(tmp_path / "recon.npy", poses[0])
        flags = ["--recon", str(tmp_path / "recon.npy")]
    calls = _record_matplotlib(monkeypatch)
    run_root_script("vis_3d/vis_cam.py", flags + ["--output", str(tmp_path / "jax")], monkeypatch)
    monkeypatch.undo()

    recon = vis_cam.load_traj(str(tmp_path / "recon.npy"))
    gt = vis_cam.load_traj(str(tmp_path / "gt.npy")) if form == "9d_with_gt" else None
    tracks = vis_cam.trajectory_tracks(recon, gt)
    assert [t.label for t in tracks] == (["ground truth", "reconstruction"] if gt is not None
                                         else ["reconstruction"])
    want = iter(calls)
    for track, mpl_color in zip(tracks, ["tab:blue", "tab:red"][-len(tracks):]):
        kind, xyz, color = next(want)
        assert kind == "plot" and color == mpl_color
        np.testing.assert_array_equal(track.positions, xyz)
        assert len(track.ticks) == 6
        for tail, z in track.ticks:
            kind, args, color, alpha = next(want)
            assert (kind, color, alpha) == ("quiver", mpl_color, 0.5)
            np.testing.assert_array_equal(np.concatenate([tail, z]), args)
    assert next(want, None) is None
    out = vis_cam.main(flags + ["--output", str(tmp_path / "port")])
    assert render.read_png(out).shape == (1200, 1200, 3)


def test_cam_plot_png_colours_at_projected_points(tmp_path):
    rng = np.random.default_rng(6)
    recon, gt = smooth_cam_trajectories(rng, 2)[1]
    tracks, limits = vis_cam.plot_trajectories(recon, gt, str(tmp_path / "t.png"))
    img = render.read_png(tmp_path / "t.png")
    assert img.shape == (1200, 1200, 3)
    assert (img[0, 0] == 255).all() and (img[-1, -1] == 255).all()
    for track, color in zip(tracks, ("#1f77b4", "#d62728")):
        xy = np.rint(render.project(track.positions, limits)).astype(int)
        assert ((0 <= xy) & (xy < 1200)).all()
        hit = (img[xy[:, 1], xy[:, 0]] == render.rgb(color)).all(-1)
        assert hit.mean() > 0.5, (track.label, hit.mean())


def test_read_png_is_pillows_decoding(tmp_path):
    """render.read_png against an independent decoder, and its refusals."""
    from PIL import Image
    img = np.random.default_rng(8).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    render.write_png(str(tmp_path / "a.png"), img)
    with Image.open(tmp_path / "a.png") as pil:
        assert pil.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(pil), img)
    np.testing.assert_array_equal(render.read_png(str(tmp_path / "a.png")), img)
    data = bytearray((tmp_path / "a.png").read_bytes())
    data[40] ^= 1                                          # a byte of the IDAT chunk
    (tmp_path / "b.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        render.read_png(str(tmp_path / "b.png"))
    Image.fromarray(img[:, :, 0]).save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="8-bit RGB"):
        render.read_png(str(tmp_path / "gray.png"))


# matplotlib's default 3-D view (elevation 30, azimuth -60) moves the screen
# point of a box-side step along x by (cos 30, sin 30 sin 30) right / down,
# along y by (sin 30, -cos 30 sin 30), along z by (0, -cos 30), in px per px
# of the box's scale (worked by hand from the view, not from render.project)
MPL_DEFAULT_VIEW_STEPS = {"x": (0.75 ** 0.5, 0.25), "y": (0.5, -0.1875 ** 0.5),
                          "z": (0.0, -0.75 ** 0.5)}


def test_render_view_is_matplotlibs_default(tmp_path):
    """Three unit segments from the origin along x, y and z, each in its
    own colour, found in the decoded pixels without render.project: the
    limits are the data's with a 5% margin, each stroke runs in its axis's
    screen direction of matplotlib's default view, all three start at one
    point (no axis is flipped), and one scale serves all three (equal box
    sides)."""
    colours = {"x": "#ff0000", "y": "#00ff00", "z": "#0000ff"}
    lines = [render.Polyline(np.array([[0.0, 0.0, 0.0], np.eye(3)[i]]), colours[a])
             for i, a in enumerate("xyz")]
    limits = render.render_png(str(tmp_path / "axes.png"), lines)
    np.testing.assert_allclose(limits, [[-0.05, 1.05]] * 3)
    img = render.read_png(str(tmp_path / "axes.png"))
    starts, steps = {}, {}
    for axis, (right, down) in MPL_DEFAULT_VIEW_STEPS.items():
        rows, cols = np.nonzero((img == render.rgb(colours[axis])).all(-1))
        xy = np.stack([cols, rows], 1).astype(float)
        # the stroke's two ends: its extreme pixels along the expected direction
        along = xy @ np.array([right, down])
        starts[axis] = xy[along <= along.min() + 1].mean(0)
        steps[axis] = xy[along >= along.max() - 1].mean(0) - starts[axis]
    scale = np.linalg.norm(steps["z"]) / np.linalg.norm(MPL_DEFAULT_VIEW_STEPS["z"])
    for axis, want in MPL_DEFAULT_VIEW_STEPS.items():
        np.testing.assert_allclose(steps[axis], scale * np.array(want), atol=4, err_msg=axis)
        np.testing.assert_allclose(starts[axis], starts["z"], atol=4, err_msg=axis)
    # the origin is the box's (low, low, low) corner: bottom left of the centre
    assert starts["z"][0] < render.SIZE / 2 and starts["z"][1] > render.SIZE / 2


# ------------------------------------------------------------------- examples
@pytest.fixture(scope="module")
def example_files(tmp_path_factory):
    """Seeded small-width cam / gaze checkpoints and inputs: (60, 4, 4)
    poses and a (60, 2) gaze track in the 896 x 504 pixels the example
    converts from, with NaN frames and one far outside the frame."""
    d = tmp_path_factory.mktemp("examples")
    rng = np.random.default_rng(7)
    np.save(d / "cam.npy", seeded_poses(rng))
    gaze = np.stack([rng.uniform(220, 680, 60), rng.uniform(20, 480, 60)], axis=1)
    gaze[[3, 17, 40]] = np.nan
    gaze[50] = [2000.0, -400.0]
    np.save(d / "gaze.npy", gaze)
    for i, domain in enumerate(("cam", "gaze")):
        save_seq_vqvae_pth(seq_vqvae_from_config(
            domain, torch.Generator().manual_seed(10 + i), **SMALL_SEQ),
            str(d / f"checkpoint-{domain}.pth"))
    return d


EXAMPLES = {"cam": ("example_data/tok_cam_example.py", tok_cam_example),
            "gaze": ("example_data/tok_gaze_example.py", tok_gaze_example)}


def _metric_lines(text):
    """The example's report: the lines from its '#####' rule on."""
    lines = text.splitlines()
    return lines[next(i for i, line in enumerate(lines) if line.startswith("#####")):]


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_examples_match_the_root_examples(domain, example_files, tmp_path, monkeypatch, capsys):
    d = example_files
    root_cli = root_tool("run_training_vqvae.py", "root_run_training_vqvae")
    orig = jseq.seq_vqvae_from_config
    monkeypatch.setattr(jseq, "seq_vqvae_from_config",
                        lambda dom, rng, **kw: orig(dom, rng, **{**kw, **SMALL_SEQ}))
    legs = []

    def in_process(cmd, check):
        assert cmd[:2] == [sys.executable, str(REPO / "run_training_vqvae.py")] and check
        legs.append(cmd[2:])
        return root_cli.run_tokenize(root_cli.get_args(cmd[2:] + SMALL_ARGS))

    flags = ["--ckpt", str(d / f"checkpoint-{domain}.pth"), f"--{domain}", str(d / f"{domain}.npy")]
    script, port = EXAMPLES[domain]
    with monkeypatch.context() as m:  # the root example's two CLI runs, in this process
        m.setattr(subprocess, "run", in_process)
        run_root_script(script, flags + ["--out", str(tmp_path / "jax")], m)
    jax_report = _metric_lines(capsys.readouterr().out)
    metrics = port.main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"],
                        cli_args=SMALL_ARGS)
    port_report = _metric_lines(capsys.readouterr().out)
    assert [leg[-1] for leg in legs] == ["--no_log_wandb", "--recon"]

    tok = {k: np.load(tmp_path / k / "token" / f"{domain}-tok.npz")["arr_0"]
           for k in ("jax", "port")}
    assert tok["port"].shape == (30,) and tok["port"].dtype == np.int16
    np.testing.assert_array_equal(tok["port"], tok["jax"])
    rec = {k: np.load(tmp_path / k / "token" / f"{domain}-recon.npy") for k in ("jax", "port")}
    assert rec["port"].shape == (60, 9 if domain == "cam" else 2)
    np.testing.assert_allclose(rec["port"], rec["jax"], atol=RECON_ATOL, rtol=0)

    assert port_report[:-1] == jax_report[:-1] and len(jax_report) == 3
    if domain == "cam":
        want = ast.literal_eval(jax_report[-1])
        assert ast.literal_eval(port_report[-1]) == metrics and metrics.keys() == want.keys()
    else:
        want = {"MSE": float(jax_report[-1].split("MSE:")[1])}
        assert port_report[-1] == f"MSE: {np.float64(metrics['MSE'])}"
    for k, v in want.items():
        assert np.isfinite(v)
        np.testing.assert_allclose(metrics[k], v, rtol=METRIC_RTOL, err_msg=k)


def test_random_init_reads_no_checkpoint(example_files, tmp_path, monkeypatch):
    """--random-init tokenizes on the CLI's seed-0 random weights, even with
    a checkpoint in the CLI's default --output_dir (auto-resume is for
    training only)."""
    d = example_files
    monkeypatch.chdir(tmp_path)
    os.makedirs("output/vqvae")
    save_seq_vqvae_pth(seq_vqvae_from_config("cam", torch.Generator().manual_seed(99),
                                             **SMALL_SEQ), "output/vqvae/checkpoint-final.pth")
    tok_cam_example.main(["--random-init", "--cam", str(d / "cam.npy"), "--device", "cpu"],
                         cli_args=SMALL_ARGS)
    got = np.load("example_data/token/cam-tok.npz")["arr_0"]
    args = port_vqvae_cli.get_args(["--domain", "cam", "--device", "cpu", *SMALL_ARGS])
    x, _ = port_vqvae_cli.prepare_samples(args, str(d / "cam.npy"))
    seeded = port_vqvae_cli.build_tokenizer(args, torch.device("cpu"),
                                            torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got, seeded.tokenize(x).numpy()[0])
    kept = port_vqvae_cli.load_tokenizer_state(args, "output/vqvae/checkpoint-final.pth", "cpu")
    assert not np.array_equal(got, kept.tokenize(x).numpy()[0])


@pytest.mark.parametrize("case", ["no_card", "no_input", "no_checkpoint"])
def test_examples_refuse(case, example_files, tmp_path, monkeypatch):
    d = example_files
    flags = ["--ckpt", str(d / "checkpoint-gaze.pth"), "--gaze", str(d / "gaze.npy"),
             "--out", str(tmp_path)]
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tok_gaze_example.main(flags)
    elif case == "no_input":
        with pytest.raises(FileNotFoundError, match="--gaze"):
            tok_gaze_example.main(flags + ["--gaze", str(tmp_path / "none.npy"),
                                           "--device", "cpu"])
    else:
        with pytest.raises(FileNotFoundError, match="--ckpt"):
            tok_gaze_example.main(flags + ["--ckpt", str(tmp_path / "none.pth"),
                                           "--device", "cpu"])
    assert not os.path.exists(tmp_path / "token")


# -------------------------------------------------------------- launch scripts
def _run_with_shims(script, args, tmp_path, env=()):
    """Run `script` with bash, `python`, `torchrun` and `gcloud` shims on
    PATH; returns the argv the shim was called with."""
    bin_dir, out = tmp_path / "bin", tmp_path / "argv.json"
    bin_dir.mkdir(exist_ok=True)
    for name in ("python", "torchrun", "gcloud"):
        shim = bin_dir / name
        shim.write_text(f"#!{sys.executable}\nimport json, os, sys\n"
                        f"json.dump(sys.argv, open(os.environ['SHIM_ARGV'], 'w'))\n")
        shim.chmod(0o755)
    full = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", "SHIM_ARGV": str(out),
            **dict(env)}
    for k in ("CKPT", "OUTPUT_DIR", "NNODES", "NODE_RANK", "SLURM_NODEID", "MASTER_ADDR"):
        if k not in dict(env):
            full.pop(k, None)
    subprocess.run(["bash", str(REPO / script), *args], cwd=REPO, env=full, check=True,
                   timeout=30)
    argv = json.loads(out.read_text())
    out.unlink()
    return argv


def _after(argv, marker):
    return argv[argv.index(marker) + 1:]


SCRIPTS = {
    "tokenize_cam": ("tokenize_script/cam.sh", ["clips/cam_0.npy", "tok/cam"],
                     {"CKPT": "ckpt/cam.pth"}),
    "tokenize_gaze": ("tokenize_script/gaze.sh", ["clips/gaze_0.npy"], {}),
    "cam_tok_train": ("train_scripts/cam_tok_train.sh", ["cam.npy", "--epochs", "3"], {}),
    "gaze_train": ("train_scripts/gaze_train.sh", ["gaze.npy"], {}),
    "launch_torchrun": ("train_scripts/launch_tpu_pod.sh", ["cfgs/egom2p/main_mod4.yaml"],
                        {"OUTPUT_DIR": "/shared/run"}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripts_parse_to_the_root_scripts_values(name, tmp_path, monkeypatch):
    root_script, args, env = SCRIPTS[name]
    port_argv = _run_with_shims(f"egom2p_torch/scripts/{name}.sh", args, tmp_path, env)
    monkeypatch.chdir(REPO)
    if name == "launch_torchrun":
        root_argv = _run_with_shims(root_script, args, tmp_path,
                                    {**env, "TPU_NAME": "pod", "ZONE": "zone"})
        command = shlex.split(_after(root_argv, "--command")[0])
        root_args = root_tool("run_training_egom2p.py", "root_run_training_egom2p").get_args(
            _after(command, "run_training_egom2p.py"))
        assert os.path.basename(port_argv[0]) == "torchrun"
        port_args = port_train_cli.get_args(_after(port_argv, "egom2p_torch.cli.run_training"))
        launch = port_argv[1:port_argv.index("-m")]
        assert dict(zip(launch[::2], launch[1::2])) == {
            "--nnodes": "1", "--node_rank": "0", "--nproc_per_node": "8",
            "--rdzv_backend": "c10d", "--rdzv_endpoint": "localhost:29500",
            "--rdzv_id": "egom2p"}
    else:
        root_argv = _run_with_shims(root_script, args, tmp_path, env)
        root_args = root_tool("run_training_vqvae.py", "root_run_training_vqvae").get_args(
            _after(root_argv, "run_training_vqvae.py"))
        assert port_argv[1:3] == ["-m", "egom2p_torch.cli.run_training_vqvae"]
        port_args = port_vqvae_cli.get_args(port_argv[3:])
    root_vars, port_vars = vars(root_args), vars(port_args)
    shared = root_vars.keys() & port_vars.keys()
    assert len(shared) > 40
    assert {k: port_vars[k] for k in shared} == {k: root_vars[k] for k in shared}
    if name.startswith("tokenize"):
        assert port_args.tokenize and port_args.resume == env.get(
            "CKPT", f"ckpt/checkpoint-{name.split('_')[1]}.pth")
    if name == "launch_torchrun":
        assert port_args.output_dir == "/shared/run"
