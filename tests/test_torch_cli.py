"""The port's command-line entry points against the JAX package's, on seeded
PNG and ENVI files, the port with ``--device cpu --dtype float64``: the
printed PSNR / SSIM and the ENVI results agree to 1e-6. Small on purpose
(HR 32x32 to 48x48, 2x, 4 frames, ``linear_cg``, at most 2 x 10), and each
JAX configuration runs once."""

import argparse
import contextlib
import io
import os

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.cli import generate_data as j_generate_data
from super_resolution_tpu.cli import shift_add_fusion as j_shift_add_fusion
from super_resolution_tpu.cli import super_resolve as j_super_resolve
from super_resolution_tpu.cli import visualize_image as j_visualize_image
from super_resolution_tpu.utils import visualization as j_visualization
from super_resolution_tpu.spectral.envi import HyperspectralDataLoader as JLoader
from super_resolution_tpu.utils.data_loader import load_image as j_load_image

from super_resolution_tpu_torch.cli import generate_data, shift_add_fusion, super_resolve, visualize_image
from super_resolution_tpu_torch.image import ImageData
from super_resolution_tpu_torch.spectral.envi import HyperspectralDataLoader
from super_resolution_tpu_torch.utils import visualization
from super_resolution_tpu_torch.utils.data_loader import load_image
from super_resolution_tpu_torch.utils.image_io import write_image

PORT = ["--device", "cpu", "--dtype", "float64"]
TOL = 1e-6
SHIFTS = "0 0\n1 1\n0 1\n1 0\n"
DROPPED = {"pallas", "pallas_tile", "pallas_shift_bound", "pallas_channel_block"}
SMALL = ["--upsampling_scale", "2", "--solver", "linear_cg", "--optimization_iterations", "2",
         "--solver_iterations", "10", "--evaluators", "psnr,ssim"]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch, tmp_path_factory):
    torch.set_num_threads(1)
    # The JAX CLI keeps a compile cache; keep it with the test's files.
    monkeypatch.setenv("SRTPU_COMPILE_CACHE", str(tmp_path_factory.getbasetemp() / "jax_cache"))
    monkeypatch.delenv("DISPLAY", raising=False)


def _scene(h, w, c, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    planes = [0.5 + 0.3 * np.sin(xx / (3.0 + k)) * np.cos(yy / 4.0) + 0.1 * rng.random((h, w)) for k in range(c)]
    return np.clip(np.stack(planes, -1).squeeze(-1) if c == 1 else np.stack(planes, -1), 0, 1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_image(str(d / "grey.png"), (_scene(32, 32, 1, 1) * 255).astype(np.uint8))
    write_image(str(d / "grey48.png"), (_scene(48, 48, 1, 2) * 255).astype(np.uint8))
    write_image(str(d / "rgb.png"), (_scene(32, 32, 3, 3) * 255).astype(np.uint8))
    (d / "shifts.txt").write_text(SHIFTS)
    cube = np.moveaxis(_scene(32, 32, 8, 4), -1, 0)
    HyperspectralDataLoader(str(d / "cube.bsq")).save_image(cube)
    return d


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return out.getvalue()


def _scores(text):
    return {line.split(":")[0].strip(): float(line.split(":")[1]) for line in text.splitlines() if "score on" in line}


def _both(argv, files, tmp_path, result=None):
    """Run the JAX and the port CLI on ``argv`` (``result``: an ENVI result
    name for each); their printed scores agree to 1e-6 and their results too."""
    j_argv, p_argv = list(argv), list(argv) + PORT
    if result:
        j_argv += ["--result_path", str(tmp_path / f"jax_{result}")]
        p_argv += ["--result_path", str(tmp_path / f"port_{result}")]
    j_out = _run(j_super_resolve.main, j_argv)
    p_out = _run(super_resolve.main, p_argv)
    j_scores, p_scores = _scores(j_out), _scores(p_out)
    assert set(j_scores) == set(p_scores)
    for key in j_scores:
        assert abs(j_scores[key] - p_scores[key]) <= TOL, (key, j_scores[key], p_scores[key])
    if result:
        loader = HyperspectralDataLoader(str(tmp_path / f"port_{result}.config"), device="cpu", dtype=torch.float64)
        loader.load_image_from_envi_file()
        j_loader = JLoader(str(tmp_path / f"jax_{result}.config"))
        j_loader.load_image_from_envi_file()
        ours, theirs = loader.get_image().hidden_array.numpy(), np.asarray(j_loader.get_image().hidden_array)
        assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= TOL
    return j_out, p_out


def _actions(parser):
    return {a.dest: (a.default, a.type, tuple(a.choices or ()), a.required, a.nargs, a.option_strings)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("cli", ["super_resolve", "generate_data", "shift_add_fusion", "visualize_image"])
def test_flag_surface(cli):
    ours = _actions(globals()[cli].build_parser())
    theirs = _actions({"super_resolve": j_super_resolve, "generate_data": j_generate_data,
                       "shift_add_fusion": j_shift_add_fusion, "visualize_image": j_visualize_image}[cli].build_parser())
    dropped = DROPPED if cli == "super_resolve" else set()
    assert dropped <= set(theirs)
    assert {k: v for k, v in theirs.items() if k not in dropped} == {k: v for k, v in ours.items()
                                                                     if k not in ("device", "dtype")}
    assert ours["device"][0] == "cuda" and ours["dtype"][0] == "float32"
    assert ours["dtype"][2] == ("float32", "float64")


def test_generate_mode(files, tmp_path):
    _both(["--data_path", str(files / "grey.png"), "--generate_lr_images", "--motion_sequence_path",
           str(files / "shifts.txt"), *SMALL], files, tmp_path, result="generate")


def test_directory_mode_with_estimated_and_refined_motion(files, tmp_path):
    frames = tmp_path / "lr"
    _run(j_generate_data.main, ["--input_image", str(files / "grey48.png"), "--output_image_dir", str(frames),
                                "--blur_radius", "0", "--motion_sequence_path", str(files / "shifts.txt")])
    j_out, p_out = _both(["--data_path", str(frames), "--ground_truth_image", str(files / "grey48.png"),
                          "--blur_radius", "0", "--estimate_motion", "--refine_motion", "1", "--verbose", *SMALL],
                         files, tmp_path, result="estimated")
    assert "Refined motion against the HR estimate" in p_out and "Estimated motion (HR px)" in p_out


def test_interpolate_color(files, tmp_path):
    _both(["--data_path", str(files / "rgb.png"), "--generate_lr_images", "--motion_sequence_path",
           str(files / "shifts.txt"), "--interpolate_color", *SMALL], files, tmp_path, result="colour")


@pytest.mark.parametrize("regularizer", ["tv", "3dtv"])
def test_wavelet_domain(files, tmp_path, regularizer):
    _both(["--data_path", str(files / "rgb.png"), "--generate_lr_images", "--motion_sequence_path",
           str(files / "shifts.txt"), "--solve_in_wavelet_domain", "--regularizer", regularizer, *SMALL],
          files, tmp_path, result="wavelet")


def test_pca_space_from_an_envi_cube(files, tmp_path):
    _both(["--data_path", str(files / "cube.bsq.config"), "--generate_lr_images", "--motion_sequence_path",
           str(files / "shifts.txt"), "--solve_in_pca_space", "--num_pca_components", "3", *SMALL],
          files, tmp_path, result="pca")


def test_admm(files, tmp_path):
    _both(["--data_path", str(files / "grey.png"), "--generate_lr_images", "--motion_sequence_path",
           str(files / "shifts.txt"), *SMALL, "--solver", "admm", "--admm_cg_iterations", "4",
           "--solver_iterations", "5"], files, tmp_path, result="admm")


def test_checkpoint_and_resume(files, tmp_path):
    common = ["--data_path", str(files / "grey.png"), "--generate_lr_images", "--motion_sequence_path",
              str(files / "shifts.txt"), *SMALL, "--verbose"]
    sides = {"jax": (j_super_resolve.main, []), "port": (super_resolve.main, PORT)}
    for side, (main, extra) in sides.items():
        _run(main, common + ["--optimization_iterations", "1", "--checkpoint", str(tmp_path / side)] + extra)
    with np.load(str(tmp_path / "jax.npz")) as j_state, np.load(str(tmp_path / "port.npz")) as p_state:
        assert set(j_state.files) == set(p_state.files)
        assert np.abs(j_state["x"] - p_state["x"]).max() <= TOL
        assert int(j_state["iteration"]) == int(p_state["iteration"]) == 1
    # Each side resumes from its own state for the second round.
    outputs = {side: _run(main, common + ["--checkpoint", str(tmp_path / side), "--resume"] + extra)
               for side, (main, extra) in sides.items()}
    assert "Resumed IRLS" in outputs["port"] and "Resumed IRLS" in outputs["jax"]
    j_scores, p_scores = _scores(outputs["jax"]), _scores(outputs["port"])
    assert set(j_scores) == set(p_scores) and all(abs(j_scores[k] - p_scores[k]) <= TOL for k in j_scores)


@pytest.mark.parametrize("repeats,note", [(1, "includes the one-time kernel build and graph capture"),
                                          (2, "the last repeat, warm")])
def test_throughput_line_says_what_the_timed_solve_held(files, repeats, note):
    out = _run(super_resolve.main, ["--data_path", str(files / "grey.png"), "--generate_lr_images",
                                    "--motion_sequence_path", str(files / "shifts.txt"), *SMALL, "--verbose",
                                    "--benchmark_repeats", str(repeats)] + PORT)
    line = next(line for line in out.splitlines() if line.startswith("Solve throughput"))
    assert line.endswith(f"; {note}).")


@pytest.mark.parametrize("mesh,data", [("band", "cube.bsq.config"), ("rowcol", "grey48.png")])
def test_mesh_on_cpu_devices(files, tmp_path, mesh, data):
    j_out, p_out = _both(["--data_path", str(files / data), "--generate_lr_images", "--motion_sequence_path",
                          str(files / "shifts.txt"), *SMALL, "--num_devices", "4", "--mesh", mesh, "--verbose"],
                         files, tmp_path, result=mesh)
    assert "Sharding over 4 devices" in p_out


def test_generate_data_then_shift_add_fusion(files, tmp_path):
    for side, gen, fuse, extra in (("jax", j_generate_data, j_shift_add_fusion, []),
                                   ("port", generate_data, shift_add_fusion, PORT)):
        frames = tmp_path / f"{side}_lr"
        _run(gen.main, ["--input_image", str(files / "rgb.png"), "--output_image_dir", str(frames), "--blur_radius",
                        "0", "--motion_sequence_path", str(files / "shifts.txt")] + extra)
        assert sorted(os.listdir(frames)) == [f"low_res_{i}.png" for i in range(4)]
        _run(fuse.main, ["--input_image_dir", str(frames), "--input_motion_sequence", str(files / "shifts.txt"),
                         "--result_path", str(tmp_path / f"{side}_fused.png")] + extra)
    for i in range(4):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port_lr" / f"low_res_{i}.png"), cv2.IMREAD_UNCHANGED),
                                      cv2.imread(str(tmp_path / "jax_lr" / f"low_res_{i}.png"), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port_fused.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "jax_fused.png"), cv2.IMREAD_UNCHANGED))
    _run(generate_data.main, ["--input_image", str(files / "cube.bsq.config"), "--save_as",
                              str(tmp_path / "copy.bsq")] + PORT)
    assert os.path.exists(tmp_path / "copy.bsq.hdr")


def test_super_resolve_writes_jpeg2000_as_opencv(files, tmp_path):
    """``--result_path out.jp2``: the port writes the bytes ``cv2.imencode(".jp2", ...)`` gives for its own
    result (the same run's PNG holds its pixels); the JAX CLI's ``.jp2`` result reads to the same array through
    both loaders."""
    argv = ["--data_path", str(files / "grey.png"), "--generate_lr_images", "--motion_sequence_path",
            str(files / "shifts.txt"), *SMALL]
    for name in ("port.jp2", "port.png"):
        _run(super_resolve.main, argv + ["--result_path", str(tmp_path / name)] + PORT)
    _run(j_super_resolve.main, argv + ["--result_path", str(tmp_path / "jax.jp2")])
    pixels = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    assert pixels.shape == (32, 32)
    assert (tmp_path / "port.jp2").read_bytes() == cv2.imencode(".jp2", pixels)[1].tobytes()
    theirs = np.asarray(j_load_image(str(tmp_path / "jax.jp2")).hidden_array)
    np.testing.assert_array_equal(load_image(str(tmp_path / "jax.jp2"), device="cpu",
                                             dtype=torch.float64).hidden_array.numpy(), theirs)


def test_generate_data_writes_jpeg2000_frames_as_the_jax_cli(files, tmp_path):
    """``generate_data --output_extension jp2``: where the uint8 frames agree (their PNGs are equal), the
    port's ``.jp2`` frames are the JAX CLI's files byte for byte."""
    hr = tmp_path / "hr.png"
    write_image(str(hr), (_scene(64, 72, 1, 5) * 255).astype(np.uint8))
    for side, gen, extra in (("jax", j_generate_data, []), ("port", generate_data, PORT)):
        for ext in ("png", "jp2"):
            _run(gen.main, ["--input_image", str(hr), "--output_image_dir", str(tmp_path / f"{side}_{ext}"),
                            "--blur_radius", "0", "--motion_sequence_path", str(files / "shifts.txt"),
                            "--output_extension", ext] + extra)
    for i in range(4):
        name = f"low_res_{i}"
        ours = cv2.imread(str(tmp_path / "port_png" / f"{name}.png"), cv2.IMREAD_UNCHANGED)
        assert ours.shape == (32, 36)
        np.testing.assert_array_equal(ours, cv2.imread(str(tmp_path / "jax_png" / f"{name}.png"),
                                                       cv2.IMREAD_UNCHANGED))
        assert ((tmp_path / "port_jp2" / f"{name}.jp2").read_bytes()
                == (tmp_path / "jax_jp2" / f"{name}.jp2").read_bytes())


def test_visualize_image_headless(files, tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    j_out = _run(j_visualize_image.main, ["--image_path", str(files / "rgb.png"), "--print_report"])
    os.replace(tmp_path / "image_visualization.png", tmp_path / "jax.png")
    p_out = _run(visualize_image.main, ["--image_path", str(files / "rgb.png"), "--print_report"] + PORT)
    assert p_out.replace("\n", " ").split("[headless]")[0] == j_out.replace("\n", " ").split("[headless]")[0]
    assert str(tmp_path / "image_visualization.png") in p_out
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "image_visualization.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED))
    # The display's side-by-side stitch (grey padded and replicated), and a large image shrunk to fit.
    images = [np.zeros((4, 6), np.uint8) + 9, np.full((7, 5, 3), 200, np.uint8)]
    path = visualization.display_images_side_by_side(images, "Side By Side")
    j_path = j_visualization.display_images_side_by_side(images, "Side By Side J")
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), cv2.imread(j_path, cv2.IMREAD_UNCHANGED))
    big = ImageData(np.random.default_rng(5).random((1300, 900)), normalize="never", device="cpu")
    shrunk = cv2.imread(visualization.display_image(big, "Big"), cv2.IMREAD_UNCHANGED)
    j_shrunk = cv2.imread(j_visualization.display_image(big.hidden_array.numpy()[0], "Big J"), cv2.IMREAD_UNCHANGED)
    assert shrunk.shape == j_shrunk.shape == (850, 588)
    assert np.abs(shrunk.astype(int) - j_shrunk.astype(int)).max() <= 1  # float bilinear vs OpenCV's fixed point


@pytest.mark.parametrize("events", [
    [(1, 10, 10, 1), (0, 40, 30, 1)],                      # drag: the selection rectangle
    [(1, 60, 40, 1), (4, 10, 20, 1)],                      # release: zoom to the selection
    [(1, 0, 0, 1), (4, 50, 50, 1), (2, 3, 3, 0)],          # right click: zoom out
    [(1, 5, 5, 1), (0, 30, 30, 0)],                        # the button let go outside: cancel
])
def test_zoom_interaction_as_the_jax_one(events):
    image = (np.random.default_rng(6).random((100, 200, 3)) * 255).astype(np.uint8)
    shown, j_shown = [], []
    ours, theirs = visualization.ZoomInteraction(image, shown.append), j_visualization.ZoomInteraction(image,
                                                                                                       j_shown.append)
    for event in events:
        ours.on_mouse(*event)
        theirs.on_mouse(*event)
        assert (ours.dragging, ours.zoomed, ours.drag_start) == (theirs.dragging, theirs.zoomed, theirs.drag_start)
    assert len(shown) == len(j_shown)
    for a, b in zip(shown, j_shown):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1  # exact but for the zoom's resize
    assert (visualization.EVENT_LBUTTONDOWN, visualization.EVENT_RBUTTONDOWN, visualization.EVENT_LBUTTONUP,
            visualization.EVENT_MOUSEMOVE, visualization.EVENT_FLAG_LBUTTON) == (
        cv2.EVENT_LBUTTONDOWN, cv2.EVENT_RBUTTONDOWN, cv2.EVENT_LBUTTONUP, cv2.EVENT_MOUSEMOVE, cv2.EVENT_FLAG_LBUTTON)
