"""SuperResolution CLI — full pipeline (equivalent of
``src/super_resolution.cpp``; flag surface mirrors :38-115).

Usage:
  python -m super_resolution_tpu_torch.cli.super_resolve --data_path ... [options]

The flags are the JAX package's CLI's, less the four that route its TPU
kernel (``--pallas``, ``--pallas_tile``, ``--pallas_shift_bound``,
``--pallas_channel_block``), plus ``--device`` (default ``cuda``: the MAP
solve then runs on the hand-written CUDA kernels; a machine without a card
raises) and ``--dtype`` (``float32`` / ``float64``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

DTYPES = ("float32", "float64")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="super_resolve", description="Multiframe super-resolution (PyTorch / CUDA)."
    )
    # Input images (required):
    p.add_argument("--data_path", required=True,
                   help="Path to an input file or directory to super resolve.")
    p.add_argument("--generate_lr_images", action="store_true",
                   help="Super-resolve images generated from high-res file at data_path.")
    p.add_argument("--noise_sigma", type=float, default=0.0,
                   help="Additive noise std. deviation (only with --generate_lr_images).")
    p.add_argument("--number_of_frames", type=int, default=4,
                   help="The number of frames to generate (only with --generate_lr_images).")
    p.add_argument("--ground_truth_image", default="",
                   help="Ground truth for evaluation (only if --generate_lr_images is NOT set).")
    # Image model parameters:
    p.add_argument("--upsampling_scale", type=int, default=2,
                   help="The amount by which to super-resolve the image(s).")
    p.add_argument("--blur_radius", type=int, default=3,
                   help="The size of the blur kernel. Set to 0 to inactivate blurring.")
    p.add_argument("--blur_sigma", type=float, default=1.0,
                   help="The sigma value of the Gaussian blur. Set to 0 to inactivate blurring.")
    p.add_argument("--motion_sequence_path", default="",
                   help="Path to a file containing the motion shifts for each image.")
    p.add_argument("--estimate_motion", action="store_true",
                   help="Estimate motion with phase-correlation registration "
                        "(used when no motion_sequence_path is given).")
    p.add_argument("--robust_registration", action="store_true",
                   help="Use per-block consensus (RANSAC-analog) phase "
                        "correlation for --estimate_motion — for stacks with "
                        "corrupted regions or locally violated translation.")
    # Solver strategy parameters:
    p.add_argument("--optimization_iterations", type=int, default=20,
                   help="Max number of IRLS iterations.")
    p.add_argument("--solve_in_wavelet_domain", action="store_true",
                   help="Run super-resolution in the wavelet domain (experimental).")
    p.add_argument("--interpolate_color", action="store_true",
                   help="Run SR only on the luminance channel and interpolate colors later.")
    p.add_argument("--solve_in_pca_space", action="store_true",
                   help="Run SR on PCA space of the spectra domain (HS images only).")
    p.add_argument("--num_pca_components", type=int, default=0,
                   help="Number of PCA components to use (0 = all).")
    p.add_argument("--pca_retained_variance", type=float, default=0.0,
                   help="Retained variance for PCA (0.0 = use num_pca_components).")
    p.add_argument("--split_channels", action="store_true",
                   help="Each channel will be solved as an independent image.")
    # Regularization options:
    p.add_argument("--regularizer", default="tv", choices=["tv", "3dtv", "btv"],
                   help="The regularizer to use.")
    p.add_argument("--btv_scale_range", type=int, default=3,
                   help="The range (window size) for BTV regularization.")
    p.add_argument("--btv_spatial_decay", type=float, default=0.5,
                   help="The spatial decay factor for BTV regularization.")
    p.add_argument("--regularization_parameter", type=float, default=0.01,
                   help="The regularization parameter (lambda). 0 disables regularization.")
    # Solver parameters:
    p.add_argument("--solver", default="cg",
                   choices=["cg", "linear_cg", "lbfgs", "admm"],
                   help="The least squares solver to use. 'linear_cg' is the "
                        "exact-step CG for the quadratic IRLS inner "
                        "subproblem: one objective evaluation per iteration "
                        "instead of the Wolfe search's ~1.56. 'admm' replaces "
                        "the IRLS loop entirely with the exact L1-TV "
                        "splitting solver (2D TV only).")
    p.add_argument("--admm_rho", type=float, default=1.0,
                   help="ADMM penalty parameter (only with --solver admm).")
    p.add_argument("--admm_cg_iterations", type=int, default=10,
                   help="Linear-CG steps per ADMM x-update (only with --solver admm).")
    p.add_argument("--solver_iterations", type=int, default=50,
                   help="The maximum number of solver iterations.")
    p.add_argument("--gradient_norm_threshold", type=float, default=1e-6,
                   help="Inner-solver stop threshold (adaptively scaled up by "
                        "n_params x sum(lambda), map_solver.cpp:16-26). 0 "
                        "disables; pair all three 0s with --solver_iterations "
                        "for fixed-iteration benchmarking.")
    p.add_argument("--cost_decrease_threshold", type=float, default=1e-6,
                   help="Inner-solver stop threshold (see above).")
    p.add_argument("--parameter_variation_threshold", type=float, default=1e-6,
                   help="Inner-solver stop threshold (see above).")
    p.add_argument("--diff_mode", default="analytic",
                   choices=["analytic", "autodiff", "numerical"],
                   help="Gradient mode: reference-parity analytic chain (the "
                        "CUDA kernels on a card), torch.autograd, or "
                        "central-difference numerical differentiation (the "
                        "reference's --use_numerical_differentiation; O(2n) "
                        "cost evaluations per gradient — tiny problems only).")
    p.add_argument("--fused_irls", action="store_true",
                   help="Run the entire IRLS loop on the device (CUDA graphs of "
                        "the inner solver's steps and the IRLS seam on a card; "
                        "no per-iteration logging or checkpoints).")
    p.add_argument("--refine_motion", type=int, default=0, metavar="N",
                   help="Every N IRLS iterations, refine the motion shifts "
                        "against the current HR estimate (Gauss-Newton on "
                        "the data term; recovers estimated-registration "
                        "error). 0 = off. Pairs with --estimate_motion; the "
                        "kernels take the refined shifts as device data.")
    # Distribution:
    p.add_argument("--num_devices", type=int, default=0,
                   help="Shard the solve over this many devices (0 = single "
                        "device); the axis is picked by --mesh.")
    p.add_argument("--mesh", default="frame",
                   choices=["frame", "band", "rowcol", "row", "col"],
                   help="Mesh axis for --num_devices: 'frame' shards LR "
                        "frames (data parallel), 'band' shards spectral "
                        "channels, 'rowcol' tiles the HR image over a "
                        "near-square row x col grid with halo exchange "
                        "('row'/'col' force one spatial axis).")
    # Checkpoint/resume (host-IRLS-loop solves):
    p.add_argument("--checkpoint", default="", metavar="PATH",
                   help="Save IRLS state (x, weights, iteration, refined "
                        "shifts) at every iteration seam to PATH.npz; "
                        "combine with --resume to continue an interrupted "
                        "solve. Host-loop IRLS only (not --fused_irls).")
    p.add_argument("--resume", action="store_true",
                   help="Resume from --checkpoint if it exists.")
    # Evaluation and output:
    p.add_argument("--verbose", action="store_true",
                   help="Solver will log progress and image stats will be printed.")
    p.add_argument("--benchmark_repeats", type=int, default=1,
                   help="Run the solve N times (the built kernels and captured "
                        "graphs are cached, so repeats > 1 measure the warmed "
                        "path; the LAST repeat's stats are reported). "
                        "Benchmarking aid, default 1.")
    p.add_argument("--evaluators", default="",
                   help="Comma-delimited evaluation metrics (e.g. 'psnr,ssim').")
    p.add_argument("--display_mode", default="", choices=["", "result", "compare"],
                   help="'result' to display; 'compare' to also show bilinear upsampling.")
    p.add_argument("--result_path", default="",
                   help="File path where the result image will be saved.")
    # Placement:
    p.add_argument("--device", default="cuda",
                   help="Where the images and the solve live: 'cuda' (default; "
                        "raises without a card) or 'cpu' (the kernels' plain "
                        "PyTorch versions).")
    p.add_argument("--dtype", default="float32", choices=DTYPES,
                   help="Floating type of the images and the solve.")
    return p


def torch_dtype(name: str):
    import torch

    return {"float32": torch.float32, "float64": torch.float64}[name]


def _mesh_axes(n: int, kind: str) -> dict[str, int]:
    from super_resolution_tpu_torch.parallel import BAND_AXIS, COL_AXIS, FRAME_AXIS, ROW_AXIS

    if kind == "frame":
        return {FRAME_AXIS: n}
    if kind == "band":
        return {BAND_AXIS: n}
    if kind == "row":
        return {ROW_AXIS: n}
    if kind == "col":
        return {COL_AXIS: n}
    r = int(np.sqrt(n))  # rowcol: near-square factorization (rows x cols = n)
    while n % r:
        r -= 1
    return {ROW_AXIS: n // r, COL_AXIS: r}


def _mesh(args, device):
    """The mesh of ``--num_devices`` / ``--mesh``: its shards dealt in turn
    over the visible cards (over the CPU with ``--device cpu``)."""
    import torch

    from super_resolution_tpu_torch.parallel import make_mesh

    n = args.num_devices
    axes = _mesh_axes(n, args.mesh)
    if device.type == "cpu":
        devices = [device]
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())][:n]
    mesh = make_mesh(axes, devices)
    if args.verbose:
        print(f"Sharding over {n} devices: mesh {axes}.")
    return mesh


def _setup_and_run_solver(args, image_model, input_images, initial_estimate):
    """Mirror of ``SetupAndRunSolver`` (``super_resolution.cpp:126-199``)."""
    import torch

    from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
    from super_resolution_tpu_torch.solvers import IRLSMapSolver, IRLSMapSolverOptions

    device, dtype = torch.device(args.device), torch_dtype(args.dtype)
    if args.solver == "admm":
        from super_resolution_tpu_torch.solvers import AdmmSolver, AdmmSolverOptions

        if args.num_devices and args.num_devices > 1:
            raise SystemExit("--solver admm is single-device; drop --num_devices.")
        if args.regularization_parameter > 0.0 and args.regularizer != "tv":
            raise SystemExit(
                "--solver admm implements the exact L1 splitting for 2D TV "
                "only (--regularizer tv); use the IRLS solvers for BTV/3D TV."
            )
        admm_options = AdmmSolverOptions(
            max_num_solver_iterations=args.solver_iterations,
            rho=args.admm_rho,
            admm_cg_iterations=args.admm_cg_iterations,
        )
        solver = AdmmSolver(admm_options, image_model, input_images,
                            print_solver_output=args.verbose, device=device, dtype=dtype)
        if args.regularization_parameter > 0.0:
            solver.add_regularizer(TotalVariationRegularizer(), args.regularization_parameter)
        start = time.perf_counter()
        result = solver.solve(initial_estimate)
        elapsed = time.perf_counter() - start
        if args.verbose:
            print(f"Done! Finished in {elapsed:.3f} seconds.")
        return result

    options = IRLSMapSolverOptions(
        least_squares_solver=args.solver,
        max_num_solver_iterations=args.solver_iterations,
        max_num_irls_iterations=args.optimization_iterations,
        gradient_norm_threshold=args.gradient_norm_threshold,
        cost_decrease_threshold=args.cost_decrease_threshold,
        parameter_variation_threshold=args.parameter_variation_threshold,
        diff_mode=args.diff_mode,
        split_channels=args.split_channels,
        fused_irls=args.fused_irls,
        refine_motion_every=max(0, args.refine_motion),
    )
    mesh = _mesh(args, device) if args.num_devices and args.num_devices > 1 else None
    solver = IRLSMapSolver(options, image_model, input_images, print_solver_output=args.verbose,
                           device=device, dtype=dtype, mesh=mesh)
    if args.regularization_parameter > 0.0:
        if args.regularizer in ("tv", "3dtv"):
            reg = TotalVariationRegularizer(use_3d_total_variation=args.regularizer == "3dtv")
        else:
            reg = BilateralTotalVariationRegularizer(args.btv_scale_range, args.btv_spatial_decay)
        solver.add_regularizer(reg, args.regularization_parameter)
        if args.verbose:
            print(f"Added {args.regularizer} regularizer with parameter "
                  f"{args.regularization_parameter}")

    if args.verbose:
        print(f"Super-resolving from {len(input_images)} images...")
    ckpt = args.checkpoint or None
    start = time.perf_counter()
    result = solver.solve(initial_estimate, checkpoint_path=ckpt, resume=args.resume)
    elapsed = time.perf_counter() - start
    # The first solve's first inner call carries the one-time costs: the
    # kernels' build (or load) and, under --fused_irls, the CUDA graphs'
    # capture. Every later inner call, and every call of the repeats below,
    # runs warm.
    cold_calls = list(solver.last_inner_calls)
    warm_calls = cold_calls[1:]
    for _ in range(max(0, args.benchmark_repeats - 1)):
        start = time.perf_counter()
        result = solver.solve(initial_estimate, checkpoint_path=ckpt, resume=args.resume)
        elapsed = time.perf_counter() - start
        warm_calls += list(solver.last_inner_calls)
    if args.verbose:
        print(f"Done! Finished in {elapsed:.3f} seconds.")
        iters = solver.last_inner_iterations
        numel = result.array.numel()
        if iters and elapsed > 0:
            mpix_iters = iters * numel / elapsed / 1e6
            # Stats of the last solve: the first one when no repeat ran.
            note = ("includes the one-time kernel build and graph capture" if args.benchmark_repeats <= 1
                    else "the last repeat, warm")
            print(
                f"Solve throughput: {mpix_iters:.4g} Mpixel-iters/s "
                f"({iters} inner iterations over {numel / 1e6:.4g} Mpixels; {note})."
            )
        if warm_calls:
            warm_s = sum(c[0] for c in warm_calls)
            warm_it = sum(c[1] for c in warm_calls)
            warm_ev = sum(c[2] for c in warm_calls)
            # Per-CALL pixel count: with --split_channels each inner call
            # solves one channel round, not the full image.
            call_px = getattr(solver, "last_inner_pixels", numel)
            best = max(
                (c[1] * call_px / c[0] / 1e6 for c in warm_calls if c[0] > 0),
                default=0.0,
            )
            if warm_it and warm_s > 0:
                build_s = cold_calls[0][0] if cold_calls else 0.0
                print(
                    f"Steady-state solve throughput: "
                    f"{warm_it * call_px / warm_s / 1e6:.4g} Mpixel-iters/s "
                    f"(best warm call {best:.4g}; {warm_it} iterations / "
                    f"{warm_ev} objective evaluations over "
                    f"{len(warm_calls)} warm inner calls; the first call, with "
                    f"the build and capture, took {build_s:.2f} s)."
                )
    return result


def _solve_in_wavelet_domain(args, image_model, input_images):
    """Wavelet-domain solving (``super_resolution.cpp:201-267``).

    The reference loops over the four subbands serially; the subband
    objectives are fully channel-separable (same image model, same motion,
    TV/BTV never mix channels), so here LL/LH/HL/HH are STACKED as channels
    of ONE solve, which the kernels' channel grid runs in one launch per
    evaluation. 3D spectral TV couples the channel axis, so that one keeps the
    reference's per-subband loop.
    """
    import torch

    from super_resolution_tpu_torch.image.image_data import ImageData
    from super_resolution_tpu_torch.ops.resize import cubic_resize
    from super_resolution_tpu_torch.wavelet import (
        WaveletCoefficients,
        inverse_wavelet_transform,
        wavelet_transform,
    )

    names = ("ll", "lh", "hl", "hh")
    if args.regularizer == "3dtv":
        subbands = {name: [] for name in names}
        for img in input_images:
            coeffs = wavelet_transform(img.array)
            for name in names:
                subbands[name].append(ImageData(getattr(coeffs, name), normalize="never", channel_major=True))
        results = {}
        for name, stack in subbands.items():
            initial = stack[0].resized(float(args.upsampling_scale), method="linear")
            results[name] = _setup_and_run_solver(args, image_model, stack, initial)
        merged = WaveletCoefficients(*(results[name].array for name in names))
    else:
        stacked_frames = []
        for img in input_images:
            coeffs = wavelet_transform(img.array)
            stacked_frames.append(ImageData(torch.cat([getattr(coeffs, n) for n in names], dim=0),
                                            normalize="never", channel_major=True))
        initial = stacked_frames[0].resized(float(args.upsampling_scale), method="linear")
        solved = _setup_and_run_solver(args, image_model, stacked_frames, initial)
        arr = solved.array
        c = arr.shape[0] // 4
        merged = WaveletCoefficients(*(arr[i * c: (i + 1) * c] for i in range(4)))
    result = inverse_wavelet_transform(merged)
    w, h = input_images[0].size
    target_hw = (h * args.upsampling_scale, w * args.upsampling_scale)
    result = cubic_resize(result, target_hw)
    return ImageData(result, normalize="never", channel_major=True, spectral_mode=input_images[0].spectral_mode)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from super_resolution_tpu_torch._device import resolve_device
    from super_resolution_tpu_torch.evaluation import (
        PeakSignalToNoiseRatioEvaluator,
        StructuralSimilarityEvaluator,
    )
    from super_resolution_tpu_torch.image.image_data import SpectralMode
    from super_resolution_tpu_torch.models import ImageModel, ImageModelParameters
    from super_resolution_tpu_torch.spectral import SpectralPCA
    from super_resolution_tpu_torch.utils.data_loader import load_image, load_images, save_image

    device, dtype = resolve_device(args.device), torch_dtype(args.dtype)
    model_parameters = ImageModelParameters(
        scale=args.upsampling_scale,
        blur_radius=args.blur_radius,
        blur_sigma=args.blur_sigma,
        motion_sequence_path=args.motion_sequence_path,
    )

    # Load or generate the LR stack.
    high_res_image = None
    if args.generate_lr_images:
        if args.verbose:
            print("Generating low-resolution images from ground truth.")
        high_res_image = load_image(args.data_path, device=device, dtype=dtype)
        gen_parameters = ImageModelParameters(
            **{**model_parameters.__dict__, "noise_sigma": args.noise_sigma}
        )
        generation_model = ImageModel.create(gen_parameters)
        low_res_images = [
            high_res_image._with_array(generation_model.apply(high_res_image.array, i).contiguous())
            for i in range(args.number_of_frames)
        ]
    else:
        low_res_images = load_images(args.data_path, device=device, dtype=dtype)
        if args.ground_truth_image:
            high_res_image = load_image(args.ground_truth_image, device=device, dtype=dtype)
    if not low_res_images:
        print("At least one low-resolution image is required.", file=sys.stderr)
        return 1

    # Motion: from file, or estimated via registration. Registration sees the
    # LR frames, so its shifts are in LR pixels; the image model warps the HR
    # estimate, so the motion sequence must be in HR pixels — scale by s
    # (an HR shift of s*d appears as a d-pixel shift after decimation).
    if not args.motion_sequence_path and args.estimate_motion:
        from super_resolution_tpu_torch.motion import MotionShift, MotionShiftSequence
        from super_resolution_tpu_torch.motion.registration import translational_registration

        seq_lr = translational_registration(low_res_images, robust=args.robust_registration, device=device)
        s = args.upsampling_scale
        seq = MotionShiftSequence([MotionShift(sh.dx * s, sh.dy * s) for sh in seq_lr])
        model_parameters.motion_sequence = seq
        if args.verbose:
            print("Estimated motion (HR px):", [(s.dx, s.dy) for s in seq])
    image_model = ImageModel.create(model_parameters)

    has_ground_truth = high_res_image is not None
    evaluator_names = [e.strip() for e in args.evaluators.split(",") if e.strip()]
    evaluate_results = has_ground_truth and bool(evaluator_names)

    upsampled_image = None
    if evaluate_results or args.display_mode == "compare":
        upsampled_image = low_res_images[0].resized(float(args.upsampling_scale), method="linear")

    # Luminance-only color path.
    if args.interpolate_color:
        low_res_images = [
            img.change_color_space(SpectralMode.COLOR_YCRCB, luminance_only=True)
            for img in low_res_images
        ]

    # PCA-space path.
    spectral_pca = None
    if args.solve_in_pca_space and not args.interpolate_color:
        if args.pca_retained_variance > 0.0:
            spectral_pca = SpectralPCA(low_res_images, retained_variance=args.pca_retained_variance)
        else:
            spectral_pca = SpectralPCA(low_res_images, num_pca_bands=args.num_pca_components)
        low_res_images = [spectral_pca.get_pca_image(img) for img in low_res_images]
        if args.verbose:
            print(f"Super-resolving in PCA space with "
                  f"{low_res_images[0].num_channels} PCA components.")

    initial_estimate = low_res_images[0].resized(float(args.upsampling_scale), method="linear")

    if args.solve_in_wavelet_domain:
        result = _solve_in_wavelet_domain(args, image_model, low_res_images)
    else:
        result = _setup_and_run_solver(args, image_model, low_res_images, initial_estimate)

    if args.interpolate_color:
        result = result.interpolate_color_from(initial_estimate)
        result = result.change_color_space(SpectralMode.COLOR_BGR)
    if spectral_pca is not None:
        result = spectral_pca.reconstruct_image(result)

    if evaluate_results:
        for name in evaluator_names:
            if name == "psnr":
                ev = PeakSignalToNoiseRatioEvaluator(high_res_image)
                print(f"PSNR score on upsampled: {ev.evaluate(upsampled_image)}")
                print(f"PSNR score on result:    {ev.evaluate(result)}")
            elif name == "ssim":
                ev = StructuralSimilarityEvaluator(high_res_image)
                print(f"SSIM score on upsampled: {ev.evaluate(upsampled_image)}")
                print(f"SSIM score on result:    {ev.evaluate(result)}")
            else:
                print(f"Unknown/unsupported evaluator '{name}'.", file=sys.stderr)
    if args.verbose:
        result.report().print()

    if args.display_mode:
        from super_resolution_tpu_torch.utils.visualization import (
            display_image,
            display_images_side_by_side,
        )

        if args.display_mode == "result":
            display_image(result, "Result")
        else:
            images = [result, upsampled_image]
            title = "Super-Resolution vs. Linear Interpolation"
            if has_ground_truth:
                images.insert(0, high_res_image)
                title = "Ground Truth vs. " + title
            display_images_side_by_side(images, title)

    if args.result_path:
        save_image(result, args.result_path)
        if args.verbose:
            print(f"Saved result to {args.result_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
