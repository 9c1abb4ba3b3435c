"""ShiftAddFusion CLI — baseline fusion algorithm (equivalent of
``src/shift_add_fusion.cpp``). The JAX package's flags, plus ``--device``
(default ``cuda``) and ``--dtype``."""

from __future__ import annotations

import argparse
import sys

import torch

from super_resolution_tpu_torch.cli.super_resolve import DTYPES, torch_dtype


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="shift_add_fusion",
                                description="Shift-add fusion baseline.")
    p.add_argument("--input_image_dir", required=True,
                   help="Directory containing the LR images (sorted by name).")
    p.add_argument("--input_motion_sequence", required=True,
                   help="Text file with the motion sequence.")
    p.add_argument("--upsampling_scale", type=int, default=2)
    p.add_argument("--no_inpaint", action="store_true",
                   help="Skip hole inpainting (show raw fusion).")
    p.add_argument("--result_path", default="", help="Where to save the fused image.")
    p.add_argument("--display", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    p.add_argument("--dtype", default="float32", choices=DTYPES)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from super_resolution_tpu_torch.image.image_data import ImageData
    from super_resolution_tpu_torch.motion import MotionShiftSequence
    from super_resolution_tpu_torch.solvers.shift_add import shift_add_fusion
    from super_resolution_tpu_torch.utils.data_loader import load_images, save_image

    images = load_images(args.input_image_dir, device=args.device, dtype=torch_dtype(args.dtype))
    seq = MotionShiftSequence.from_file(args.input_motion_sequence)
    if len(seq) != len(images):
        print("The number of motion estimates must match the number of frames.",
              file=sys.stderr)
        return 1

    # Grayscale fusion like the reference (BGR -> gray via luminance).
    def to_gray(img: ImageData):
        arr = img.array
        if arr.shape[0] == 3:
            b, g, r = arr[0], arr[1], arr[2]
            return 0.299 * r + 0.587 * g + 0.114 * b
        return arr[0]

    frames = torch.stack([to_gray(img) for img in images])
    fused = shift_add_fusion(frames, seq.as_array(), args.upsampling_scale, inpaint=not args.no_inpaint)
    result = ImageData(fused, normalize="never")
    if args.result_path:
        save_image(result, args.result_path)
        print(f"Saved fused image to {args.result_path}")
    if args.display or not args.result_path:
        from super_resolution_tpu_torch.utils.visualization import display_image

        display_image(result, "Shift-Add Fusion")
    return 0


if __name__ == "__main__":
    sys.exit(main())
