"""GenerateData CLI — LR stack synthesis (equivalent of
``src/generate_data.cpp``).

Degrades a HR image through the forward model (with noise) and writes K LR
frames, or converts/crops a file with ``--save_as`` passthrough
(``generate_data.cpp:95-126``). The JAX package's flags, plus ``--device``
(default ``cuda``) and ``--dtype``. The noise comes from ``torch`` generators
seeded with ``--noise_seed`` plus the frame index, so a noisy frame differs
from the JAX package's for the same seed.
"""

from __future__ import annotations

import argparse
import os
import sys

from super_resolution_tpu_torch.cli.super_resolve import DTYPES, torch_dtype


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="generate_data",
                                description="Generate degraded LR frames from an HR image.")
    p.add_argument("--input_image", required=True, help="HR input image path (or ENVI config).")
    p.add_argument("--output_image_dir", default="", help="Directory for the LR frames.")
    p.add_argument("--save_as", default="",
                   help="Just convert/save the input to this path (passthrough mode).")
    p.add_argument("--number_of_frames", type=int, default=4)
    p.add_argument("--upsampling_scale", type=int, default=2)
    p.add_argument("--blur_radius", type=int, default=3)
    p.add_argument("--blur_sigma", type=float, default=1.0)
    p.add_argument("--noise_sigma", type=float, default=0.0)
    p.add_argument("--motion_sequence_path", default="")
    p.add_argument("--noise_seed", type=int, default=0)
    p.add_argument("--output_extension", default="png")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    p.add_argument("--dtype", default="float32", choices=DTYPES)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from super_resolution_tpu_torch.models import ImageModel, ImageModelParameters
    from super_resolution_tpu_torch.utils.data_loader import load_image, save_image

    image = load_image(args.input_image, device=args.device, dtype=torch_dtype(args.dtype))

    if args.save_as:
        save_image(image, args.save_as)
        print(f"Saved converted image to {args.save_as}")
        return 0

    if not args.output_image_dir:
        print("--output_image_dir is required unless --save_as is given.", file=sys.stderr)
        return 1
    os.makedirs(args.output_image_dir, exist_ok=True)

    params = ImageModelParameters(
        scale=args.upsampling_scale,
        blur_radius=args.blur_radius,
        blur_sigma=args.blur_sigma,
        motion_sequence_path=args.motion_sequence_path,
        noise_sigma=args.noise_sigma,
        noise_seed=args.noise_seed,
    )
    model = ImageModel.create(params)
    for i in range(args.number_of_frames):
        frame = image._with_array(model.apply(image.array, i))
        out_path = os.path.join(args.output_image_dir, f"low_res_{i}.{args.output_extension}")
        save_image(frame, out_path)
        print(f"Wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
