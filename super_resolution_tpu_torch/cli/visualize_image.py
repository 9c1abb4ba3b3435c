"""VisualizeImage CLI (equivalent of ``src/visualize_image.cpp``): load a
regular or ENVI image, optionally print stats, and display it — headless:
written as a PNG whose path is printed (see ``utils/visualization.py``)."""

from __future__ import annotations

import argparse
import sys

from super_resolution_tpu_torch.cli.super_resolve import DTYPES, torch_dtype


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="visualize_image", description="Image/HSI viewer.")
    p.add_argument("--image_path", required=True,
                   help="Image file or ENVI config path.")
    p.add_argument("--print_report", action="store_true",
                   help="Print the image statistics report.")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'.")
    p.add_argument("--dtype", default="float32", choices=DTYPES)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from super_resolution_tpu_torch.utils.data_loader import load_image
    from super_resolution_tpu_torch.utils.visualization import display_image

    image = load_image(args.image_path, device=args.device, dtype=torch_dtype(args.dtype))
    if args.print_report:
        image.report().print()
    display_image(image, "Image Visualization")
    return 0


if __name__ == "__main__":
    sys.exit(main())
