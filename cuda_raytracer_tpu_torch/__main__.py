"""``python -m cuda_raytracer_tpu_torch <scene> [flags] [options]``: see ``cli.py``."""

import sys

from cuda_raytracer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
