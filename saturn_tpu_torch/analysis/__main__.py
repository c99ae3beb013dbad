"""Entry point: ``python -m saturn_tpu_torch.analysis``."""

import sys

from saturn_tpu_torch.analysis.cli import main

sys.exit(main())
