"""``python -m saturn_tpu_torch.service`` — tail a service's JSONL metrics stream."""

import sys

from saturn_tpu_torch.service.client import main

sys.exit(main())
