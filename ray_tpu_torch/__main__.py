from ray_tpu_torch.scripts.cli import main

import sys

sys.exit(main())
