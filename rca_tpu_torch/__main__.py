import sys

from rca_tpu_torch.cli import main

sys.exit(main())
