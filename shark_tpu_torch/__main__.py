import sys

from shark_tpu_torch.cli import main

sys.exit(main())
