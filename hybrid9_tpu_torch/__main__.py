"""``python -m hybrid9_tpu_torch`` entry point."""

import sys

from .cli import main

sys.exit(main())
