import sys

from .utils.cli import main

sys.exit(main())
