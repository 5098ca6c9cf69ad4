"""``python -m tree_attention_tpu_torch`` — see :mod:`.cli`."""

import sys

from tree_attention_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
