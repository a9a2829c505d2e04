"""Put the checkout's root on the path so ``portbench`` imports as a
package when the tests run from anywhere."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# the small runs are many and short: a few threads each, so that workers
# in parallel do not oversubscribe the cores
torch.set_num_threads(2)
