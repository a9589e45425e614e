"""One run of one cell of the port's benchmark.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the result as the last line of
standard output, and the numbers compared with their limits as the last
lines of standard error.  Exits non-zero, with no result, without a CUDA
card, without the measured package, or when a module of JAX or of the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel and compiler caches at fixed places inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
