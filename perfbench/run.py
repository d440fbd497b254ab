"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It runs the port (``src/repro_torch``) on the CUDA devices of the machine
it starts on, and prints one JSON object as the last line of its standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1`` a
``breakdown``, and last ``checks``: each number that decided ``correct``
beside its limit (also the last lines of its standard error).  Without
enough CUDA devices it exits with 2 and prints no result.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE in sys.path:  # the harness's modules are imported as the perfbench package
    sys.path.remove(HERE)
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from perfbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(t_start=T_START))
