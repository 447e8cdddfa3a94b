"""Run one cell of the benchmark (``BENCHMARK.json``) on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and ``check`` last), and the numbers compared beside their limits as the
last lines on standard error. It exits with another code than 0, and
prints no result, without enough CUDA devices, without the program beside
it, or if JAX or the JAX package was loaded. Caches live at fixed paths
inside the checkout: the program builds its kernel library into its own
``s1s2_torch/_build/``, and the CUDA driver's JIT cache is
``.benchcache/cuda``.
"""

if __name__ == "__main__":
    import time

    T_START = time.perf_counter()

    import os
    import sys
    from pathlib import Path

    ROOT = Path(__file__).resolve().parents[1]
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".benchcache" / "cuda")  # the driver's JIT cache
    sys.path.insert(0, str(ROOT))

    from benchmark.harness.cell import main

    sys.exit(main(sys.argv[1:], T_START))
