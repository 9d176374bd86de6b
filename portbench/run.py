"""Entry point of the port's benchmark: ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the root
of a checkout (see ``portbench/harness.py``)."""

import time

T0 = time.perf_counter()  # set-up is counted from here, imports included

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run could write (the CUDA driver's JIT cache, and Triton's and torch's extension builds should a
# later kernel use them) stays at a fixed path inside the checkout
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
os.environ["USE_FLAX"] = "0"
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], t0=T0))
