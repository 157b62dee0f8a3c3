"""CPU tests of the benchmark: pytest benchmark/tests.

Tests that need a CUDA card carry the `card` marker and decide inside the
test whether a card exists; on the CPU they skip.  Run them on the card
with: python3 -m pytest benchmark/tests -m card
"""
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
