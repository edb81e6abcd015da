import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (BENCH, os.path.dirname(BENCH))
                if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skipped without one)")
