"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of a checkout. Tests marked ``cuda`` need a card and skip elsewhere."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")
