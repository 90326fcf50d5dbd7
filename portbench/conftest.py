"""pytest settings of the benchmark's own tests (``python -m pytest portbench``)."""

import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
for _p in (_ROOT, _ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)  # tiny CPU ops, several workers: threads only contend
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; the test decides inside itself and skips without one")
