"""The PyTorch port's benchmarks: the paper's figures and Table I on the
port's engine (``python -m benchmarks_torch.run``, see ``run.py``) and the
kernel and profiling scripts.  Importing the package puts the checkout's
``src`` on ``sys.path``, so that ``repro_torch`` is found without
``PYTHONPATH``."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
