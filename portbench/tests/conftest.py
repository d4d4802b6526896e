"""The benchmark's tests: on the CPU, `python -m pytest portbench/tests`
from the root of the checkout; on a card, `-m gpu` as well."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
