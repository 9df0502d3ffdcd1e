import sys
from pathlib import Path

# the repository's root, so that ``benchmark`` and the port import
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where none is present")
