"""pytest settings of the benchmark's own tests (`python -m pytest portbench/tests`).

The `card` marker marks a test that needs a CUDA card; such a test asks
for the `cuda_card` fixture, which decides inside the test run (never at
import) and skips with a reason where there is none.
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda:0")


def tiny(cell_name: str, n: int = 3000, frames: int = 8, batch: int = 4):
    """(cell, config, traffic) of cell `cell_name` cut to `n` atoms in a
    6 nm box (6.5 nm dodecahedron), `frames` frames, batches of `batch`."""
    from portbench import harness

    cell, config, traffic = harness.resolve_cell(cell_name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["n_atoms"] = n
    n_prot, n_mem = n // 10, n // 3
    config["groups"] = {"Protein": [0, n_prot], "Membrane": [n_prot, n_prot + n_mem],
                        "Peptide": [0, 40], "Water": [n_prot + n_mem, n]}
    if config["box"]["form"] == "rectangular":
        config["box"]["lengths_nm"] = [6.0, 6.0, 6.0]
    else:
        config["box"]["image_distance_nm"] = 6.5
    config["frames"] = frames
    traffic.update(frames=frames, batch=batch, check_frames=frames)
    if "warm_frames" in traffic:
        traffic["warm_frames"] = min(traffic["warm_frames"], batch)
    return cell, config, traffic


@pytest.fixture
def tiny_cell():
    return tiny
